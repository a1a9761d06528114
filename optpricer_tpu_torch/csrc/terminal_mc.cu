// Terminal-GBM European Monte Carlo on Hopper: the two kernels of the
// pricer's main path, with a plain C interface (bound with ctypes by
// optpricer_tpu_torch/ops/terminal_mc.py, built by optpricer_tpu_torch/_build.py).
//
// terminal_mc_kernel replaces optpricer_tpu/ops/pallas_mc.py:_mc_kernel
// (its sw_prng stream), terminal_qmc_kernel replaces
// optpricer_tpu/ops/pallas_mc.py:_mc_qmc_kernel. Both compute what the TPU
// kernels compute — the same draws, the same payoff and the same 13 sums —
// but not in the same shape:
//
// * On the TPU one grid program walks its reps in order over a 256x128
//   tile. In terminal_mc_kernel one thread owns one (program, element) and
//   loops over the reps, so the per-rep Kahan accumulation stays in
//   registers (13 sums and 13 compensations). A block holds 256
//   consecutive elements of one program and reduces them in a fixed
//   warp-shuffle tree; no atomics, so one seed gives bitwise-identical
//   stats on every run.
// * A second, tiny pass (combine_rows_kernel, csrc/reduce.cuh) Kahan-sums
//   the block rows of each program in block order and the program rows in
//   program order, like ops/stats.combine_scan.
// * terminal_qmc_kernel forms the same block rows, summed the same way, in
//   one launch of a cluster a program (see its section below).
//
// What bounds them: the issue of their loops' integer, FP32 and SFU
// instructions. Each base draw costs one Threefry-2x32-20 block (~80
// integer ops), a log/sqrt/sincospi (or two inverse CDFs) and two or four
// exp32 polynomials; device memory sees only the 13 floats (padded to 16)
// each block writes. The design keeps every draw in registers, has no
// shared-memory traffic inside the loop, and sizes the grid (from
// _plan_grid) at up to 8192 blocks of 256 threads so the SMs stay full at
// the large path counts. terminal_mc_kernel's rep loop is cut to the
// instructions a rep needs:
// * a block-uniform split of the programs: a full program (every draw
//   below n_paths: all but the last of a ragged count, below 2^24 tiles;
//   ops/terminal_mc._full_programs) forms no draw index, compare or
//   weighted product, and sets its count after the loop;
// * a rep's first branch writes its moments and the second adds to them,
//   with no adds to zero;
// * under antithetic sampling the loop sums f(z) + f(-z), and the last
//   combine pass scales each stat by its power of two (ANTI_HALF,
//   ANTI_QUARTER), which gives the halves' sums exactly;
// * Y2 = df 1{ITM} and Y2 z are selects; the loop is unrolled by two.
// The file is built with FMA contraction (_build.py), so ptxas may fuse a
// multiply and an add differently from the plain version
// (ops/terminal_mc.py:_mc_sumstats_plain), which the sums are held to
// within a tolerance, not bit for bit.
//
// The tail mask is an integer compare of the global draw index against
// n_paths (read from the f32 params, so it is the same count the TPU kernel
// masks to); inside the range the wrapper asserts, it equals the TPU
// kernel's f32 remainder compare.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <cstring>

#include "fastmath.cuh"
#include "reduce.cuh"
#include "threefry.cuh"

namespace optpricer {

namespace cg = cooperative_groups;

constexpr int TILE = 256 * 128;     // draws per bit tile (pallas_mc.TILE)
constexpr int NSTAT = 13;           // stats.STATSG_DIM
constexpr int ROW = 16;             // stats row padded to 64 bytes
constexpr int THREADS = 256;
constexpr int BLOCKS_PER_PROGRAM = TILE / THREADS;
constexpr float TINY = 5.9604645e-8f;  // 2^-24

struct Params {
  float S0, K, mu, sig, df, sign;
  long long n;  // n_paths (terminal) or points per replicate (QMC)
};

__device__ __forceinline__ Params load_params(const float *par) {
  Params p;
  p.S0 = par[0];
  p.K = par[1];
  p.mu = par[2];    // (r - q - sigma^2/2) T
  p.sig = par[3];   // sigma sqrt(T)
  p.df = par[4];    // exp(-rT)
  p.n = static_cast<long long>(par[5]);
  p.sign = par[6];  // +1 call, -1 put
  return p;
}

// Per-draw observables: payoff X, control variates Y1 = df*S_T and
// Y2 = df*1{ITM}, and the z-weighted Greek moments X*z, X*z^2, Y2*z.
struct Obs {
  float X, Y1, Y2, Xz, Xz2, Y2z;
};

// Antithetic sampling averages f(z) and f(-z) into ONE observation, the
// z-moments averaging the products X(z)*z and X(-z)*(-z). The rep loop of
// terminal_mc_kernel keeps the sums f(z) + f(-z) instead, and the last
// combine pass scales each stat by (1/2)^degree: 1/2 for the sums of X,
// Y1, Y2 and the z-moments, 1/4 for the products of two of them, 1 for the
// count (ANTI_HALF, ANTI_QUARTER). Scaling by a power of two commutes with
// every rounding here, FMA included, away from under- and overflow, which
// these moments are far from.
constexpr unsigned ANTI_HALF = (1u << 1) | (1u << 3) | (1u << 6) |
                               (1u << 10) | (1u << 11) | (1u << 12);
constexpr unsigned ANTI_QUARTER = (1u << 2) | (1u << 4) | (1u << 5) |
                                  (1u << 7) | (1u << 8) | (1u << 9);

// One branch's observables X, Y1, Y2, X*z, X*z^2, Y2*z; under ANTI the
// sums over z and -z. Y2 = df * 1{ITM} and Y2*z are selects.
template <bool ANTI>
__device__ __forceinline__ Obs observe_pair(float z, const Params &p) {
  Obs o;
  const float ST = p.S0 * exp32(p.mu + p.sig * z);
  const float d = p.sign * (ST - p.K);
  o.X = p.df * fmaxf(d, 0.0f);
  o.Y1 = p.df * ST;
  o.Y2 = d > 0.0f ? p.df : 0.0f;
  o.Xz = o.X * z;
  o.Xz2 = o.Xz * z;
  o.Y2z = d > 0.0f ? p.df * z : 0.0f;
  if (ANTI) {
    const float mz = -z;
    const float STm = p.S0 * exp32(p.mu + p.sig * mz);
    const float dm = p.sign * (STm - p.K);
    const float Xm = p.df * fmaxf(dm, 0.0f);
    const float Xmz = Xm * mz;
    o.X = o.X + Xm;
    o.Y1 = o.Y1 + p.df * STm;
    o.Y2 = o.Y2 + (dm > 0.0f ? p.df : 0.0f);
    o.Xz = o.Xz + Xmz;
    o.Xz2 = o.Xz2 + Xmz * mz;
    o.Y2z = o.Y2z + (dm > 0.0f ? p.df * mz : 0.0f);
  }
  return o;
}

// The 12 moments past the count of one observation with weight w (FULL:
// w = 1, so no weighted products), written into s[1..12] (FIRST) or added
// to it, in the stat order of add_moments.
template <bool FULL, bool FIRST>
__device__ __forceinline__ void moments(const Obs &o, float w, float *s) {
  const float WX = FULL ? o.X : o.X * w;
  const float WY1 = FULL ? o.Y1 : o.Y1 * w;
  const float WY2 = FULL ? o.Y2 : o.Y2 * w;
  const float v[NSTAT] = {w,
                          WX,
                          WX * o.X,
                          WY1,
                          WY1 * o.Y1,
                          WX * o.Y1,
                          WY2,
                          WY2 * o.Y2,
                          WX * o.Y2,
                          WY1 * o.Y2,
                          FULL ? o.Xz : o.Xz * w,
                          FULL ? o.Xz2 : o.Xz2 * w,
                          FULL ? o.Y2z : o.Y2z * w};
#pragma unroll
  for (int k = 1; k < NSTAT; ++k) s[k] = FIRST ? v[k] : s[k] + v[k];
}

// One thread's rep loop: Kahan-sums its element's 13 sums over the reps.
// FULL: every draw of the program lies below n_paths (all programs but the
// last of a ragged count), so no draw needs its index or weight, and the
// count, 2 a rep, is set after the loop: 2 * reps, the Kahan sum of the
// 2s exactly (integers below 2^25). A rep's sums are its first branch's
// moments plus its second's, with no adds to zero: (0 + m1) + m2 differs
// from m1 + m2 at most in the sign of a zero, and a Kahan step from
// acc = +0 takes +0 and -0 to the same acc and comp. Unrolled by two.
template <bool ANTI, bool INVCDF, bool FULL>
__device__ __forceinline__ void rep_loop(uint32_t key0, uint32_t key1,
                                         uint32_t elem, const Params &p,
                                         long long first, int reps,
                                         float *acc, float *comp) {
#pragma unroll 2
  for (int j = 0; j < reps; ++j) {
    uint32_t bits_a, bits_b;
    threefry2x32(key0, key1, elem, static_cast<uint32_t>(j), bits_a, bits_b);
    const float u1 = (static_cast<float>(bits_a >> 8) + 0.5f) * TINY;
    float z1, z2;
    if (INVCDF) {
      const float u2 = (static_cast<float>(bits_b >> 8) + 0.5f) * TINY;
      z1 = norminv32(u1);
      z2 = norminv32(u2);
    } else {
      // Box-Muller; u2 without the +0.5, as in the TPU kernel. sincospif
      // takes 2*u2 exactly, so the angle is 2*pi*u2 with no rounding of
      // the product and no large-argument reduction.
      const float u2 = static_cast<float>(bits_b >> 8) * TINY;
      const float rad = sqrtf(-2.0f * log32(u1));
      float sn, cs;
      sincospif(2.0f * u2, &sn, &cs);
      z1 = rad * cs;
      z2 = rad * sn;
    }
    // z1 feeds the first tile of this rep, z2 the second
    float w1 = 1.0f, w2 = 1.0f;
    if (!FULL) {
      const long long g1 = first + static_cast<long long>(j) * (2LL * TILE);
      w1 = g1 < p.n ? 1.0f : 0.0f;
      w2 = g1 + TILE < p.n ? 1.0f : 0.0f;
    }
    float s[NSTAT];
    s[0] = FULL ? 0.0f : w1 + w2;
    moments<FULL, true>(observe_pair<ANTI>(z1, p), w1, s);
    moments<FULL, false>(observe_pair<ANTI>(z2, p), w2, s);
    if (FULL)
      kahan_step<NSTAT - 1>(acc + 1, comp + 1, s + 1);
    else
      kahan_step<NSTAT>(acc, comp, s);
  }
  if (FULL) acc[0] = 2.0f * static_cast<float>(reps);
}

template <bool ANTI, bool INVCDF>
__global__ void __launch_bounds__(THREADS)
terminal_mc_kernel(const int *seed, const float *par, int reps,
                   float *block_rows) {
  const int local_pid = blockIdx.x / BLOCKS_PER_PROGRAM;
  const int elem = (blockIdx.x % BLOCKS_PER_PROGRAM) * THREADS + threadIdx.x;
  // global program id: the stream key, whatever slice of the grid runs here
  const int pid = local_pid + seed[1];
  const uint32_t key0 = static_cast<uint32_t>(seed[0]);
  const uint32_t key1 = static_cast<uint32_t>(pid);
  const Params p = load_params(par);
  // the program's draws: (pid * reps + j) * 2 * TILE + elem (+ TILE)
  const long long first = static_cast<long long>(pid) * reps * (2LL * TILE);

  float acc[NSTAT], comp[NSTAT];
#pragma unroll
  for (int k = 0; k < NSTAT; ++k) acc[k] = comp[k] = 0.0f;
  // block-uniform: every program but the last is full below 2^24 tiles
  if (first + static_cast<long long>(reps) * (2LL * TILE) <= p.n)
    rep_loop<ANTI, INVCDF, true>(key0, key1, static_cast<uint32_t>(elem), p,
                                 first + elem, reps, acc, comp);
  else
    rep_loop<ANTI, INVCDF, false>(key0, key1, static_cast<uint32_t>(elem), p,
                                  first + elem, reps, acc, comp);
  block_row<NSTAT, THREADS>(
      acc, block_rows + static_cast<size_t>(blockIdx.x) * ROW);
}

// ---------------------------------------------------------------------------
// K2: randomised QMC. A program's 128 block rows (its 32 768 elements, 256 a
// row, each Kahan-summed over its reps) are summed in the order of
// block_row and combine_rows_kernel (csrc/reduce.cuh, K1's reduction), so
// the rows keep those sums' bits, in another launch shape:
// * a program is one cluster of QMC_CLUSTER blocks, each block QMC_ROWS of
//   its block rows, a group of QMC_GROUP threads a row at a time;
// * a thread owns QMC_ELEMS elements of a row's 32-element warp row,
//   l + QMC_SEG * i, and folds them in registers as the block tree's
//   levels 16 and 8 pair them (lane l with l + 16, then l + 8), so the
//   shuffle tree keeps only its levels below QMC_SEG;
// * the row is then 0 + warp row 0 + ... + warp row 7, as block_row sums
//   its warps, written into the leader block's shared memory (distributed
//   shared memory), and after one cluster barrier the leader Kahan-sums
//   the program's 128 rows in row order, as combine_rows_kernel does: one
//   launch, no scratch buffer.
// The per-point body takes K1's cuts: a block-uniform full/tail split (a
// full program forms no weight; its count is the rep count), no adds to
// zero (a rep's moments are written at the first rep and added after),
// Y2 and Y2*z as selects, a 32-bit in-replicate index. This file keeps
// FMA contraction (K1's sums carry it), so the moments are __fmul_rn
// products: no multiply is contracted into the sum it feeds, and each is
// the rounded product, as a weighted moment 0 + x*w with w = 1 rounds.
constexpr int QMC_CLUSTER = 8;                                // blocks a program
constexpr int QMC_ROWS = BLOCKS_PER_PROGRAM / QMC_CLUSTER;    // rows a block
constexpr int QMC_ELEMS = 4;                 // elements of a row a thread owns
constexpr int QMC_SEG = 32 / QMC_ELEMS;      // lanes a warp row takes
constexpr int QMC_GROUP = THREADS / QMC_ELEMS;                // threads a row
constexpr int QMC_WARP_ROWS = THREADS / 32;                   // warp rows a row
constexpr int QMC_MAX_THREADS = QMC_ROWS * QMC_GROUP;         // a row a group

// The kernel's arguments by value (__grid_constant__), packed on the host
// by ops/terminal_mc._qmc_args: the seed pair (key, first program's global
// id) and the f32 params of _terminal_params.
struct QmcArgs {
  int key, pid0;
  float par[7];
};

// One point's 13 moments: the van der Corput point of the in-replicate
// index, XOR-shifted by h, through norminv32 and the terminal GBM map.
// FULL: weight 1, the count left to the caller; else zero past n.
template <bool FULL>
__device__ __forceinline__ void qmc_point(uint32_t local, uint32_t h,
                                          const Params &p, float *m) {
  const uint32_t u_bits = bitrev32(local) ^ h;
  const float u = (static_cast<float>(u_bits >> 8) + 0.5f) * TINY;
  const float z = norminv32(u);
  const float ST = p.S0 * exp32(p.mu + p.sig * z);
  const float d = p.sign * (ST - p.K);
  const float X = __fmul_rn(p.df, fmaxf(d, 0.0f));
  const float Y1 = __fmul_rn(p.df, ST);
  const float Y2 = d > 0.0f ? p.df : 0.0f;
  const float Xz = __fmul_rn(X, z);
  m[0] = 1.0f;
  m[1] = X;
  m[2] = __fmul_rn(X, X);
  m[3] = Y1;
  m[4] = __fmul_rn(Y1, Y1);
  m[5] = __fmul_rn(X, Y1);
  m[6] = Y2;
  m[7] = __fmul_rn(Y2, Y2);
  m[8] = __fmul_rn(X, Y2);
  m[9] = __fmul_rn(Y1, Y2);
  m[10] = Xz;
  m[11] = __fmul_rn(Xz, z);
  m[12] = d > 0.0f ? __fmul_rn(p.df, z) : 0.0f;
  if (!FULL && static_cast<long long>(local) >= p.n) {
#pragma unroll
    for (int k = 0; k < NSTAT; ++k) m[k] = 0.0f;
  }
}

// One element's 13 sums over its reps (points local + j * TILE): the
// first rep's moments, then a Kahan step a rep (KAHAN: more than two reps;
// at two, the step from a zero compensation is one add).
template <bool FULL, bool KAHAN>
__device__ __forceinline__ void qmc_element(uint32_t local, uint32_t h,
                                            const Params &p, int reps,
                                            float *acc) {
  qmc_point<FULL>(local, h, p, acc);
  if (KAHAN) {
    float comp[NSTAT];
#pragma unroll
    for (int k = 0; k < NSTAT; ++k) comp[k] = 0.0f;
    for (int j = 1; j < reps; ++j) {
      float m[NSTAT];
      qmc_point<FULL>(local + static_cast<uint32_t>(j) * TILE, h, p, m);
      kahan_step<NSTAT>(acc, comp, m);
    }
  } else if (reps > 1) {
    float m[NSTAT];
    qmc_point<FULL>(local + TILE, h, p, m);
#pragma unroll
    for (int k = 0; k < NSTAT; ++k) acc[k] = acc[k] + m[k];
  }
  if (FULL) acc[0] = static_cast<float>(reps);
}

// The sum of the N elements local + step * i, i < N, in the block tree's
// pairing: the first half's sum (every other element) plus the second's.
template <int N, bool FULL, bool KAHAN>
__device__ __forceinline__ void qmc_fold(uint32_t local, uint32_t step,
                                         uint32_t h, const Params &p,
                                         int reps, float *sum) {
  if constexpr (N == 1) {
    qmc_element<FULL, KAHAN>(local, h, p, reps, sum);
  } else {
    float other[NSTAT];
    qmc_fold<N / 2, FULL, KAHAN>(local, 2 * step, h, p, reps, sum);
    qmc_fold<N / 2, FULL, KAHAN>(local + step, 2 * step, h, p, reps, other);
#pragma unroll
    for (int k = 0; k < NSTAT; ++k) sum[k] = sum[k] + other[k];
  }
}

// This thread's rows of the block (a group's rows: its index, then every
// `groups`-th): each row's warp-row sums, after the shuffle levels below
// QMC_SEG, into warp_sums. The 32-bit index of a row's first point: base.
template <bool FULL, bool KAHAN>
__device__ __forceinline__ void qmc_rows(
    uint32_t base, int rank, uint32_t h, const Params &p, int reps,
    float (*warp_sums)[QMC_WARP_ROWS][NSTAT]) {
  const int groups = blockDim.x / QMC_GROUP;
  const int q = threadIdx.x % QMC_GROUP;
  const int wrow = q / QMC_SEG, lane = q % QMC_SEG;
  for (int r = threadIdx.x / QMC_GROUP; r < QMC_ROWS; r += groups) {
    const int row = rank * QMC_ROWS + r;
    const uint32_t local = base + row * THREADS + wrow * 32 + lane;
    float sum[NSTAT];
    qmc_fold<QMC_ELEMS, FULL, KAHAN>(local, QMC_SEG, h, p, reps, sum);
#pragma unroll
    for (int k = 0; k < NSTAT; ++k) {
#pragma unroll
      for (int off = QMC_SEG / 2; off > 0; off >>= 1)
        sum[k] += __shfl_down_sync(0xffffffffu, sum[k], off, QMC_SEG);
    }
    if (lane == 0) {
#pragma unroll
      for (int k = 0; k < NSTAT; ++k) warp_sums[r][wrow][k] = sum[k];
    }
  }
}

template <bool KAHAN>
__global__ void __launch_bounds__(QMC_MAX_THREADS)
terminal_qmc_kernel(const __grid_constant__ QmcArgs a, int reps,
                    int progs_per_rep, float *out) {
  // the warp rows' sums of this block's rows; the program's rows (the
  // leader block's copy is the one written)
  __shared__ float warp_sums[QMC_ROWS][QMC_WARP_ROWS][NSTAT];
  __shared__ float rows[BLOCKS_PER_PROGRAM][NSTAT];
  cg::cluster_group cluster = cg::this_cluster();
  // every block of the cluster must have started before another writes
  // into its shared memory: arrive now, wait before those writes
  asm volatile("barrier.cluster.arrive.relaxed.aligned;" ::: "memory");
  const int rank = static_cast<int>(cluster.block_rank());
  const int local_pid = blockIdx.x / QMC_CLUSTER;
  const int pid = local_pid + a.pid0;
  const int rep_id = pid / progs_per_rep;
  const int tile_idx = pid % progs_per_rep;

  // murmur3 finalizer of (seed, replicate) -> digital-shift word
  uint32_t h = static_cast<uint32_t>(a.key) ^
               (static_cast<uint32_t>(rep_id) * 0x9E3779B9u);
  h ^= h >> 16;
  h *= 0x85EBCA6Bu;
  h ^= h >> 13;
  h *= 0xC2B2AE35u;
  h ^= h >> 16;

  const Params p = load_params(a.par);
  const uint32_t base = static_cast<uint32_t>(tile_idx) *
                        static_cast<uint32_t>(reps) * TILE;
  // block-uniform: every point of a full program lies below n
  if (static_cast<long long>(tile_idx + 1) * reps * TILE <= p.n)
    qmc_rows<true, KAHAN>(base, rank, h, p, reps, warp_sums);
  else
    qmc_rows<false, KAHAN>(base, rank, h, p, reps, warp_sums);
  __syncthreads();
  asm volatile("barrier.cluster.wait.aligned;" ::: "memory");
  float *lead = cluster.map_shared_rank(&rows[0][0], 0);
  for (int i = threadIdx.x; i < QMC_ROWS * NSTAT; i += blockDim.x) {
    const int r = i / NSTAT, k = i % NSTAT;
    float t = 0.0f;
#pragma unroll
    for (int w = 0; w < QMC_WARP_ROWS; ++w) t += warp_sums[r][w][k];
    lead[(rank * QMC_ROWS + r) * NSTAT + k] = t;
  }
  cluster.sync();
  if (rank == 0 && threadIdx.x < NSTAT) {
    const int k = threadIdx.x;
    float acc = 0.0f, comp = 0.0f;
    for (int r = 0; r < BLOCKS_PER_PROGRAM; ++r) {
      const float y = rows[r][k] - comp;
      const float t = acc + y;
      comp = (t - acc) - y;
      acc = t;
    }
    out[static_cast<size_t>(local_pid) * NSTAT + k] = acc;
  }
}

cudaLaunchConfig_t qmc_config(int n_programs, int threads, cudaStream_t s,
                              cudaLaunchAttribute *cluster) {
  cluster->id = cudaLaunchAttributeClusterDimension;
  cluster->val.clusterDim.x = QMC_CLUSTER;
  cluster->val.clusterDim.y = 1;
  cluster->val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(n_programs * QMC_CLUSTER);
  cfg.blockDim = dim3(threads);
  cfg.stream = s;
  cfg.attrs = cluster;
  cfg.numAttrs = 1;
  return cfg;
}

}  // namespace optpricer

using namespace optpricer;

// Terminal-GBM sums. block_rows: f32[n_programs * 128, 16] scratch;
// prog_rows: f32[n_programs, 16] scratch; out: f32[16], stats in [0, 13).
extern "C" int optpricer_terminal_mc(const void *seed, const void *par,
                                     void *block_rows, void *prog_rows,
                                     void *out, int n_programs, int reps,
                                     int antithetic, int invcdf,
                                     void *stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int blocks = n_programs * BLOCKS_PER_PROGRAM;
  const int *sd = static_cast<const int *>(seed);
  const float *pr = static_cast<const float *>(par);
  float *br = static_cast<float *>(block_rows);
  if (antithetic && invcdf)
    terminal_mc_kernel<true, true><<<blocks, THREADS, 0, s>>>(sd, pr, reps, br);
  else if (antithetic)
    terminal_mc_kernel<true, false><<<blocks, THREADS, 0, s>>>(sd, pr, reps, br);
  else if (invcdf)
    terminal_mc_kernel<false, true><<<blocks, THREADS, 0, s>>>(sd, pr, reps, br);
  else
    terminal_mc_kernel<false, false><<<blocks, THREADS, 0, s>>>(sd, pr, reps, br);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  err = combine<NSTAT, ROW>(br, BLOCKS_PER_PROGRAM, n_programs,
                            static_cast<float *>(prog_rows), s);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(combine<NSTAT, ROW>(
      static_cast<const float *>(prog_rows), n_programs, 1,
      static_cast<float *>(out), s, antithetic ? ANTI_HALF : 0u,
      antithetic ? ANTI_QUARTER : 0u));
}

// Randomised-QMC sums per program. args: the QmcArgs words in host memory
// (ops/terminal_mc._qmc_args); out: f32[n_programs, 13]; threads: a block's,
// a multiple of QMC_GROUP dividing QMC_MAX_THREADS.
extern "C" int optpricer_terminal_qmc(const void *args, void *out,
                                      int n_programs, int reps,
                                      int progs_per_rep, int threads,
                                      void *stream) {
  if (n_programs < 1 || reps < 1 || progs_per_rep < 1 ||
      threads % QMC_GROUP || QMC_MAX_THREADS % threads)
    return static_cast<int>(cudaErrorInvalidValue);
  QmcArgs a;
  std::memcpy(&a, args, sizeof(a));
  cudaLaunchAttribute cluster;
  const cudaLaunchConfig_t cfg = qmc_config(
      n_programs, threads, static_cast<cudaStream_t>(stream), &cluster);
  float *o = static_cast<float *>(out);
  cudaError_t err =
      reps > 2 ? cudaLaunchKernelEx(&cfg, terminal_qmc_kernel<true>, a, reps,
                                    progs_per_rep, o)
               : cudaLaunchKernelEx(&cfg, terminal_qmc_kernel<false>, a,
                                    reps, progs_per_rep, o);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

// Clusters of terminal_qmc_kernel (its instantiation for reps) that the
// card holds at once with blocks of `threads` (cudaOccupancyMaxActiveClusters),
// written to *clusters (an int).
extern "C" int optpricer_terminal_qmc_clusters(int threads, int reps,
                                               void *clusters) {
  if (threads % QMC_GROUP || QMC_MAX_THREADS % threads)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaLaunchAttribute cluster;
  const cudaLaunchConfig_t cfg = qmc_config(1, threads, nullptr,
                                                  &cluster);
  int *n = static_cast<int *>(clusters);
  return static_cast<int>(
      reps > 2 ? cudaOccupancyMaxActiveClusters(n, terminal_qmc_kernel<true>,
                                                &cfg)
               : cudaOccupancyMaxActiveClusters(n, terminal_qmc_kernel<false>,
                                                &cfg));
}

// Resident blocks per SM of terminal_mc_kernel<antithetic, invcdf> (the CUDA
// runtime's occupancy), or -1.
extern "C" int optpricer_terminal_mc_occupancy(int antithetic, int invcdf) {
  int blocks = 0;
  cudaError_t err;
  if (antithetic && invcdf)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &blocks, terminal_mc_kernel<true, true>, THREADS, 0);
  else if (antithetic)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &blocks, terminal_mc_kernel<true, false>, THREADS, 0);
  else if (invcdf)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &blocks, terminal_mc_kernel<false, true>, THREADS, 0);
  else
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &blocks, terminal_mc_kernel<false, false>, THREADS, 0);
  return err == cudaSuccess ? blocks : -1;
}
