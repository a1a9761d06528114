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
//   tile. Here one thread owns one (program, element) and loops over the
//   reps, so the per-rep Kahan accumulation stays in registers (13 sums and
//   13 compensations). A block holds 256 consecutive elements of one
//   program and reduces them in a fixed warp-shuffle tree; no atomics, so
//   one seed gives bitwise-identical stats on every run.
// * A second, tiny pass (combine_rows_kernel, csrc/reduce.cuh) Kahan-sums
//   the block rows of each program in block order and, for the terminal
//   kernel, the program rows in program order, like ops/stats.combine_scan.
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

#include <cuda_runtime.h>

#include <cstdint>

#include "fastmath.cuh"
#include "reduce.cuh"
#include "threefry.cuh"

namespace optpricer {

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

__device__ __forceinline__ Obs observe(float z, const Params &p) {
  Obs o;
  const float ST = p.S0 * exp32(p.mu + p.sig * z);
  const float d = p.sign * (ST - p.K);
  o.X = p.df * fmaxf(d, 0.0f);
  o.Y1 = p.df * ST;
  o.Y2 = p.df * (d > 0.0f ? 1.0f : 0.0f);
  o.Xz = o.X * z;
  o.Xz2 = o.Xz * z;
  o.Y2z = o.Y2 * z;
  return o;
}

__device__ __forceinline__ void add_moments(const Obs &o, float w, float *s) {
  const float WX = o.X * w, WY1 = o.Y1 * w, WY2 = o.Y2 * w;
  s[0] += w;
  s[1] += WX;
  s[2] += WX * o.X;
  s[3] += WY1;
  s[4] += WY1 * o.Y1;
  s[5] += WX * o.Y1;
  s[6] += WY2;
  s[7] += WY2 * o.Y2;
  s[8] += WX * o.Y2;
  s[9] += WY1 * o.Y2;
  s[10] += o.Xz * w;
  s[11] += o.Xz2 * w;
  s[12] += o.Y2z * w;
}

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

__global__ void __launch_bounds__(THREADS)
terminal_qmc_kernel(const int *seed, const float *par, int reps,
                    int progs_per_rep, float *block_rows) {
  const int local_pid = blockIdx.x / BLOCKS_PER_PROGRAM;
  const int elem = (blockIdx.x % BLOCKS_PER_PROGRAM) * THREADS + threadIdx.x;
  const int pid = local_pid + seed[1];
  const int rep_id = pid / progs_per_rep;
  const int tile_idx = pid % progs_per_rep;

  // murmur3 finalizer of (seed, replicate) -> digital-shift word
  uint32_t h = static_cast<uint32_t>(seed[0]) ^
               (static_cast<uint32_t>(rep_id) * 0x9E3779B9u);
  h ^= h >> 16;
  h *= 0x85EBCA6Bu;
  h ^= h >> 13;
  h *= 0xC2B2AE35u;
  h ^= h >> 16;

  const Params p = load_params(par);
  float acc[NSTAT], comp[NSTAT];
#pragma unroll
  for (int k = 0; k < NSTAT; ++k) acc[k] = comp[k] = 0.0f;

  for (int j = 0; j < reps; ++j) {
    const long long local = static_cast<long long>(tile_idx * reps + j) * TILE
                            + elem;
    // van der Corput point of the within-replicate index, digitally shifted
    const uint32_t u_bits = bitrev32(static_cast<uint32_t>(local)) ^ h;
    const float u = (static_cast<float>(u_bits >> 8) + 0.5f) * TINY;
    const float z = norminv32(u);
    const float w = local < p.n ? 1.0f : 0.0f;

    const Obs o = observe(z, p);
    float s[NSTAT];
#pragma unroll
    for (int k = 0; k < NSTAT; ++k) s[k] = 0.0f;
    add_moments(o, w, s);
    kahan_step<NSTAT>(acc, comp, s);
  }
  block_row<NSTAT, THREADS>(
      acc, block_rows + static_cast<size_t>(blockIdx.x) * ROW);
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

// Randomised-QMC sums per program. out: f32[n_programs, 16].
extern "C" int optpricer_terminal_qmc(const void *seed, const void *par,
                                      void *block_rows, void *out,
                                      int n_programs, int reps,
                                      int progs_per_rep, void *stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int blocks = n_programs * BLOCKS_PER_PROGRAM;
  float *br = static_cast<float *>(block_rows);
  terminal_qmc_kernel<<<blocks, THREADS, 0, s>>>(
      static_cast<const int *>(seed), static_cast<const float *>(par), reps,
      progs_per_rep, br);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(combine<NSTAT, ROW>(
      br, BLOCKS_PER_PROGRAM, n_programs, static_cast<float *>(out), s));
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
