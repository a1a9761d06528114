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
// * A second, tiny pass (combine_rows_kernel) Kahan-sums the block rows of
//   each program in block order and, for the terminal kernel, the program
//   rows in program order, like ops/stats.combine_scan.
//
// What bounds them: integer and SFU throughput. Each base draw costs one
// Threefry-2x32-20 block (~80 integer ops), a log/sqrt/sincospi (or two
// inverse CDFs) and two or four exp32 polynomials; device memory sees only
// the 13 floats (padded to 16) each block writes. The design keeps every
// draw in registers, has no shared-memory traffic inside the loop, and
// sizes the grid (from _plan_grid) at up to 8192 blocks of 256 threads so
// the SMs stay full at the large path counts.
//
// The tail mask is an integer compare of the global draw index against
// n_paths (read from the f32 params, so it is the same count the TPU kernel
// masks to); inside the range the wrapper asserts, it equals the TPU
// kernel's f32 remainder compare.

#include <cuda_runtime.h>

#include <cstdint>

#include "fastmath.cuh"
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

// One sample of a branch. Under antithetic sampling (f(z) + f(-z))/2 is ONE
// observation, the z-moments averaging the products X(z)*z and X(-z)*(-z).
template <bool ANTI>
__device__ __forceinline__ void add_branch(float z, float w, const Params &p,
                                           float *s) {
  Obs o = observe(z, p);
  if (ANTI) {
    const Obs m = observe(-z, p);
    o.X = 0.5f * (o.X + m.X);
    o.Y1 = 0.5f * (o.Y1 + m.Y1);
    o.Y2 = 0.5f * (o.Y2 + m.Y2);
    o.Xz = 0.5f * (o.Xz + m.Xz);
    o.Xz2 = 0.5f * (o.Xz2 + m.Xz2);
    o.Y2z = 0.5f * (o.Y2z + m.Y2z);
  }
  add_moments(o, w, s);
}

__device__ __forceinline__ void kahan_step(float *acc, float *comp,
                                           const float *s) {
#pragma unroll
  for (int k = 0; k < NSTAT; ++k) {
    const float y = s[k] - comp[k];
    const float t = acc[k] + y;
    comp[k] = (t - acc[k]) - y;
    acc[k] = t;
  }
}

// Fixed-order block sum of the 13 per-thread accumulators into one row.
__device__ __forceinline__ void block_row(const float *acc, float *row) {
  __shared__ float warp_sums[NSTAT][THREADS / 32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int k = 0; k < NSTAT; ++k) {
    float v = acc[k];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      v += __shfl_down_sync(0xffffffffu, v, off);
    if (lane == 0) warp_sums[k][warp] = v;
  }
  __syncthreads();
  if (threadIdx.x < NSTAT) {
    float t = 0.0f;
#pragma unroll
    for (int w = 0; w < THREADS / 32; ++w) t += warp_sums[threadIdx.x][w];
    row[threadIdx.x] = t;
  }
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

  float acc[NSTAT], comp[NSTAT];
#pragma unroll
  for (int k = 0; k < NSTAT; ++k) acc[k] = comp[k] = 0.0f;

  for (int j = 0; j < reps; ++j) {
    uint32_t bits_a, bits_b;
    threefry2x32(key0, key1, static_cast<uint32_t>(elem),
                 static_cast<uint32_t>(j), bits_a, bits_b);
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
    const long long g1 =
        (static_cast<long long>(pid) * reps + j) * (2LL * TILE) + elem;
    const float w1 = g1 < p.n ? 1.0f : 0.0f;
    const float w2 = g1 + TILE < p.n ? 1.0f : 0.0f;

    float s[NSTAT];
#pragma unroll
    for (int k = 0; k < NSTAT; ++k) s[k] = 0.0f;
    add_branch<ANTI>(z1, w1, p, s);
    add_branch<ANTI>(z2, w2, p, s);
    kahan_step(acc, comp, s);
  }
  block_row(acc, block_rows + static_cast<size_t>(blockIdx.x) * ROW);
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
    kahan_step(acc, comp, s);
  }
  block_row(acc, block_rows + static_cast<size_t>(blockIdx.x) * ROW);
}

// out[seg] = Kahan sum of rows[seg * rows_per_seg : (seg + 1) * rows_per_seg]
// in row order; one thread per (segment, stat).
__global__ void combine_rows_kernel(const float *rows, int rows_per_seg,
                                    int n_seg, float *out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n_seg * NSTAT) return;
  const int seg = i / NSTAT, k = i % NSTAT;
  const float *src = rows + static_cast<size_t>(seg) * rows_per_seg * ROW + k;
  float acc = 0.0f, comp = 0.0f;
  for (int r = 0; r < rows_per_seg; ++r) {
    const float y = src[static_cast<size_t>(r) * ROW] - comp;
    const float t = acc + y;
    comp = (t - acc) - y;
    acc = t;
  }
  out[static_cast<size_t>(seg) * ROW + k] = acc;
}

inline cudaError_t combine(const float *rows, int rows_per_seg, int n_seg,
                           float *out, cudaStream_t stream) {
  const int threads = 128;
  const int blocks = (n_seg * NSTAT + threads - 1) / threads;
  combine_rows_kernel<<<blocks, threads, 0, stream>>>(rows, rows_per_seg,
                                                       n_seg, out);
  return cudaGetLastError();
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
  err = combine(br, BLOCKS_PER_PROGRAM, n_programs,
                static_cast<float *>(prog_rows), s);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(combine(static_cast<const float *>(prog_rows),
                                  n_programs, 1, static_cast<float *>(out), s));
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
  return static_cast<int>(combine(br, BLOCKS_PER_PROGRAM, n_programs,
                                  static_cast<float *>(out), s));
}
