// Terminal-GBM Monte Carlo for a heterogeneous European book on Hopper, with
// a plain C interface (bound with ctypes by optpricer_tpu_torch/ops/
// mc_batch.py, built by optpricer_tpu_torch/_build.py).
//
// mc_batch_kernel replaces optpricer_tpu/ops/pallas_mc_batch.py:
// _mc_batch_kernel (its sw_prng stream). Each of the book's contracts owns
// one lane of a 128-lane contract tile (ktile) and carries its own strike,
// call/put sign, spot, (r-q-sigma^2/2)T, sigma sqrt(T) and discount factor
// in kparams (n_ktiles, 8, 128). It computes what the TPU kernel computes:
// the same draws (Threefry keyed by (seed, ktile * n_programs + program),
// counter (row * 128 + lane, rep), Box-Muller, two base draws per element
// and rep), the same terminal map and payoff, and the same 10 sums per lane
// (the dual-CV layout of ops/stats.py), in another shape:
//
// * On the TPU one grid program walks its reps in order over a 256x128
//   tile of one ktile and sums each rep's rows per lane before a Kahan step.
//   Here a block of 256 threads owns one (program, ktile, lane): a thread is
//   one row, loops over the reps and Kahan-sums its 10 sums in registers;
//   the block then reduces its 256 rows in a fixed warp-shuffle tree and
//   the warps in order (csrc/reduce.cuh), so each lane's tree over the rows
//   runs in one block with the lane's contract read once.
// * A second pass (combine, csrc/reduce.cuh) Kahan-sums each (ktile, lane)'s
//   program rows in program order, like ops/stats.combine_scan. No atomics:
//   one seed gives bitwise-identical stats on every run.
//
// What bounds it: integer, FP32 and SFU issue, as for terminal_mc_kernel.
// A base-draw pair costs one Threefry-2x32-20 block, a log32 (with its IEEE
// division), a sqrt and one sincosf, and two exp32 (four under antithetic
// sampling) with their payoffs, moments and a Kahan step; device memory sees
// the 8 floats of each lane's contract and the 16-float row each block
// writes. So the body is cut to the instructions it needs: one sincosf for
// the Box-Muller pair, which shares the range reduction that cosf and sinf
// each carry; one product sig z for both antithetic exponents; and a
// block-uniform split of the programs, in which a full program (every draw
// below n_paths: all but the last, below 2^24 tiles) forms no draw index,
// compare or weighted product.
//
// Rounding. As for the path kernel, the file is built without FMA
// contraction (-fmad=false, see _build.py) and the Box-Muller angle is the
// f32 product 2*pi*u2, as in the TPU kernel; its one sincosf returns the
// bits of cosf and sinf on every angle 2*pi*u2 can take
// (tests/test_torch_cuda.py), so every per-draw operation rounds as in the
// plain torch version (ops/mc_batch.py:_mc_batch_plain). A contract's
// in-the-money indicator is a discontinuous function of the draw: with the
// same rounding no draw flips it between the two, which matters for a
// contract whose sums hold few in-the-money draws.
//
// The tail mask is an integer compare of the lane's draw index against
// n_paths (the f32 params' value, as the TPU kernel masks); below 2^24
// tiles, which the wrapper asserts, it equals the TPU kernel's f32 remainder
// compare. A full program's weights are all 1 (ops/mc_batch._full_programs).

#include <cuda_runtime.h>

#include <cstdint>

#include "fastmath.cuh"
#include "reduce.cuh"
#include "threefry.cuh"

namespace optpricer {
namespace {

constexpr int BLOCK_R = 256;        // rows of a rep tile (pallas_mc_batch)
constexpr int LANES = 128;          // contracts per ktile
constexpr int KROWS = 8;            // kparams rows per ktile
constexpr int NSTAT = 10;           // stats.STATS2_DIM
constexpr int ROW = 16;             // stats row padded to 64 bytes
constexpr int THREADS = BLOCK_R;
constexpr float TINY = 5.9604645e-8f;  // 2^-24
constexpr float TWO_PI = 6.283185307179586f;

struct Contract {
  float K, sign, S0, mu, sig, df;
};

// (X, Y1, Y2) of the terminal spot S0 exp32(e): the discounted payoff, spot
// and in-the-money indicator.
__device__ __forceinline__ void observe(float e, const Contract &c, float &X,
                                        float &Y1, float &Y2) {
  const float ST = c.S0 * exp32(e);
  const float d = c.sign * (ST - c.K);
  X = c.df * fmaxf(d, 0.0f);
  Y1 = c.df * ST;
  Y2 = c.df * (d > 0.0f ? 1.0f : 0.0f);
}

// The 10 moments m of one sample of a branch; under antithetic sampling
// (f(z) + f(-z)) / 2 is ONE observation. The exponents mu + sig z and
// mu + sig (-z) are mu + p and mu - p with p = sig z formed once: sig (-z)
// = -(sig z) and a + (-b) = a - b exactly. FULL: the draw's weight is 1
// (a program no draw of which passes n_paths), and X * 1 = X exactly, so
// the weighted moments are the moments.
template <bool ANTI, bool FULL>
__device__ __forceinline__ void branch(float z, float w, const Contract &c,
                                       float *m) {
  const float p = c.sig * z;
  float X, Y1, Y2;
  observe(c.mu + p, c, X, Y1, Y2);
  if (ANTI) {
    float Xm, Y1m, Y2m;
    observe(c.mu - p, c, Xm, Y1m, Y2m);
    X = 0.5f * (X + Xm);
    Y1 = 0.5f * (Y1 + Y1m);
    Y2 = 0.5f * (Y2 + Y2m);
  }
  const float WX = FULL ? X : X * w;
  const float WY1 = FULL ? Y1 : Y1 * w;
  const float WY2 = FULL ? Y2 : Y2 * w;
  m[0] = FULL ? 1.0f : w;
  m[1] = WX;
  m[2] = WX * X;
  m[3] = WY1;
  m[4] = WY1 * Y1;
  m[5] = WX * Y1;
  m[6] = WY2;
  m[7] = WY2 * Y2;
  m[8] = WX * Y2;
  m[9] = WY1 * Y2;
}

// One thread's rep loop: Kahan-sums its row's 10 sums over the reps. FULL:
// every draw of the program lies below n_paths, so no draw needs its index
// or its weight. A rep's sums are m1 + m2: (0 + m1) + m2 differs from it
// at most in the sign of a zero, and a Kahan step from acc = +0 takes +0
// and -0 to the same acc and comp (acc and comp are never -0), so the
// sums keep their bits without the 10 adds to zero. Unrolled by two, acc
// and comp alternate between two sets of registers instead of being moved
// back at the end of each rep.
template <bool ANTI, bool FULL>
__device__ __forceinline__ void rep_loop(uint32_t key0, uint32_t key1,
                                         uint32_t elem, const Contract &c,
                                         long long first, long long n,
                                         int reps, float *acc, float *comp) {
#pragma unroll 2
  for (int j = 0; j < reps; ++j) {
    uint32_t bits_a, bits_b;
    threefry2x32(key0, key1, elem, static_cast<uint32_t>(j), bits_a, bits_b);
    // Box-Muller; u2 without the +0.5, as in the TPU kernel
    const float u1 = (static_cast<float>(bits_a >> 8) + 0.5f) * TINY;
    const float u2 = static_cast<float>(bits_b >> 8) * TINY;
    const float rad = sqrtf(-2.0f * log32(u1));
    const float theta = TWO_PI * u2;
    float sn, cs;
    sincosf(theta, &sn, &cs);
    // z1 is this row's draw in the rep's first half-tile, z2 in its second
    float w1 = 1.0f, w2 = 1.0f;
    if (!FULL) {
      const long long g1 = first + static_cast<long long>(j) * (2 * BLOCK_R);
      w1 = g1 < n ? 1.0f : 0.0f;
      w2 = g1 + BLOCK_R < n ? 1.0f : 0.0f;
    }
    float m1[NSTAT], m2[NSTAT], s[NSTAT];
    branch<ANTI, FULL>(rad * cs, w1, c, m1);
    branch<ANTI, FULL>(rad * sn, w2, c, m2);
#pragma unroll
    for (int k = 0; k < NSTAT; ++k) s[k] = m1[k] + m2[k];
    kahan_step<NSTAT>(acc, comp, s);
  }
}

template <bool ANTI>
__global__ void __launch_bounds__(THREADS)
mc_batch_kernel(const int *seed, const float *par, const float *kparams,
                int n_programs, int reps, float *block_rows) {
  // block = (ktile * LANES + lane) * n_programs + program: the rows of one
  // (ktile, lane) are consecutive, in program order, for the combine
  const int pid = blockIdx.x % n_programs;
  const int kl = blockIdx.x / n_programs;
  const int ktile = kl / LANES, lane = kl % LANES;
  const int row = threadIdx.x;
  const uint32_t key0 = static_cast<uint32_t>(seed[0]);
  const uint32_t key1 = static_cast<uint32_t>(ktile * n_programs + pid);
  const uint32_t elem = static_cast<uint32_t>(row * LANES + lane);
  const float *kp = kparams + static_cast<size_t>(ktile) * KROWS * LANES + lane;
  const Contract c{kp[0], kp[LANES], kp[2 * LANES], kp[3 * LANES],
                   kp[4 * LANES], kp[5 * LANES]};
  const long long n = static_cast<long long>(par[0]);
  // the program's draws: (pid * reps + j) * 2 * BLOCK_R + row (+ BLOCK_R)
  const long long first = static_cast<long long>(pid) * reps * (2 * BLOCK_R);

  float acc[NSTAT], comp[NSTAT];
#pragma unroll
  for (int k = 0; k < NSTAT; ++k) acc[k] = comp[k] = 0.0f;
  // block-uniform: every program but the last is full below 2^24 tiles
  if (first + static_cast<long long>(reps) * (2 * BLOCK_R) <= n)
    rep_loop<ANTI, true>(key0, key1, elem, c, first + row, n, reps, acc,
                         comp);
  else
    rep_loop<ANTI, false>(key0, key1, elem, c, first + row, n, reps, acc,
                          comp);
  block_row<NSTAT, THREADS>(
      acc, block_rows + static_cast<size_t>(blockIdx.x) * ROW);
}

}  // namespace
}  // namespace optpricer

using namespace optpricer;

// Book sums. seed: int32[1]; par: f32[1] (n_paths per contract); kparams:
// f32[n_ktiles, 8, 128]; block_rows: f32[n_ktiles * 128 * n_programs, 16]
// scratch; out: f32[n_ktiles * 128, 16], lane (ktile * 128 + lane)'s stats
// in [0, 10).
extern "C" int optpricer_mc_batch(const void *seed, const void *par,
                                  const void *kparams, void *block_rows,
                                  void *out, int n_programs, int n_ktiles,
                                  int reps, int antithetic, void *stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int blocks = n_programs * n_ktiles * LANES;
  const int *sd = static_cast<const int *>(seed);
  const float *pr = static_cast<const float *>(par);
  const float *kp = static_cast<const float *>(kparams);
  float *br = static_cast<float *>(block_rows);
  if (antithetic)
    mc_batch_kernel<true><<<blocks, THREADS, 0, s>>>(sd, pr, kp, n_programs,
                                                     reps, br);
  else
    mc_batch_kernel<false><<<blocks, THREADS, 0, s>>>(sd, pr, kp, n_programs,
                                                      reps, br);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(combine<NSTAT, ROW>(
      br, n_programs, n_ktiles * LANES, static_cast<float *>(out), s));
}
