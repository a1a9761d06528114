// Fused path QMC on Hopper: Sobol -> inverse normal CDF -> Brownian bridge
// -> payoff in one kernel, with a plain C interface (bound with ctypes by
// optpricer_tpu_torch/ops/qmc_path.py, built by optpricer_tpu_torch/_build.py).
//
// qmc_path_kernel replaces optpricer_tpu/ops/pallas_qmc_path.py:
// _qmc_path_kernel. It computes what the TPU kernel computes — the same
// Gray-code Sobol words, the same digital shifts, the same bridge matrix
// and the same 6 sums — in another shape:
//
// * On the TPU a program walks its reps over 256-point tiles with the time
//   steps on the lanes, and the bridge is one (256 x d) @ (d x d) MXU
//   product. Here one thread owns one point. It builds its n_steps Sobol
//   words with an XOR ladder over the direction numbers, turns them into
//   normals and keeps them in its own column of shared memory. Then, eight
//   time steps at a time, it forms logS_j = drift_j + sum_k z_k B[k][j] in
//   full f32 (k ascending), reading B from a slab in shared memory, and
//   folds exp32(logS_j) into the payoff's running terminal spot, sum,
//   log-sum, max, min and barrier flag. Nothing of shape (points, steps)
//   reaches device memory.
// * B is (d_pad x d_pad) f32: 256 KB at 252 steps, more than a block's
//   227 KB of shared memory, so the block stages one slab of it at a time:
//   the n_steps x 8 columns that the next eight time steps read (8 KB at
//   252 steps), loaded once through the read-only cache and then read by
//   every thread as a broadcast.
// * A block holds 64 points, a quarter of a TPU rep tile, and reduces their
//   6 sums in a fixed warp-shuffle tree into one row; a second pass
//   (csrc/reduce.cuh) Kahan-sums each program's rows in (rep, quarter)
//   order. No atomics.
//
// What bounds it: the n_steps^2 multiply-adds of the bridge product per
// point (63 504 at 252 steps), against n_steps * m_bits XORs for the Sobol
// words and n_steps exp32/norminv32.
//
// Rounding. The file is built without FMA contraction (-fmad=false, see
// _build.py), and the plain torch version (ops/qmc_path.py:_qmc_path_plain)
// forms the product as one multiply and one add per k in the same order,
// so logS rounds alike in both and a barrier or digital flag cannot flip
// between them; they differ only in the order of the payoff sums.

#include <cuda_runtime.h>

#include <cstdint>

#include "fastmath.cuh"
#include "reduce.cuh"

namespace optpricer {
namespace {

constexpr int P_TILE = 256;     // points per rep tile (pallas_qmc_path.P_TILE)
constexpr int NSTAT = 6;
constexpr int ROW = 8;          // stats row padded to 32 bytes
constexpr int THREADS = 64;     // points per block
constexpr int BLOCKS_PER_TILE = P_TILE / THREADS;
constexpr int JB = 8;           // time steps per register block
constexpr int MAX_SMEM = 232448;
constexpr float TINY = 5.9604645e-8f;  // 2^-24

enum Payoff { VANILLA = 0, BARRIER = 1, ASIAN = 2, DIGITAL = 3, LOOKBACK = 4 };
enum Flag {
  BARRIER_UP = 1,
  KNOCK_IN = 2,
  IS_CALL = 4,
  ARITHMETIC = 8,
  FIXED_STRIKE = 16,
};

template <int PAYOFF>
__global__ void __launch_bounds__(THREADS)
qmc_path_kernel(const int *seed, const float *par, const int *V,
                const int *shifts, const float *B, const float *drift,
                int reps, int progs_per_rep, int n_steps, int d_pad,
                int m_bits, int flags, float *block_rows) {
  // [n_steps][THREADS] normals, a column per thread, then the B slab
  extern __shared__ float4 smem[];
  float *z_s = reinterpret_cast<float *>(smem);
  const int tile = blockIdx.x / BLOCKS_PER_TILE;  // program * reps + rep
  const int quarter = blockIdx.x % BLOCKS_PER_TILE;
  const int pid = tile / reps, j = tile % reps;
  const int rep_id = pid / progs_per_rep, tile_idx = pid % progs_per_rep;
  const long long idx =
      (static_cast<long long>(tile_idx) * reps + j) * P_TILE +
      quarter * THREADS + threadIdx.x;
  const long long n_last = seed[1];  // last valid point index

  // Gray-code Sobol words, digitally shifted, to normals
  const uint32_t uidx = static_cast<uint32_t>(idx);
  const uint32_t gray = uidx ^ (uidx >> 1);
  const int *shift_row = shifts + static_cast<size_t>(rep_id) * d_pad;
  float *zt = z_s + threadIdx.x;
  for (int k = 0; k < n_steps; ++k) {
    uint32_t x = static_cast<uint32_t>(__ldg(shift_row + k));
    for (int b = 0; b < m_bits; ++b) {
      const uint32_t bit = (gray >> b) & 1u;
      x ^= bit * static_cast<uint32_t>(__ldg(V + b * d_pad + k));
    }
    const float u = (static_cast<float>(x >> 8) + 0.5f) * TINY;
    zt[k * THREADS] = norminv32(u);
  }

  const float S0 = par[0], K = par[1], df = par[2], barrier = par[3],
              rebate = par[4], payout = par[5];
  const bool up = flags & BARRIER_UP, knock_in = flags & KNOCK_IN,
             is_call = flags & IS_CALL, arithmetic = flags & ARITHMETIC,
             fixed_strike = flags & FIXED_STRIKE;
  const float sign = is_call ? 1.0f : -1.0f;

  float sum_s = 0.0f, sum_log = 0.0f, smax = -3.0e38f, smin = 3.0e38f,
        ST = 0.0f;
  bool hit = false;
  float4 *b_s = reinterpret_cast<float4 *>(z_s + n_steps * THREADS);
  for (int j0 = 0; j0 < n_steps; j0 += JB) {
    // stage the slab B[0:n_steps, j0:j0+8) in shared memory
    __syncthreads();
    for (int i = threadIdx.x; i < 2 * n_steps; i += THREADS)
      b_s[i] = __ldg(reinterpret_cast<const float4 *>(
          B + static_cast<size_t>(i >> 1) * d_pad + j0 + 4 * (i & 1)));
    __syncthreads();
    float a[JB];
#pragma unroll
    for (int jj = 0; jj < JB; ++jj) a[jj] = 0.0f;
    for (int k = 0; k < n_steps; ++k) {
      const float zk = zt[k * THREADS];
      const float4 b0 = b_s[2 * k];
      const float4 b1 = b_s[2 * k + 1];
      a[0] = a[0] + zk * b0.x;
      a[1] = a[1] + zk * b0.y;
      a[2] = a[2] + zk * b0.z;
      a[3] = a[3] + zk * b0.w;
      a[4] = a[4] + zk * b1.x;
      a[5] = a[5] + zk * b1.y;
      a[6] = a[6] + zk * b1.z;
      a[7] = a[7] + zk * b1.w;
    }
#pragma unroll
    for (int jj = 0; jj < JB; ++jj) {
      const int jc = j0 + jj;
      if (jc < n_steps) {
        const float logS = __ldg(drift + jc) + a[jj];
        const float S = exp32(logS);
        if (PAYOFF == ASIAN) {
          sum_s += S;
          sum_log += logS;
        }
        if (PAYOFF == LOOKBACK) {
          smax = fmaxf(smax, S);
          smin = fminf(smin, S);
        }
        if (PAYOFF == BARRIER) hit = hit || (up ? S >= barrier : S <= barrier);
        if (jc == n_steps - 1) ST = S;
      }
    }
  }

  const float nsf = static_cast<float>(n_steps);
  float pay;
  if (PAYOFF == ASIAN) {
    const float avg = arithmetic ? sum_s / nsf : exp32(sum_log / nsf);
    pay = fixed_strike ? fmaxf(sign * (avg - K), 0.0f)
                       : fmaxf(sign * (ST - avg), 0.0f);
  } else if (PAYOFF == LOOKBACK) {
    const float rmax = fmaxf(smax, S0), rmin = fminf(smin, S0);
    if (fixed_strike)
      pay = is_call ? fmaxf(rmax - K, 0.0f) : fmaxf(K - rmin, 0.0f);
    else
      pay = is_call ? ST - rmin : rmax - ST;
  } else if (PAYOFF == BARRIER) {
    const bool crossed = hit || (up ? S0 >= barrier : S0 <= barrier);
    const float live = fmaxf(sign * (ST - K), 0.0f);
    pay = crossed ? (knock_in ? live : rebate) : (knock_in ? rebate : live);
  } else if (PAYOFF == DIGITAL) {
    pay = sign * (ST - K) > 0.0f ? payout : 0.0f;
  } else {
    pay = fmaxf(sign * (ST - K), 0.0f);
  }
  const float w = idx <= n_last ? 1.0f : 0.0f;
  const float X = df * pay * w;
  const float Y = df * ST * w;
  const float s[NSTAT] = {w, X, X * pay * df, Y, Y * ST * df, X * ST * df};
  block_row<NSTAT, THREADS>(s, block_rows + static_cast<size_t>(blockIdx.x) *
                                                ROW);
}

template <int PAYOFF>
cudaError_t launch(int blocks, size_t smem, cudaStream_t stream,
                   const int *seed, const float *par, const int *V,
                   const int *shifts, const float *B, const float *drift,
                   int reps, int progs_per_rep, int n_steps, int d_pad,
                   int m_bits, int flags, float *block_rows) {
  cudaError_t err = cudaFuncSetAttribute(
      qmc_path_kernel<PAYOFF>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  qmc_path_kernel<PAYOFF><<<blocks, THREADS, smem, stream>>>(
      seed, par, V, shifts, B, drift, reps, progs_per_rep, n_steps, d_pad,
      m_bits, flags, block_rows);
  return cudaGetLastError();
}

}  // namespace
}  // namespace optpricer

using namespace optpricer;

// Path-QMC sums per program. block_rows: f32[n_programs * reps * 4, 8]
// scratch; out: f32[n_programs, 8], stats in [0, 6).
extern "C" int optpricer_qmc_path(const void *seed, const void *par,
                                  const void *V, const void *shifts,
                                  const void *B, const void *drift,
                                  void *block_rows, void *out,
                                  int n_programs, int reps, int progs_per_rep,
                                  int n_steps, int d_pad, int m_bits,
                                  int payoff, int flags, void *stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const size_t smem =
      static_cast<size_t>(n_steps) * (THREADS + JB) * sizeof(float);
  if (smem > MAX_SMEM || d_pad % JB != 0 || n_steps > d_pad)
    return static_cast<int>(cudaErrorInvalidValue);
  const int blocks = n_programs * reps * BLOCKS_PER_TILE;
  const int *sd = static_cast<const int *>(seed);
  const float *pr = static_cast<const float *>(par);
  const int *v = static_cast<const int *>(V);
  const int *sh = static_cast<const int *>(shifts);
  const float *b = static_cast<const float *>(B);
  const float *dr = static_cast<const float *>(drift);
  float *br = static_cast<float *>(block_rows);
  cudaError_t err;
  switch (payoff) {
    case VANILLA:
      err = launch<VANILLA>(blocks, smem, s, sd, pr, v, sh, b, dr, reps,
                            progs_per_rep, n_steps, d_pad, m_bits, flags, br);
      break;
    case BARRIER:
      err = launch<BARRIER>(blocks, smem, s, sd, pr, v, sh, b, dr, reps,
                            progs_per_rep, n_steps, d_pad, m_bits, flags, br);
      break;
    case ASIAN:
      err = launch<ASIAN>(blocks, smem, s, sd, pr, v, sh, b, dr, reps,
                          progs_per_rep, n_steps, d_pad, m_bits, flags, br);
      break;
    case DIGITAL:
      err = launch<DIGITAL>(blocks, smem, s, sd, pr, v, sh, b, dr, reps,
                            progs_per_rep, n_steps, d_pad, m_bits, flags, br);
      break;
    case LOOKBACK:
      err = launch<LOOKBACK>(blocks, smem, s, sd, pr, v, sh, b, dr, reps,
                             progs_per_rep, n_steps, d_pad, m_bits, flags,
                             br);
      break;
    default:
      err = cudaErrorInvalidValue;
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(combine<NSTAT, ROW>(
      br, reps * BLOCKS_PER_TILE, n_programs, static_cast<float *>(out), s));
}
