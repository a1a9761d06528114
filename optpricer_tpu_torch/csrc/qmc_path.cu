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
//   product. Here one thread owns one point and a block holds 64 points
//   with consecutive indices, a quarter of a TPU rep tile.
// * The bridge by its nonzeros. B = sigma A with A the Brownian bridge:
//   column j (time j + 1) is nonzero only at the z-dimensions of its
//   ancestors in the bisection schedule, at most ceil(log2 d) + 1 of them
//   (9 at 252 steps, against 252 terms of the dense product), and
//   dimension k is used only by the columns of its bisection interval.
//   The kernel reads B through a plan that the host builds once per
//   shape, sigma and T, beside B (ops/qmc_path.py:_bridge_plan): for each
//   group of eight columns, the dimensions first used there and, for each
//   column, its nonzeros in ascending k, padded with zeros to `width`
//   entries. It gives each dimension one of SLOTS slots for the groups
//   from its first use to its last (a greedy colouring of those
//   intervals, in order of first use): ~20 are live at once at 252 to
//   2 048 steps. The host refuses a B whose columns or live dimensions
//   overflow the plan: only a bridge is summed here.
// * So a thread keeps no column of n_steps normals. It walks the groups in
//   time order; for each it draws the normals of the dimensions first used
//   there into their slots of its column of shared memory, then sums each
//   of the eight columns over its table entries, their eight chains
//   interleaved, and folds exp32(logS_j) into the payoff's running
//   terminal spot, sum, log-sum, max, min and barrier flag. A block needs
//   SLOTS x 64 x 4 bytes (8 KB) and the common words, not 64 x n_steps x 4
//   (64.5 KB at 252 steps): registers bound the blocks an SM holds (16)
//   up to about 1 000 steps, shared memory above that (13 at 2 048).
// * Sobol by block-common bits. Bits 6 and up of the Gray code idx ^ idx>>1
//   are the same for the block's 64 points, so the block XORs the
//   replicate's shift and the direction numbers of those bits once per
//   step, cooperatively, into shared memory (the common words). A thread
//   then XORs in only the direction numbers of its own 6 low bits, read as
//   one warp-uniform row per dimension from the plan's vlow table. XOR is
//   exact: the words are those of the full ladder.
// * The block reduces its 64 points' 6 sums in a fixed warp-shuffle tree
//   into one row; a second pass (csrc/reduce.cuh) Kahan-sums each program's
//   rows in (rep, quarter) order. No atomics.
//
// What bounds it: the issue of its instructions. Per point and step, one
// norminv32 (a log32 with its IEEE division), the six-term XOR of the low
// bits, ~log2(d) + 1 multiply-adds of the bridge with their shared loads,
// and for the Asian one exp32.
//
// Rounding. The file is built without FMA contraction (-fmad=false, see
// _build.py), and the plain torch version (ops/qmc_path.py:_qmc_path_plain)
// forms the dense product as one multiply and one add per k in the same
// order. The sparse sum keeps those bits: from a = +0, a zero B_kj adds
// z_k * 0 = +-0 (z_k is finite, and an unused slot holds +0), and
// a + (+-0) == a for every a this sum can hold (it is never -0), so
// skipping or padding zeros in ascending k leaves logS unchanged bit for
// bit, and no barrier or digital flag can flip between the two; they
// differ only in the order of the payoff sums.

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
constexpr int LOW_BITS = 6;     // log2(THREADS): Gray-code bits a thread owns
constexpr int JB = 8;           // columns (time steps) per group
constexpr int SLOTS = 32;       // normals a thread holds at once
constexpr int MIN_BLOCKS = 16;  // register budget: 64 a thread
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

// The plan of B (ops/qmc_path.py:_bridge_plan), one int32 array:
// * entries: int4[n_groups][width][4]; group g's entry i holds, for its
//   columns 8g..8g+7, the slot offset s * THREADS of the i-th nonzero's
//   dimension k (int4 0 and 1) and the value B[k][j] (int4 2 and 3, float
//   bits), or offset 0 and +0 past a column's last nonzero and for the
//   columns past n_steps;
// * groups: int2[n_groups]: the first of the group's gen entries and
//   their count;
// * gen: int2[n_steps]: (k, slot offset) of each dimension, grouped by
//   the group of its first use, ascending k within a group;
// * vlow: int4[n_steps][2], the direction numbers of Gray-code bits 0..5
//   at dimension k (and two zero words).
// Each part starts on a 16-byte boundary.
struct Plan {
  const int4 *entries;
  const int2 *groups, *gen;
  const int4 *vlow;
};

inline int align4(int n) { return (n + 3) / 4 * 4; }

Plan carve(const void *plan, int n_steps, int width) {
  const int n_groups = (n_steps + JB - 1) / JB;
  const int *p = static_cast<const int *>(plan);
  Plan out;
  out.entries = reinterpret_cast<const int4 *>(p);
  p += align4(n_groups * width * 16);
  out.groups = reinterpret_cast<const int2 *>(p);
  p += align4(n_groups * 2);
  out.gen = reinterpret_cast<const int2 *>(p);
  p += align4(n_steps * 2);
  out.vlow = reinterpret_cast<const int4 *>(p);
  return out;
}

// The point's Sobol word at dimension k: the block's common word and the
// direction numbers of the point's own low bits (masks m), then its normal.
__device__ __forceinline__ float normal_at(const uint32_t *common,
                                           const int4 *vlow, int k,
                                           const uint32_t *m) {
  const int4 v0 = __ldg(vlow + 2 * k), v1 = __ldg(vlow + 2 * k + 1);
  const uint32_t x = common[k] ^ (static_cast<uint32_t>(v0.x) & m[0]) ^
                     (static_cast<uint32_t>(v0.y) & m[1]) ^
                     (static_cast<uint32_t>(v0.z) & m[2]) ^
                     (static_cast<uint32_t>(v0.w) & m[3]) ^
                     (static_cast<uint32_t>(v1.x) & m[4]) ^
                     (static_cast<uint32_t>(v1.y) & m[5]);
  return norminv32((static_cast<float>(x >> 8) + 0.5f) * TINY);
}

struct PathState {
  float sum_s, sum_log, smax, smin, ST;
  bool hit;
};

// Fold column jc's log-spot into the payoff's running state. CHECK: the
// group may hold columns past n_steps.
template <int PAYOFF, bool CHECK>
__device__ __forceinline__ void fold(PathState &st, float logS, int jc,
                                     int n_steps, bool up, float barrier) {
  if (CHECK && jc >= n_steps) return;
  const float S = exp32(logS);
  if (PAYOFF == ASIAN) {
    st.sum_s += S;
    st.sum_log += logS;
  }
  if (PAYOFF == LOOKBACK) {
    st.smax = fmaxf(st.smax, S);
    st.smin = fminf(st.smin, S);
  }
  if (PAYOFF == BARRIER)
    st.hit = st.hit || (up ? S >= barrier : S <= barrier);
  if (!CHECK || jc == n_steps - 1) st.ST = S;
}

template <int PAYOFF>
__global__ void __launch_bounds__(THREADS, MIN_BLOCKS)
qmc_path_kernel(const int *seed, const float *par, const int *V,
                const int *shifts, const float *drift, Plan plan, int reps,
                int progs_per_rep, int n_steps, int d_pad, int m_bits,
                int width, int flags, float *block_rows) {
  // [SLOTS][THREADS] normals, a column per thread, then the n_steps
  // block-common words
  extern __shared__ float4 smem[];
  float *z_s = reinterpret_cast<float *>(smem);
  uint32_t *common = reinterpret_cast<uint32_t *>(z_s + SLOTS * THREADS);
  const int tile = blockIdx.x / BLOCKS_PER_TILE;  // program * reps + rep
  const int quarter = blockIdx.x % BLOCKS_PER_TILE;
  const int pid = tile / reps, jr = tile % reps;
  const int rep_id = pid / progs_per_rep, tile_idx = pid % progs_per_rep;
  const long long idx =
      (static_cast<long long>(tile_idx) * reps + jr) * P_TILE +
      quarter * THREADS + threadIdx.x;
  const long long n_last = seed[1];  // last valid point index

  // the block's Gray-code bits LOW_BITS.. below m_bits (idx - threadIdx.x
  // is a multiple of THREADS, so they are the first point's)
  const uint32_t uidx = static_cast<uint32_t>(idx);
  const uint32_t gray = uidx ^ (uidx >> 1);
  const uint32_t high = (gray >> LOW_BITS) &
                        ((m_bits < 32 ? (1u << m_bits) - 1u : ~0u) >> LOW_BITS);
  const int *shift_row = shifts + static_cast<size_t>(rep_id) * d_pad;
  for (int k = threadIdx.x; k < n_steps; k += THREADS) {
    uint32_t x = static_cast<uint32_t>(__ldg(shift_row + k));
    const int *vk = V + LOW_BITS * d_pad + k;
#pragma unroll 4
    for (int b = 0; b < m_bits - LOW_BITS; ++b)
      x ^= static_cast<uint32_t>(__ldg(vk + b * d_pad)) &
           (0u - ((high >> b) & 1u));
    common[k] = x;
  }
  // each thread's slots start at +0, so a padded entry reads a finite z
  float *zt = z_s + threadIdx.x;
#pragma unroll
  for (int s = 0; s < SLOTS; ++s) zt[s * THREADS] = 0.0f;
  __syncthreads();

  // this thread's low bits, as all-ones / all-zeros masks
  uint32_t m[LOW_BITS];
#pragma unroll
  for (int b = 0; b < LOW_BITS; ++b) m[b] = 0u - ((gray >> b) & 1u);

  const float S0 = par[0], K = par[1], df = par[2], barrier = par[3],
              rebate = par[4], payout = par[5];
  const bool up = flags & BARRIER_UP, knock_in = flags & KNOCK_IN,
             is_call = flags & IS_CALL, arithmetic = flags & ARITHMETIC,
             fixed_strike = flags & FIXED_STRIKE;
  const float sign = is_call ? 1.0f : -1.0f;

  PathState st{0.0f, 0.0f, -3.0e38f, 3.0e38f, 0.0f, false};
  const char *zc = reinterpret_cast<const char *>(zt);
  const int n_groups = (n_steps + JB - 1) / JB;
  for (int g = 0; g < n_groups; ++g) {
    const int2 info = __ldg(plan.groups + g);
    // the normals of the dimensions first used in this group
    for (int i = info.x; i < info.x + info.y; ++i) {
      const int2 ge = __ldg(plan.gen + i);
      zt[ge.y] = normal_at(common, plan.vlow, ge.x, m);
    }
    float a[JB];
#pragma unroll
    for (int jj = 0; jj < JB; ++jj) a[jj] = 0.0f;
    const int j0 = g * JB;
    const int4 *e = plan.entries + static_cast<size_t>(g) * width * 4;
    for (int i = 0; i < width; ++i, e += 4) {
      const int4 o0 = __ldg(e), o1 = __ldg(e + 1);
      const int4 b0 = __ldg(e + 2), b1 = __ldg(e + 3);
      const int o[JB] = {o0.x, o0.y, o0.z, o0.w, o1.x, o1.y, o1.z, o1.w};
      const int bv[JB] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int jj = 0; jj < JB; ++jj)
        a[jj] = a[jj] + *reinterpret_cast<const float *>(zc + 4 * o[jj]) *
                            __int_as_float(bv[jj]);
    }
    const float4 d0 = __ldg(reinterpret_cast<const float4 *>(drift + j0));
    const float4 d1 = __ldg(reinterpret_cast<const float4 *>(drift + j0 + 4));
    const float dv[JB] = {d0.x, d0.y, d0.z, d0.w, d1.x, d1.y, d1.z, d1.w};
    if (j0 + JB <= n_steps) {
#pragma unroll
      for (int jj = 0; jj < JB; ++jj)
        fold<PAYOFF, false>(st, dv[jj] + a[jj], j0 + jj, n_steps, up,
                            barrier);
    } else {
#pragma unroll
      for (int jj = 0; jj < JB; ++jj)
        fold<PAYOFF, true>(st, dv[jj] + a[jj], j0 + jj, n_steps, up,
                           barrier);
    }
  }

  const float nsf = static_cast<float>(n_steps);
  const float ST = st.ST;
  float pay;
  if (PAYOFF == ASIAN) {
    const float avg = arithmetic ? st.sum_s / nsf : exp32(st.sum_log / nsf);
    pay = fixed_strike ? fmaxf(sign * (avg - K), 0.0f)
                       : fmaxf(sign * (ST - avg), 0.0f);
  } else if (PAYOFF == LOOKBACK) {
    const float rmax = fmaxf(st.smax, S0), rmin = fminf(st.smin, S0);
    if (fixed_strike)
      pay = is_call ? fmaxf(rmax - K, 0.0f) : fmaxf(K - rmin, 0.0f);
    else
      pay = is_call ? ST - rmin : rmax - ST;
  } else if (PAYOFF == BARRIER) {
    const bool crossed = st.hit || (up ? S0 >= barrier : S0 <= barrier);
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

size_t shared_bytes(int n_steps) {
  return (static_cast<size_t>(SLOTS) * THREADS + n_steps) * sizeof(float);
}

template <int PAYOFF>
cudaError_t launch(int blocks, size_t smem, cudaStream_t stream,
                   const int *seed, const float *par, const int *V,
                   const int *shifts, const float *drift, const Plan &plan,
                   int reps, int progs_per_rep, int n_steps, int d_pad,
                   int m_bits, int width, int flags, float *block_rows) {
  cudaError_t err = cudaFuncSetAttribute(
      qmc_path_kernel<PAYOFF>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  qmc_path_kernel<PAYOFF><<<blocks, THREADS, smem, stream>>>(
      seed, par, V, shifts, drift, plan, reps, progs_per_rep, n_steps, d_pad,
      m_bits, width, flags, block_rows);
  return cudaGetLastError();
}

template <int PAYOFF>
int occupancy(int n_steps) {
  const size_t smem = shared_bytes(n_steps);
  if (cudaFuncSetAttribute(qmc_path_kernel<PAYOFF>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           static_cast<int>(smem)) != cudaSuccess)
    return -1;
  int blocks = 0;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &blocks, qmc_path_kernel<PAYOFF>, THREADS, smem) != cudaSuccess)
    return -1;
  return blocks;
}

}  // namespace
}  // namespace optpricer

using namespace optpricer;

// Path-QMC sums per program: the kernel, then the combine. plan: B's plan
// (int32, laid out as carve() reads it); block_rows: f32[n_programs * reps
// * 4, 8] scratch; out: f32[n_programs, 8], stats in [0, 6).
extern "C" int optpricer_qmc_path(const void *seed, const void *par,
                                  const void *V, const void *shifts,
                                  const void *drift, const void *plan,
                                  void *block_rows, void *out,
                                  int n_programs, int reps, int progs_per_rep,
                                  int n_steps, int d_pad, int m_bits,
                                  int width, int payoff, int flags,
                                  void *stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const size_t smem = shared_bytes(n_steps);
  if (smem > MAX_SMEM || n_steps < 1 || n_steps > d_pad || d_pad % JB ||
      width < 1 || m_bits < LOW_BITS || m_bits > 32)
    return static_cast<int>(cudaErrorInvalidValue);
  const Plan pl = carve(plan, n_steps, width);
  const int blocks = n_programs * reps * BLOCKS_PER_TILE;
  const int *sd = static_cast<const int *>(seed);
  const float *pr = static_cast<const float *>(par);
  const int *v = static_cast<const int *>(V);
  const int *sh = static_cast<const int *>(shifts);
  const float *dr = static_cast<const float *>(drift);
  float *br = static_cast<float *>(block_rows);
  cudaError_t err;
#define OPTPRICER_QMC_LAUNCH(P)                                             \
  launch<P>(blocks, smem, s, sd, pr, v, sh, dr, pl, reps, progs_per_rep,   \
            n_steps, d_pad, m_bits, width, flags, br)
  switch (payoff) {
    case VANILLA:
      err = OPTPRICER_QMC_LAUNCH(VANILLA);
      break;
    case BARRIER:
      err = OPTPRICER_QMC_LAUNCH(BARRIER);
      break;
    case ASIAN:
      err = OPTPRICER_QMC_LAUNCH(ASIAN);
      break;
    case DIGITAL:
      err = OPTPRICER_QMC_LAUNCH(DIGITAL);
      break;
    case LOOKBACK:
      err = OPTPRICER_QMC_LAUNCH(LOOKBACK);
      break;
    default:
      err = cudaErrorInvalidValue;
  }
#undef OPTPRICER_QMC_LAUNCH
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(combine<NSTAT, ROW>(
      br, reps * BLOCKS_PER_TILE, n_programs, static_cast<float *>(out), s));
}

// Resident blocks per SM of the kernel for `payoff` at n_steps (the CUDA
// runtime's occupancy with its dynamic shared memory), or -1.
extern "C" int optpricer_qmc_path_occupancy(int payoff, int n_steps) {
  if (shared_bytes(n_steps) > MAX_SMEM) return -1;
  switch (payoff) {
    case VANILLA:
      return occupancy<VANILLA>(n_steps);
    case BARRIER:
      return occupancy<BARRIER>(n_steps);
    case ASIAN:
      return occupancy<ASIAN>(n_steps);
    case DIGITAL:
      return occupancy<DIGITAL>(n_steps);
    case LOOKBACK:
      return occupancy<LOOKBACK>(n_steps);
    default:
      return -1;
  }
}
