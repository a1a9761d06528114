// Path-dependent multi-asset Monte Carlo on Hopper: the correlated-basket
// path kernel, with a plain C interface (bound with ctypes by
// optpricer_tpu_torch/ops/basket_mc.py, built by
// optpricer_tpu_torch/_build.py).
//
// basket_mc_kernel replaces optpricer_tpu/ops/pallas_basket_mc.py:
// _basket_kernel (its sw_prng stream). It computes what the TPU kernel
// computes: correlated GBM for a <= MAX_ASSETS assets by exact log-Euler,
// S_i <- S_i * exp32(drift_i + voldt_i * x_i) with x_i = sum_{j<=i} L_ij z_j
// (the Cholesky factor applied as a lower-triangular chain), the payoffs
// asian_basket (t = 0 excluded from the average), worstof_barrier and
// basket_barrier (t = 0 included through the host's crossed0 flag), up/down
// x in/out with rebate, antithetic pairs averaged into one observation, and
// the 6 control-variate sums (n, sum X, sum X^2, sum Y, sum Y^2, sum XY)
// with Y = e^{-rT} B_T. The draws are the TPU kernel's: Threefry keyed by
// (seed, global program id), counter (element, (c * n_steps + t) *
// ceil(a/2) + k), ceil(a/2) Box-Muller pairs a step, the last normal of a
// step dropped for an odd a. In another shape:
//
// * On the TPU one grid program walks its reps in order over a 32x128 tile
//   of path pairs, one tile per asset. Here one thread owns one (program,
//   element) path pair and loops over the reps and the steps; the assets'
//   spots for the + and - legs, the running basket sum and the barrier flags
//   stay in registers (arrays of MAXA, loops fully unrolled and guarded by
//   i < a, with a a runtime value). The asset count is bucketed, MAXA in
//   {4, 8, 16}: at 16 the unrolled chain holds more values than registers
//   and spills, which the smaller books need not pay. The a per-asset
//   scalars and the a(a+1)/2 Cholesky entries are staged once per block in
//   shared memory.
// * The - leg's correlated shocks are -x_i: negation is exact in IEEE
//   arithmetic, so L(-z) = -(Lz) bit for bit and the chain runs once.
// * Each thread Kahan-sums its 6 sums over reps; a block of 128 threads
//   reduces them in a fixed warp-shuffle tree; then two combine passes
//   (csrc/reduce.cuh) Kahan-sum the block rows of each program and the
//   program rows in order. No atomics: one seed gives bitwise-identical
//   stats on every run.
//
// What bounds it: integer and SFU issue. A step costs ceil(a/2)
// Threefry-2x32-20 blocks and Box-Muller pairs (a log32, a sqrt, a cos and
// a sin each), a(a+1)/2 multiply-adds for the correlation and, per leg, a
// exp32 and a multiply-adds for the basket; device memory sees only the
// params (7 + 4a + a^2 floats) and the 8-float row each block writes. The
// payoff, antithetic sampling and the asset bucket are template parameters;
// the barrier direction and in/out are warp-uniform runtime flags.
//
// Rounding. The file is built without FMA contraction (-fmad=false, see
// _build.py) and the Box-Muller angle is cosf/sinf of the f32 product
// 2*pi*u2, as in the TPU kernel: every per-path operation rounds as in the
// plain torch version (ops/basket_mc.py:_basket_mc_plain), so a barrier
// indicator flips in neither or both. The Asian average run_sum / n_steps
// is a true f32 division. The tail mask is the TPU kernel's f32 compare,
// elem < n_paths - (pid * reps + c) * TILE.

#include <cuda_runtime.h>

#include <cstdint>

#include "fastmath.cuh"
#include "reduce.cuh"
#include "threefry.cuh"

namespace optpricer {
namespace {

constexpr int TILE = 32 * 128;      // path pairs per rep (pallas_basket_mc.TILE)
constexpr int NSTAT = 6;            // pallas_basket_mc.NSTAT
constexpr int ROW = 8;              // stats row padded to 32 bytes
constexpr int THREADS = 128;
constexpr int BLOCKS_PER_PROGRAM = TILE / THREADS;
constexpr int MAX_ASSETS = 16;      // ops/basket_mc.MAX_ASSETS
constexpr int MAX_CHOL = MAX_ASSETS * (MAX_ASSETS + 1) / 2;
constexpr float TINY = 5.9604645e-8f;  // 2^-24
constexpr float TWO_PI = 6.283185307179586f;

enum Payoff { ASIAN_BASKET = 0, WORSTOF_BARRIER = 1, BASKET_BARRIER = 2 };
enum Flag { BARRIER_UP = 1, KNOCK_IN = 2 };

// params layout (pallas_basket_mc._build_params): 7 scalars, then S0_i,
// drift_i (per step), voldt_i (per step), w_i for each asset, then the
// Cholesky factor row-major (a x a).
enum Par { P_K, P_DF, P_NPATHS, P_SIGN, P_BARRIER, P_REBATE, P_CROSSED0,
           P_ASSETS };

struct Assets {
  float S0[MAX_ASSETS], drift[MAX_ASSETS], voldt[MAX_ASSETS], w[MAX_ASSETS];
  float L[MAX_CHOL];  // lower triangle, row i at i(i+1)/2
};

__device__ __forceinline__ void normals(uint32_t key0, uint32_t key1,
                                        uint32_t elem, uint32_t draw,
                                        float &z1, float &z2) {
  uint32_t a, b;
  threefry2x32(key0, key1, elem, draw, a, b);
  const float u1 = (static_cast<float>(a >> 8) + 0.5f) * TINY;
  const float u2 = static_cast<float>(b >> 8) * TINY;
  const float rad = sqrtf(-2.0f * log32(u1));
  const float theta = TWO_PI * u2;
  z1 = rad * cosf(theta);
  z2 = rad * sinf(theta);
}

template <int MAXA>
struct Leg {
  float S[MAXA];
  float run_sum, crossed;
};

template <int MAXA>
__device__ __forceinline__ void init_leg(Leg<MAXA> &g, const Assets &as,
                                         int a, float crossed0) {
#pragma unroll
  for (int i = 0; i < MAXA; ++i)
    if (i < a) g.S[i] = as.S0[i];
  g.run_sum = 0.0f;
  g.crossed = crossed0;
}

template <int MAXA>
__device__ __forceinline__ float basket(const Leg<MAXA> &g, const Assets &as,
                                        int a) {
  float B = as.w[0] * g.S[0];
#pragma unroll
  for (int i = 1; i < MAXA; ++i)
    if (i < a) B = B + as.w[i] * g.S[i];
  return B;
}

template <int MAXA>
__device__ __forceinline__ float worst(const Leg<MAXA> &g, int a) {
  float m = g.S[0];
#pragma unroll
  for (int i = 1; i < MAXA; ++i)
    if (i < a) m = fminf(m, g.S[i]);
  return m;
}

// One time step of a leg under the correlated shocks x (sgn = -1 for the
// mirrored leg).
template <int PAYOFF, int MAXA>
__device__ __forceinline__ void advance(Leg<MAXA> &g, const float *x,
                                        float sgn, const Assets &as, int a,
                                        bool up, float barrier) {
#pragma unroll
  for (int i = 0; i < MAXA; ++i)
    if (i < a)
      g.S[i] = g.S[i] * exp32(as.drift[i] + as.voldt[i] * (sgn * x[i]));
  const float B = basket(g, as, a);
  if (PAYOFF == ASIAN_BASKET) {
    g.run_sum = g.run_sum + B;
  } else {
    const float lvl = PAYOFF == WORSTOF_BARRIER ? worst(g, a) : B;
    const bool hit = up ? lvl >= barrier : lvl <= barrier;
    g.crossed = fmaxf(g.crossed, hit ? 1.0f : 0.0f);
  }
}

// (X, Y) = (e^{-rT} payoff, e^{-rT} B_T) of one leg.
template <int PAYOFF, int MAXA>
__device__ __forceinline__ void payoff_of(const Leg<MAXA> &g,
                                          const Assets &as, int a,
                                          const float *par, float nsf,
                                          bool knock_in, float &X, float &Y) {
  const float K = par[P_K], df = par[P_DF], sign = par[P_SIGN];
  const float B_T = basket(g, as, a);
  float pay;
  if (PAYOFF == ASIAN_BASKET) {
    pay = fmaxf(sign * (g.run_sum / nsf - K), 0.0f);
  } else {
    const float term = PAYOFF == WORSTOF_BARRIER ? worst(g, a) : B_T;
    const float live = fmaxf(sign * (term - K), 0.0f);
    const float rebate = par[P_REBATE];
    const bool hit = g.crossed > 0.5f;
    pay = hit ? (knock_in ? live : rebate) : (knock_in ? rebate : live);
  }
  X = df * pay;
  Y = df * B_T;
}

template <int PAYOFF, bool ANTI, int MAXA>
__global__ void __launch_bounds__(THREADS)
basket_mc_kernel(const int *seed, const float *par, int a, int reps,
                 int n_steps, int flags, float *block_rows) {
  const int local_pid = blockIdx.x / BLOCKS_PER_PROGRAM;
  const int elem = (blockIdx.x % BLOCKS_PER_PROGRAM) * THREADS + threadIdx.x;
  // global program id: the stream key, whatever slice of the grid runs here
  const int pid = local_pid + seed[1];
  const uint32_t key0 = static_cast<uint32_t>(seed[0]);
  const uint32_t key1 = static_cast<uint32_t>(pid);
  const uint32_t ctr0 = static_cast<uint32_t>(elem);
  const bool up = flags & BARRIER_UP;
  const bool knock_in = flags & KNOCK_IN;
  const float barrier = par[P_BARRIER];
  const float n_paths = par[P_NPATHS];
  const float nsf = static_cast<float>(n_steps);
  const int n_pairs = (a + 1) / 2;

  __shared__ Assets as;
  if (threadIdx.x < a) {
    const int i = threadIdx.x;
    const float *q = par + P_ASSETS + 4 * i;
    as.S0[i] = q[0];
    as.drift[i] = q[1];
    as.voldt[i] = q[2];
    as.w[i] = q[3];
    const float *row = par + P_ASSETS + 4 * a + i * a;
    for (int j = 0; j <= i; ++j) as.L[i * (i + 1) / 2 + j] = row[j];
  }
  __syncthreads();

  float acc[NSTAT], comp[NSTAT];
#pragma unroll
  for (int k = 0; k < NSTAT; ++k) acc[k] = comp[k] = 0.0f;

  for (int c = 0; c < reps; ++c) {
    Leg<MAXA> gp, gm;
    init_leg(gp, as, a, par[P_CROSSED0]);
    if (ANTI) init_leg(gm, as, a, par[P_CROSSED0]);
    for (int t = 0; t < n_steps; ++t) {
      const uint32_t d0 = static_cast<uint32_t>((c * n_steps + t) * n_pairs);
      float x[MAXA];
#pragma unroll
      for (int k = 0; k < MAXA / 2; ++k)
        if (k < n_pairs)
          normals(key0, key1, ctr0, d0 + k, x[2 * k], x[2 * k + 1]);
      // correlate in place, last asset first: x_i = sum_{j<=i} L_ij z_j
      // reads only z_j, j <= i; the sum runs in the TPU kernel's order
#pragma unroll
      for (int i = MAXA - 1; i >= 0; --i) {
        if (i < a) {
          const float *Li = as.L + i * (i + 1) / 2;
          float s = Li[0] * x[0];
#pragma unroll
          for (int j = 1; j <= i; ++j) s = s + Li[j] * x[j];
          x[i] = s;
        }
      }
      advance<PAYOFF>(gp, x, 1.0f, as, a, up, barrier);
      if (ANTI) advance<PAYOFF>(gm, x, -1.0f, as, a, up, barrier);
    }
    float X, Y;
    payoff_of<PAYOFF>(gp, as, a, par, nsf, knock_in, X, Y);
    if (ANTI) {
      // (f(z) + f(-z)) / 2 is ONE observation
      float Xm, Ym;
      payoff_of<PAYOFF>(gm, as, a, par, nsf, knock_in, Xm, Ym);
      X = 0.5f * (X + Xm);
      Y = 0.5f * (Y + Ym);
    }
    // the TPU kernel's f32 tail mask
    const float prog_offset =
        (static_cast<float>(pid) * static_cast<float>(reps) +
         static_cast<float>(c)) * static_cast<float>(TILE);
    const float wgt =
        static_cast<float>(elem) < n_paths - prog_offset ? 1.0f : 0.0f;
    const float WX = X * wgt, WY = Y * wgt;
    const float s[NSTAT] = {wgt, WX, WX * X, WY, WY * Y, WX * Y};
    kahan_step<NSTAT>(acc, comp, s);
  }
  float *row = block_rows + static_cast<size_t>(blockIdx.x) * ROW;
  block_row<NSTAT, THREADS>(acc, row);
}

struct Launch {
  const int *seed;
  const float *par;
  int a, reps, n_steps, flags;
  float *block_rows;
  int blocks;
  cudaStream_t stream;
};

template <int PAYOFF, int MAXA>
cudaError_t launch_anti(bool anti, const Launch &l) {
  if (anti)
    basket_mc_kernel<PAYOFF, true, MAXA><<<l.blocks, THREADS, 0, l.stream>>>(
        l.seed, l.par, l.a, l.reps, l.n_steps, l.flags, l.block_rows);
  else
    basket_mc_kernel<PAYOFF, false, MAXA><<<l.blocks, THREADS, 0, l.stream>>>(
        l.seed, l.par, l.a, l.reps, l.n_steps, l.flags, l.block_rows);
  return cudaGetLastError();
}

// the asset bucket: the smallest of 4, 8, 16 that holds a
template <int PAYOFF>
cudaError_t launch_bucket(bool anti, const Launch &l) {
  if (l.a <= 4) return launch_anti<PAYOFF, 4>(anti, l);
  if (l.a <= 8) return launch_anti<PAYOFF, 8>(anti, l);
  return launch_anti<PAYOFF, MAX_ASSETS>(anti, l);
}

cudaError_t launch(int payoff, bool anti, const Launch &l) {
  switch (payoff) {
    case ASIAN_BASKET: return launch_bucket<ASIAN_BASKET>(anti, l);
    case WORSTOF_BARRIER: return launch_bucket<WORSTOF_BARRIER>(anti, l);
    case BASKET_BARRIER: return launch_bucket<BASKET_BARRIER>(anti, l);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace
}  // namespace optpricer

using namespace optpricer;

// Basket path sums. par: f32[7 + 4a + a^2]; block_rows: f32[n_programs *
// 32, 8] scratch; prog_rows: f32[n_programs, 8] scratch; out: f32[8], stats
// in [0, 6).
extern "C" int optpricer_basket_mc(const void *seed, const void *par,
                                   void *block_rows, void *prog_rows,
                                   void *out, int n_programs, int reps,
                                   int n_assets, int n_steps, int payoff,
                                   int flags, int antithetic, void *stream) {
  if (n_assets < 1 || n_assets > MAX_ASSETS || n_steps < 1 || reps < 1 ||
      n_programs < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float *br = static_cast<float *>(block_rows);
  const Launch l{static_cast<const int *>(seed),
                 static_cast<const float *>(par),
                 n_assets, reps, n_steps, flags, br,
                 n_programs * BLOCKS_PER_PROGRAM, s};
  cudaError_t err = launch(payoff, antithetic != 0, l);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = combine<NSTAT, ROW>(br, BLOCKS_PER_PROGRAM, n_programs,
                            static_cast<float *>(prog_rows), s);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(combine<NSTAT, ROW>(
      static_cast<const float *>(prog_rows), n_programs, 1,
      static_cast<float *>(out), s));
}
