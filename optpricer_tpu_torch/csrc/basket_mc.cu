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
//   rep, element) path pair: the grid is n_programs x reps x 32 blocks of
//   128 threads, and each block writes one stats row. The first combine pass
//   (csrc/reduce.cuh) Kahan-sums a program's reps x 32 rows in (rep, block)
//   order, the second the program rows in order. No atomics: one seed gives
//   bitwise-identical stats on every run, and at one rep the same bits as a
//   thread that Kahan-sums its reps.
// * The asset count is a template parameter: every count from 1 to
//   MAX_ASSETS has its own instantiation, so the spots of both legs, the
//   running basket sum and the barrier flags sit in exactly a registers a
//   leg, and every loop over the assets is unrolled with no runtime guard.
// * The per-asset scalars (S0, drift, voldt, w) and the a(a+1)/2 Cholesky
//   entries come in a kernel-parameter struct (BasketParams, __grid_constant__,
//   packed on the host by ops/basket_mc._pack_params). Indexed only with
//   compile-time indices, each reaches its FMUL/FADD from the constant bank
//   (ptxas loads pairs of them into uniform registers, ULDC.64, shared by
//   the warp): no shared-memory stage, no barrier, no per-thread load or
//   register holds them.
// * The - leg's correlated shocks are -x_i: negation is exact in IEEE
//   arithmetic, so L(-z) = -(Lz) bit for bit and the chain runs once.
// * Each instantiation is compiled for the resident blocks an SM that its
//   registers allow with no spill (MIN_BLOCKS, __launch_bounds__' second
//   argument); optpricer_basket_mc_occupancy reports what the runtime gets.
//
// What bounds it: integer and SFU issue. A step costs ceil(a/2)
// Threefry-2x32-20 blocks and Box-Muller pairs (a log32, a sqrt and one
// sincosf each), a(a+1)/2 multiply-adds for the correlation and, per leg, a
// exp32 and a multiply-adds for the basket; device memory sees only the
// seed and the 8-float row each block writes. The payoff, antithetic
// sampling and the asset count are template parameters; the barrier
// direction and in/out are warp-uniform runtime flags.
//
// Rounding. The file is built without FMA contraction (-fmad=false, see
// _build.py) and the Box-Muller angle is the f32 product 2*pi*u2, as in the
// TPU kernel; its one sincosf returns the bits of cosf and sinf on every
// angle 2*pi*u2 can take (tests/test_torch_cuda.py). Every per-path
// operation rounds as in the plain torch version
// (ops/basket_mc.py:_basket_mc_plain), so a barrier indicator flips in
// neither or both. The Asian average run_sum / n_steps is a true f32
// division. The tail mask is the TPU kernel's f32 compare, elem < n_paths -
// (pid * reps + c) * TILE.

#include <cuda_runtime.h>

#include <cstdint>
#include <cstring>

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

// Resident blocks of 128 threads per SM that the instantiation for a
// assets is compiled for (index a; ptxas caps the registers at 65 536 /
// (128 x MIN_BLOCKS[a]), in steps of 8): the most, of 5-8, 10 and 12, at
// which ptxas spills nothing for any payoff, antithetic or not. Without a
// budget the antithetic instantiations take 32-120 registers (94 at 10
// assets, 120 at 16).
constexpr int MIN_BLOCKS[MAX_ASSETS + 1] = {0,  12, 12, 12, 12, 12, 12, 10, 8,
                                            8,  8,  8,  8,  8,  7,  7,  7};

enum Payoff { ASIAN_BASKET = 0, WORSTOF_BARRIER = 1, BASKET_BARRIER = 2 };
enum Flag { BARRIER_UP = 1, KNOCK_IN = 2 };

// The kernel's parameters, packed by ops/basket_mc._pack_params from the
// f32 params of _build_params: its 7 scalars and a pad word, the per-asset
// rows, and the lower triangle of the Cholesky factor, row i at i(i+1)/2.
struct BasketParams {
  float K, df, n_paths, sign, barrier, rebate, crossed0, pad;
  float S0[MAX_ASSETS];
  float drift[MAX_ASSETS];  // (r - q - sigma^2/2) dt
  float voldt[MAX_ASSETS];  // sigma sqrt(dt)
  float w[MAX_ASSETS];
  float L[MAX_CHOL];
};
constexpr int PARAM_WORDS = 8 + 4 * MAX_ASSETS + MAX_CHOL;
static_assert(sizeof(BasketParams) == 4 * PARAM_WORDS, "packed words");

__device__ __forceinline__ void normals(uint32_t key0, uint32_t key1,
                                        uint32_t elem, uint32_t draw,
                                        float &z1, float &z2) {
  uint32_t a, b;
  threefry2x32(key0, key1, elem, draw, a, b);
  const float u1 = (static_cast<float>(a >> 8) + 0.5f) * TINY;
  const float u2 = static_cast<float>(b >> 8) * TINY;
  const float rad = sqrtf(-2.0f * log32(u1));
  const float theta = TWO_PI * u2;
  float s, c;
  sincosf(theta, &s, &c);
  z1 = rad * c;
  z2 = rad * s;
}

template <int A>
struct Leg {
  float S[A];
  float run_sum, crossed;
};

template <int A>
__device__ __forceinline__ void init_leg(Leg<A> &g, const BasketParams &p) {
#pragma unroll
  for (int i = 0; i < A; ++i) g.S[i] = p.S0[i];
  g.run_sum = 0.0f;
  g.crossed = p.crossed0;
}

template <int A>
__device__ __forceinline__ float basket(const Leg<A> &g,
                                        const BasketParams &p) {
  float B = p.w[0] * g.S[0];
#pragma unroll
  for (int i = 1; i < A; ++i) B = B + p.w[i] * g.S[i];
  return B;
}

template <int A>
__device__ __forceinline__ float worst(const Leg<A> &g) {
  float m = g.S[0];
#pragma unroll
  for (int i = 1; i < A; ++i) m = fminf(m, g.S[i]);
  return m;
}

// One time step of a leg under the correlated shocks x (sgn = -1 for the
// mirrored leg).
template <int PAYOFF, int A>
__device__ __forceinline__ void advance(Leg<A> &g, const float *x, float sgn,
                                        const BasketParams &p, bool up) {
#pragma unroll
  for (int i = 0; i < A; ++i)
    g.S[i] = g.S[i] * exp32(p.drift[i] + p.voldt[i] * (sgn * x[i]));
  const float B = basket(g, p);
  if (PAYOFF == ASIAN_BASKET) {
    g.run_sum = g.run_sum + B;
  } else {
    const float lvl = PAYOFF == WORSTOF_BARRIER ? worst(g) : B;
    const bool hit = up ? lvl >= p.barrier : lvl <= p.barrier;
    g.crossed = fmaxf(g.crossed, hit ? 1.0f : 0.0f);
  }
}

// (X, Y) = (e^{-rT} payoff, e^{-rT} B_T) of one leg.
template <int PAYOFF, int A>
__device__ __forceinline__ void payoff_of(const Leg<A> &g,
                                          const BasketParams &p, float nsf,
                                          bool knock_in, float &X, float &Y) {
  const float B_T = basket(g, p);
  float pay;
  if (PAYOFF == ASIAN_BASKET) {
    pay = fmaxf(p.sign * (g.run_sum / nsf - p.K), 0.0f);
  } else {
    const float term = PAYOFF == WORSTOF_BARRIER ? worst(g) : B_T;
    const float live = fmaxf(p.sign * (term - p.K), 0.0f);
    const bool hit = g.crossed > 0.5f;
    pay = hit ? (knock_in ? live : p.rebate) : (knock_in ? p.rebate : live);
  }
  X = p.df * pay;
  Y = p.df * B_T;
}

template <int PAYOFF, bool ANTI, int A>
__global__ void __launch_bounds__(THREADS, (MIN_BLOCKS[A]))
basket_mc_kernel(const int *seed, const __grid_constant__ BasketParams p,
                 int reps, int n_steps, int flags, float *block_rows) {
  constexpr int NP = (A + 1) / 2;  // Box-Muller pairs a step
  // block = (program * reps + rep) * BLOCKS_PER_PROGRAM + block in tile
  const int pc = blockIdx.x / BLOCKS_PER_PROGRAM;
  const int local_pid = pc / reps, c = pc % reps;
  const int elem = (blockIdx.x % BLOCKS_PER_PROGRAM) * THREADS + threadIdx.x;
  // global program id: the stream key, whatever slice of the grid runs here
  const int pid = local_pid + seed[1];
  const uint32_t key0 = static_cast<uint32_t>(seed[0]);
  const uint32_t key1 = static_cast<uint32_t>(pid);
  const uint32_t ctr0 = static_cast<uint32_t>(elem);
  const bool up = flags & BARRIER_UP;
  const bool knock_in = flags & KNOCK_IN;
  const float nsf = static_cast<float>(n_steps);

  Leg<A> gp, gm;
  init_leg(gp, p);
  if (ANTI) init_leg(gm, p);
  for (int t = 0; t < n_steps; ++t) {
    const uint32_t d0 = static_cast<uint32_t>((c * n_steps + t) * NP);
    float x[2 * NP];
#pragma unroll
    for (int k = 0; k < NP; ++k)
      normals(key0, key1, ctr0, d0 + k, x[2 * k], x[2 * k + 1]);
    // correlate in place, last asset first: x_i = sum_{j<=i} L_ij z_j
    // reads only z_j, j <= i; the sum runs in the TPU kernel's order
#pragma unroll
    for (int i = A - 1; i >= 0; --i) {
      const int row = i * (i + 1) / 2;
      float s = p.L[row] * x[0];
#pragma unroll
      for (int j = 1; j <= i; ++j) s = s + p.L[row + j] * x[j];
      x[i] = s;
    }
    advance<PAYOFF>(gp, x, 1.0f, p, up);
    if (ANTI) advance<PAYOFF>(gm, x, -1.0f, p, up);
  }
  float X, Y;
  payoff_of<PAYOFF>(gp, p, nsf, knock_in, X, Y);
  if (ANTI) {
    // (f(z) + f(-z)) / 2 is ONE observation
    float Xm, Ym;
    payoff_of<PAYOFF>(gm, p, nsf, knock_in, Xm, Ym);
    X = 0.5f * (X + Xm);
    Y = 0.5f * (Y + Ym);
  }
  // the TPU kernel's f32 tail mask
  const float prog_offset =
      (static_cast<float>(pid) * static_cast<float>(reps) +
       static_cast<float>(c)) * static_cast<float>(TILE);
  const float wgt =
      static_cast<float>(elem) < p.n_paths - prog_offset ? 1.0f : 0.0f;
  const float WX = X * wgt, WY = Y * wgt;
  // 0 + s, as a Kahan step from zero forms it (a -0 becomes +0)
  const float s[NSTAT] = {0.0f + wgt,    0.0f + WX,     0.0f + WX * X,
                          0.0f + WY,     0.0f + WY * Y, 0.0f + WX * Y};
  block_row<NSTAT, THREADS>(s, block_rows +
                                   static_cast<size_t>(blockIdx.x) * ROW);
}

struct Launch {
  const int *seed;
  const BasketParams *par;  // host struct, passed by value
  int a, reps, n_steps, flags;
  float *block_rows;
  int blocks;
  cudaStream_t stream;
  int *occupancy;  // set: report the instantiation's resident blocks per SM
};

template <int PAYOFF, bool ANTI, int A>
cudaError_t run(const Launch &l) {
  auto kernel = basket_mc_kernel<PAYOFF, ANTI, A>;
  if (l.occupancy != nullptr)
    return cudaOccupancyMaxActiveBlocksPerMultiprocessor(l.occupancy, kernel,
                                                         THREADS, 0);
  kernel<<<l.blocks, THREADS, 0, l.stream>>>(l.seed, *l.par, l.reps,
                                             l.n_steps, l.flags,
                                             l.block_rows);
  return cudaGetLastError();
}

// the instantiation for exactly l.a assets
template <int PAYOFF, bool ANTI, int A = 1>
cudaError_t launch_assets(const Launch &l) {
  if constexpr (A < MAX_ASSETS) {
    if (l.a != A) return launch_assets<PAYOFF, ANTI, A + 1>(l);
  }
  return run<PAYOFF, ANTI, A>(l);
}

cudaError_t launch(int payoff, bool anti, const Launch &l) {
  switch (payoff) {
    case ASIAN_BASKET:
      return anti ? launch_assets<ASIAN_BASKET, true>(l)
                  : launch_assets<ASIAN_BASKET, false>(l);
    case WORSTOF_BARRIER:
      return anti ? launch_assets<WORSTOF_BARRIER, true>(l)
                  : launch_assets<WORSTOF_BARRIER, false>(l);
    case BASKET_BARRIER:
      return anti ? launch_assets<BASKET_BARRIER, true>(l)
                  : launch_assets<BASKET_BARRIER, false>(l);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace
}  // namespace optpricer

using namespace optpricer;

// Basket path sums. host_params: f32[PARAM_WORDS] in host memory, the
// BasketParams words (ops/basket_mc._pack_params); block_rows:
// f32[n_programs * reps * 32, 8] scratch; prog_rows: f32[n_programs, 8]
// scratch; out: f32[8], stats in [0, 6).
extern "C" int optpricer_basket_mc(const void *seed, const void *host_params,
                                   void *block_rows, void *prog_rows,
                                   void *out, int n_programs, int reps,
                                   int n_assets, int n_steps, int payoff,
                                   int flags, int antithetic, void *stream) {
  if (n_assets < 1 || n_assets > MAX_ASSETS || n_steps < 1 || reps < 1 ||
      n_programs < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  BasketParams par;
  std::memcpy(&par, host_params, sizeof(par));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float *br = static_cast<float *>(block_rows);
  // block rows per program: reps x 32, in (rep, block) order
  const int rows = reps * BLOCKS_PER_PROGRAM;
  const Launch l{static_cast<const int *>(seed), &par, n_assets, reps,
                 n_steps, flags, br, n_programs * rows, s, nullptr};
  cudaError_t err = launch(payoff, antithetic != 0, l);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = combine<NSTAT, ROW>(br, rows, n_programs,
                            static_cast<float *>(prog_rows), s);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(combine<NSTAT, ROW>(
      static_cast<const float *>(prog_rows), n_programs, 1,
      static_cast<float *>(out), s));
}

// Resident blocks per SM (cudaOccupancyMaxActiveBlocksPerMultiprocessor) of
// the instantiation that optpricer_basket_mc launches for these arguments,
// written to *blocks_per_sm (an int).
extern "C" int optpricer_basket_mc_occupancy(int n_assets, int payoff,
                                             int antithetic,
                                             void *blocks_per_sm) {
  if (n_assets < 1 || n_assets > MAX_ASSETS)
    return static_cast<int>(cudaErrorInvalidValue);
  Launch l{};
  l.a = n_assets;
  l.occupancy = static_cast<int *>(blocks_per_sm);
  return static_cast<int>(launch(payoff, antithetic != 0, l));
}
