// The whole local-vol theta-scheme march of a strike ladder (K8), with a
// plain C interface (bound with ctypes by optpricer_tpu_torch/ops/fd_lv.py,
// built by optpricer_tpu_torch/_build.py with -fmad=false).
//
// fd_lv_pcr_kernel and fd_lv_thomas_kernel replace
// optpricer_tpu/ops/pallas_fd_lv.py:_fd_lv_kernel (method "pcr" and
// "thomas"). Per time step, for every strike: sigma(S, t_n) from the
// (n_t, m_pad) table, the operator diagonals aL = alpha - beta,
// cL = alpha + beta, bL = -(aL + cL) - r, the rhs (I + (1-theta)dt L) V with
// the Dirichlet transfer of both boundaries, the implicit solve, and the
// optional American projection.
//
// Arithmetic: the TPU kernel's f32 operations in its order, each rounded
// on its own (-fmad=false), so the plain torch version (ops/fd_lv.py
// _fd_lv_plain) rounds alike: interior nodes x = x_min + (row+1) dx and
// S = exp32(x), the boundary discount through exp32, S_min and S_max
// through expf, tau = (n_t - n) dt, PCR normalised by the diagonal first
// (rb0) and then one reciprocal per level, Thomas one reciprocal per row.
// Rows m..m_pad-1 are identity equations that solve to 0.
//
// Everything that depends on the step and the row but not on the strike
// is computed once per launch by fd_lv_plan_kernel (one block per step)
// into a plan of PLAN_WORDS floats per (step, row), in march order:
//   f1 = 1 + e bL, e aL, e cL, (td aL) [row 0], (td cL) [row m-1], then
//   PCR:    rb0 = 1 / (1 + td (aL + cL + r)), a and c of level 0;
//   Thomas: c' (0 on the last row, as the back substitution takes it),
//           a_lhs, rcp = 1 / (b_lhs - a_lhs c'_prev), the rows walked by
//           one thread per step;
// then exp32(-r tau) per step (n_t + 1 words, tau = 0 first) and
// S = exp32(x) per row (m_pad words). A value computed once from the same
// operands in the same order is the same float as one computed per strike,
// so the march gives the per-strike kernel's V bit for bit.
//
// * PCR: PCR_STRIKES strikes a block, one thread per grid row
//   (m_pad <= 1024). Per level each thread forms its row's a, c and
//   reciprocal once and updates the d of every strike of the block; one
//   __syncthreads per level serves them all. The layers and the strikes'
//   d live in shared memory with a row's strikes side by side (float4
//   loads), a and c beside them, double-buffered. Where the TPU roll
//   wrapped around and multiplied the garbage by an exact zero (a_i = 0
//   for i < 2^k, c_i = 0 for i >= m_pad - 2^k), an index outside
//   [0, m_pad) reads 0 here: the same result.
// * Thomas: THOMAS_STRIKES strikes a block of THOMAS_THREADS, so a ladder
//   of 1 024 strikes holds 128 SMs. All threads form the rhs of every row
//   and the American projection; one lane a strike runs the forward
//   substitution d' = (d - a_lhs d'_prev) rcp and the back substitution
//   x = d' - c' x, with the factor read from the plan. Shared memory holds
//   the strikes' layer and d columns, S, and the plan of this step and the
//   next (cp.async copies the next while this one is marched); above
//   THOMAS_SMEM_ROWS rows the plan is read from device memory and the
//   columns are the output and an (m_pad, B) scratch. The substitutions
//   take CHUNK rows at a time, their loads issued before the chain.
//
// What bounds them: neither the card's rate nor its bytes (the least work
// is ~10 float operations per strike, row and step, 0.04 ms at the
// ladder), but dependent latency. PCR: ten barriers a step, each level a
// division and shared-memory round trips on the critical path; 8 strikes
// a block amortise them over 8 strikes (4 measured slower). Thomas: the
// substitutions are a chain of three dependent float operations per row
// forward and two back, per strike, over m_pad x n_t rows, so one warp's
// latency, not the card's rate, sets its floor (~20 cycles a row pair,
// ~2.7 ms at the ladder at 1.98 GHz); spreading the strikes over 128 SMs
// and the rhs over four warps keeps the rest off that chain.

#include <cuda_runtime.h>

#include "fastmath.cuh"

namespace optpricer {
namespace {

constexpr int PCR_STRIKES = 8;      // strikes a PCR block
constexpr int THOMAS_STRIKES = 8;   // strikes a Thomas block
constexpr int THOMAS_THREADS = 128;  // threads (four warps) a Thomas block
constexpr int PLAN_WORDS = 8;       // plan floats per (step, row)
constexpr int PLAN_THREADS = 256;   // threads (rows at a time) a plan block
constexpr int CHUNK = 8;            // Thomas rows per batch of loads
constexpr int MAX_SMEM = 232448;    // dynamic shared memory a block may use
constexpr int STATIC_SMEM = 49152;  // above this, opt in per kernel
// Thomas keeps its plan, columns and S in shared memory up to this many
// rows: 2 x 2 float4 plan words, 2 x THOMAS_STRIKES column words and S a row
constexpr int THOMAS_ROW_WORDS = 16 + 2 * THOMAS_STRIKES + 1;
constexpr int THOMAS_SMEM_ROWS =
    MAX_SMEM / (THOMAS_ROW_WORDS * static_cast<int>(sizeof(float)));

struct Params {
  float x_min, dx, dt, r, q;
};

__device__ __forceinline__ Params load_params(const float *par) {
  return Params{par[0], par[1], par[2], par[3], par[4]};
}

// (left, right) Dirichlet values; disc = exp32(-r tau) from the plan
__device__ __forceinline__ void bc_pair(float K, bool is_call, float disc,
                                        float S_min, float S_max, float &left,
                                        float &right) {
  const float disc_K = K * disc;
  left = is_call ? 0.0f : fmaxf(disc_K - S_min, 0.0f);
  right = is_call ? fmaxf(S_max - disc_K, 0.0f) : 0.0f;
}

// One block per march step i (sigma column n = n_t - 1 - i): the plan's
// words of every row, PLAN_THREADS rows at a time, and for Thomas the
// factorisation walked by thread 0 over each batch of rows.
template <bool THOMAS>
__global__ void __launch_bounds__(PLAN_THREADS)
fd_lv_plan_kernel(const float *__restrict__ par,
                  const float *__restrict__ sig, float4 *__restrict__ plan,
                  float *__restrict__ disc, float *__restrict__ S_row,
                  int n_t, int m, int m_pad, float one_m_theta, float theta) {
  __shared__ float s_a[PLAN_THREADS], s_b[PLAN_THREADS], s_c[PLAN_THREADS];
  const int i = blockIdx.x;
  const int t = threadIdx.x;
  const int n_i = (n_t - 1) - i;
  const Params p = load_params(par);
  const float e = one_m_theta * p.dt;
  const float td = theta * p.dt;
  if (t == 0) {
    const float n = static_cast<float>(n_t - 1) - static_cast<float>(i);
    const float tau = (static_cast<float>(n_t) - n) * p.dt;
    disc[i + 1] = exp32(-p.r * tau);
    if (i == 0) disc[0] = exp32(-p.r * 0.0f);
  }
  float cp_prev = 0.0f;  // thread 0's c' carried across batches
  for (int base = 0; base < m_pad; base += PLAN_THREADS) {
    const int row = base + t;
    float tCL = 0.0f;
    if (row < m_pad) {
      if (i == 0)
        S_row[row] = exp32(p.x_min + (static_cast<float>(row) + 1.0f) * p.dx);
      const float interior = row < m ? 1.0f : 0.0f;
      const float row0 = row == 0 ? 1.0f : 0.0f;
      const float rowL = row == m - 1 ? 1.0f : 0.0f;
      const float s = sig[static_cast<long long>(n_i) * m_pad + row];
      const float alpha = 0.5f * s * s / (p.dx * p.dx);
      const float beta = (p.r - p.q - 0.5f * s * s) / (2.0f * p.dx);
      const float AL = (alpha - beta) * interior;
      const float CL = (alpha + beta) * interior;
      const float bL = -(AL + CL) - p.r * interior;
      const float b_lhs = 1.0f + td * (AL + CL + p.r * interior);
      float4 *out = plan + 2 * (static_cast<long long>(i) * m_pad + row);
      out[0] = make_float4(1.0f + e * bL, e * AL, e * CL, td * AL * row0);
      tCL = td * CL * rowL;
      if (THOMAS) {
        s_a[t] = row == 0 ? 0.0f : -td * AL;
        s_b[t] = b_lhs;
        s_c[t] = -td * CL;
      } else {
        const float not0 = row != 0 ? 1.0f : 0.0f;
        const float notL = row != m - 1 ? 1.0f : 0.0f;
        const float rb0 = 1.0f / b_lhs;
        out[1] = make_float4(tCL, rb0, -td * AL * not0 * rb0,
                             -td * CL * notL * rb0);
      }
    }
    if (THOMAS) {
      __syncthreads();
      if (t == 0) {
        const int rows = min(PLAN_THREADS, m_pad - base);
        for (int k = 0; k < rows; ++k) {
          const float rcp = 1.0f / (s_b[k] - s_a[k] * cp_prev);
          cp_prev = s_c[k] * rcp;
          s_b[k] = rcp;
          s_c[k] = base + k == m_pad - 1 ? 0.0f : cp_prev;
        }
      }
      __syncthreads();
      if (row < m_pad)
        plan[2 * (static_cast<long long>(i) * m_pad + row) + 1] =
            make_float4(tCL, s_c[t], s_a[t], s_b[t]);
      __syncthreads();
    }
  }
}

// The strikes' values of grid row r, interleaved by strike (Q float4 a row).
template <int G>
__device__ __forceinline__ void load_row(const float4 *base, int r,
                                         float (&out)[G]) {
#pragma unroll
  for (int q = 0; q < G / 4; ++q) {
    const float4 w = base[r * (G / 4) + q];
    out[4 * q] = w.x;
    out[4 * q + 1] = w.y;
    out[4 * q + 2] = w.z;
    out[4 * q + 3] = w.w;
  }
}

template <int G>
__device__ __forceinline__ void store_row(float4 *base, int r,
                                          const float (&in)[G]) {
#pragma unroll
  for (int q = 0; q < G / 4; ++q)
    base[r * (G / 4) + q] =
        make_float4(in[4 * q], in[4 * q + 1], in[4 * q + 2], in[4 * q + 3]);
}

template <bool AMERICAN>
__global__ void __launch_bounds__(1024)
fd_lv_pcr_kernel(const float *__restrict__ par,
                 const float *__restrict__ Ks,
                 const float *__restrict__ sign,
                 const float4 *__restrict__ plan,
                 const float *__restrict__ disc,
                 const float *__restrict__ S_row, float *__restrict__ V_out,
                 int n_t, int m, int m_pad, int n_strikes) {
  constexpr int G = PCR_STRIKES;
  static_assert(G % 4 == 0, "a row of strikes is whole float4s");
  extern __shared__ float4 smq[];
  // the previous layers (m_pad rows of G), the strikes' d of a level
  // (double-buffered), then a and c of a level (double-buffered)
  float4 *Vs = smq;
  float4 *Ds = smq + (G / 4) * m_pad;
  float *As = reinterpret_cast<float *>(smq + 3 * (G / 4) * m_pad);
  float *Cs = As + 2 * m_pad;

  const int row = threadIdx.x;
  const int b0 = blockIdx.x * G;
  const Params p = load_params(par);
  const float interior = row < m ? 1.0f : 0.0f;
  const float S = S_row[row];
  const float S_min = expf(p.x_min);
  const float S_max = expf(p.x_min + static_cast<float>(m + 1) * p.dx);

  // per strike: K, sign and the layer, then d (the last block's extra
  // strikes repeat the last strike and are not written)
  float K[G], sg[G], v[G];
#pragma unroll
  for (int g = 0; g < G; ++g) {
    const int b = min(b0 + g, n_strikes - 1);
    K[g] = Ks[b];
    sg[g] = sign[b];
    v[g] = fmaxf(sg[g] * (S - K[g]), 0.0f) * interior;
  }

  for (int i = 0; i < n_t; ++i) {
    const float4 lo = plan[2 * (static_cast<long long>(i) * m_pad + row)];
    const float4 hi = plan[2 * (static_cast<long long>(i) * m_pad + row) + 1];
    const float dsc_old = disc[i];
    const float dsc = disc[i + 1];
    store_row<G>(Vs, row, v);
    __syncthreads();
    float vm[G], vp[G];
#pragma unroll
    for (int g = 0; g < G; ++g) vm[g] = vp[g] = 0.0f;
    if (row > 0) load_row<G>(Vs, row - 1, vm);
    if (row + 1 < m_pad) load_row<G>(Vs, row + 1, vp);
#pragma unroll
    for (int g = 0; g < G; ++g) {
      const bool is_call = sg[g] > 0.0f;
      float bl_old, br_old, bl_new, br_new;
      bc_pair(K[g], is_call, dsc_old, S_min, S_max, bl_old, br_old);
      bc_pair(K[g], is_call, dsc, S_min, S_max, bl_new, br_new);
      const float vm1 = row == 0 ? bl_old : vm[g];
      const float vp1 = row == m - 1 ? br_old : vp[g];
      const float d = lo.x * v[g] + lo.y * vm1 + lo.z * vp1 + lo.w * bl_new +
                      hi.x * br_new;
      v[g] = d * hi.y;  // v now holds the strike's d
    }
    // diagonal-normalised PCR: a, c and the reciprocal once per row
    float a = hi.z, c = hi.w;
    int cur = 0;
    As[row] = a;
    Cs[row] = c;
    store_row<G>(Ds, row, v);
    __syncthreads();
    for (int sft = 1; sft < m_pad; sft <<= 1) {
      const float *A = As + cur * m_pad;
      const float *C = Cs + cur * m_pad;
      const float4 *D = Ds + cur * (G / 4) * m_pad;
      const bool lo_ok = row >= sft;
      const bool hi_ok = row + sft < m_pad;
      const float am = lo_ok ? A[row - sft] : 0.0f;
      const float cm = lo_ok ? C[row - sft] : 0.0f;
      const float ap = hi_ok ? A[row + sft] : 0.0f;
      const float cpv = hi_ok ? C[row + sft] : 0.0f;
      float dm[G], dp[G];
#pragma unroll
      for (int g = 0; g < G; ++g) dm[g] = dp[g] = 0.0f;
      if (lo_ok) load_row<G>(D, row - sft, dm);
      if (hi_ok) load_row<G>(D, row + sft, dp);
      const float rcp = 1.0f / (1.0f - a * cm - c * ap);
#pragma unroll
      for (int g = 0; g < G; ++g) v[g] = rcp * (v[g] - a * dm[g] - c * dp[g]);
      a = -rcp * a * am;
      c = -rcp * c * cpv;
      if ((sft << 1) >= m_pad) break;  // the last level: nothing reads it
      cur ^= 1;
      As[cur * m_pad + row] = a;
      Cs[cur * m_pad + row] = c;
      store_row<G>(Ds + cur * (G / 4) * m_pad, row, v);
      __syncthreads();
    }
    if (AMERICAN) {
#pragma unroll
      for (int g = 0; g < G; ++g)
        v[g] = fmaxf(v[g], fmaxf(sg[g] * (S - K[g]), 0.0f) * interior);
    }
  }
#pragma unroll
  for (int g = 0; g < G; ++g)
    if (b0 + g < n_strikes)
      V_out[static_cast<long long>(row) * n_strikes + b0 + g] = v[g];
}

// 16-byte asynchronous copy from device memory into shared memory
// (cp.async), its commit and the wait for every copy in flight.
__device__ __forceinline__ void copy16_async(void *dst, const void *src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(src));
}
__device__ __forceinline__ void copy_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
__device__ __forceinline__ void copy_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// THOMAS_STRIKES strikes a block of THOMAS_THREADS. Thread l works on
// strike l % THOMAS_STRIKES: all threads form the rhs of every row (ROWS
// rows at a time) and the American projection; threads
// 0..THOMAS_STRIKES-1 run their strike's forward and back substitutions,
// the dependent chain.
// SMEM: shared memory holds the plan of this step and the next (the next
// copied by cp.async while this one is marched), the layer and d columns
// (rows interleaved by strike) and S; otherwise the plan is read from
// device memory, the layer is V_out's columns and d the scratch's, both
// (m_pad, B).
template <bool AMERICAN, bool SMEM>
__global__ void __launch_bounds__(THOMAS_THREADS)
fd_lv_thomas_kernel(const float *__restrict__ par,
                    const float *__restrict__ Ks,
                    const float *__restrict__ sign,
                    const float4 *__restrict__ plan,
                    const float *__restrict__ disc,
                    const float *__restrict__ S_row, float *__restrict__ V_out,
                    float *__restrict__ scratch, int n_t, int m, int m_pad,
                    int n_strikes) {
  constexpr int G = THOMAS_STRIKES;
  constexpr int ROWS = THOMAS_THREADS / G;
  extern __shared__ float4 sm4[];
  const int l = threadIdx.x;
  const int g = l % G;
  const int b0 = blockIdx.x * G;
  const bool active = b0 + g < n_strikes;
  const bool chain = l < G && active;
  float4 *stage = sm4;  // 2 x (2 m_pad) plan words
  float *cols = reinterpret_cast<float *>(sm4 + 4 * m_pad);
  // element (row, strike g) of the layer and of d: V[row * ld + g]
  float *V = SMEM ? cols : V_out + b0;
  float *D = SMEM ? cols + G * m_pad : scratch + b0;
  const float *S = SMEM ? cols + 2 * G * m_pad : S_row;
  const long long ld = SMEM ? G : n_strikes;
  auto stage_step = [&](int i) {  // step i's plan into buffer i & 1
    const float4 *src = plan + 2 * static_cast<long long>(i) * m_pad;
    float4 *dst = stage + (i & 1) * 2 * m_pad;
    for (int k = l; k < 2 * m_pad; k += THOMAS_THREADS)
      copy16_async(dst + k, src + k);
    copy_commit();
  };
  if (SMEM) {
    stage_step(0);
    for (int row = l; row < m_pad; row += THOMAS_THREADS)
      cols[2 * G * m_pad + row] = S_row[row];
    copy_wait_all();
    __syncthreads();
  }

  const Params p = load_params(par);
  const float S_min = expf(p.x_min);
  const float S_max = expf(p.x_min + static_cast<float>(m + 1) * p.dx);
  const float K = Ks[min(b0 + g, n_strikes - 1)];
  const float sg = sign[min(b0 + g, n_strikes - 1)];
  const bool is_call = sg > 0.0f;
  auto intrinsic = [&](int row) {
    return fmaxf(sg * (S[row] - K), 0.0f) * (row < m ? 1.0f : 0.0f);
  };
  const int tail = m_pad % CHUNK;

  if (active)
    for (int row = l / G; row < m_pad; row += ROWS)
      V[row * ld + g] = intrinsic(row);
  __syncthreads();

  for (int i = 0; i < n_t; ++i) {
    if (SMEM && i + 1 < n_t) stage_step(i + 1);
    const float4 *pl =
        SMEM ? stage + (i & 1) * 2 * m_pad
             : plan + 2 * static_cast<long long>(i) * m_pad;
    float bl_old, br_old, bl_new, br_new;
    bc_pair(K, is_call, disc[i], S_min, S_max, bl_old, br_old);
    bc_pair(K, is_call, disc[i + 1], S_min, S_max, bl_new, br_new);

    // the rhs of every row from the previous layer, into d
    if (active)
      for (int row = l / G; row < m_pad; row += ROWS) {
        const float4 lo = pl[2 * row];
        const float4 hi = pl[2 * row + 1];
        const float v0 = V[row * ld + g];
        const float vm1 = row == 0 ? bl_old : V[(row - 1) * ld + g];
        const float vp1 = row == m - 1
                              ? br_old
                              : (row + 1 < m_pad ? V[(row + 1) * ld + g]
                                                 : 0.0f);
        D[row * ld + g] = lo.x * v0 + lo.y * vm1 + lo.z * vp1 +
                          lo.w * bl_new + hi.x * br_new;
      }
    __syncthreads();

    if (chain) {
      // forward: d' = (d - a_lhs d'_prev) rcp, over d
      float dp = 0.0f;
      int row = 0;
      for (; row < m_pad - tail; row += CHUNK) {
        float dq[CHUNK];
        float4 hq[CHUNK];
#pragma unroll
        for (int u = 0; u < CHUNK; ++u) {
          dq[u] = D[(row + u) * ld + g];
          hq[u] = pl[2 * (row + u) + 1];
        }
#pragma unroll
        for (int u = 0; u < CHUNK; ++u) {
          dp = (dq[u] - hq[u].z * dp) * hq[u].w;
          dq[u] = dp;
        }
#pragma unroll
        for (int u = 0; u < CHUNK; ++u) D[(row + u) * ld + g] = dq[u];
      }
      for (; row < m_pad; ++row) {
        const float4 h = pl[2 * row + 1];
        dp = (D[row * ld + g] - h.z * dp) * h.w;
        D[row * ld + g] = dp;
      }
      // back substitution into the layer, unprojected; the tail rows
      // (the top ones) first
      float x = 0.0f;
      for (row = m_pad - 1; row >= m_pad - tail; --row) {
        x = D[row * ld + g] - pl[2 * row + 1].y * x;
        V[row * ld + g] = x;
      }
      for (int top = m_pad - tail; top > 0; top -= CHUNK) {
        float dq[CHUNK], cq[CHUNK];
#pragma unroll
        for (int u = 0; u < CHUNK; ++u) {
          dq[u] = D[(top - 1 - u) * ld + g];
          cq[u] = pl[2 * (top - 1 - u) + 1].y;
        }
#pragma unroll
        for (int u = 0; u < CHUNK; ++u) {
          x = dq[u] - cq[u] * x;
          dq[u] = x;
        }
#pragma unroll
        for (int u = 0; u < CHUNK; ++u) V[(top - 1 - u) * ld + g] = dq[u];
      }
    }
    if (SMEM) copy_wait_all();  // step i + 1's plan in
    __syncthreads();
    if (AMERICAN) {
      if (active)
        for (int row = l / G; row < m_pad; row += ROWS)
          V[row * ld + g] = fmaxf(V[row * ld + g], intrinsic(row));
      __syncthreads();
    }
  }
  if (SMEM && active)
    for (int row = l / G; row < m_pad; row += ROWS)
      V_out[static_cast<long long>(row) * n_strikes + b0 + g] =
          V[row * ld + g];
}

// Launches fd_lv_plan_kernel for the method into plan (see the header).
cudaError_t launch_plan(const float *par, const float *sig, float *plan,
                        int n_t, int m, int m_pad, float one_m_theta,
                        float theta, int method, cudaStream_t s) {
  float4 *pl = reinterpret_cast<float4 *>(plan);
  float *disc = plan + static_cast<long long>(n_t) * m_pad * PLAN_WORDS;
  float *S_row = disc + n_t + 1;
  if (method == 1)
    fd_lv_plan_kernel<true><<<n_t, PLAN_THREADS, 0, s>>>(
        par, sig, pl, disc, S_row, n_t, m, m_pad, one_m_theta, theta);
  else
    fd_lv_plan_kernel<false><<<n_t, PLAN_THREADS, 0, s>>>(
        par, sig, pl, disc, S_row, n_t, m, m_pad, one_m_theta, theta);
  return cudaGetLastError();
}

// Dynamic shared memory above the static limit is opted into per kernel.
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t smem) {
  if (smem <= static_cast<size_t>(STATIC_SMEM)) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(smem));
}

bool valid(int n_t, int m, int m_pad, int n_strikes, int method) {
  return n_t >= 1 && m >= 1 && m_pad >= m && n_strikes >= 1 &&
         (method == 1 || (method == 0 && m_pad <= 1024));
}

}  // namespace
}  // namespace optpricer

using namespace optpricer;

// The plan of one local-vol march alone (fd_lv_plan_kernel). par: f32[6]
// (x_min, dx, dt, r, q, T); sig: f32[n_t, m_pad]; plan: f32[n_t * m_pad *
// 8 + n_t + 1 + m_pad]. method: 0 PCR, 1 Thomas.
extern "C" int optpricer_fd_lv_plan(const void *par, const void *sig,
                                    void *plan, int n_t, int m, int m_pad,
                                    float one_m_theta, float theta,
                                    int method, void *stream) {
  if (!valid(n_t, m, m_pad, 1, method))
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(launch_plan(
      static_cast<const float *>(par), static_cast<const float *>(sig),
      static_cast<float *>(plan), n_t, m, m_pad, one_m_theta, theta, method,
      static_cast<cudaStream_t>(stream)));
}

// One local-vol ladder march: the plan, then the march. K, sign:
// f32[n_strikes]; V_out: f32[m_pad, n_strikes]; plan as above; scratch:
// f32[m_pad, n_strikes] for Thomas above THOMAS_SMEM_ROWS rows, else
// unused.
extern "C" int optpricer_fd_lv(const void *par, const void *K,
                               const void *sign, const void *sig, void *V_out,
                               void *plan, void *scratch, int n_t, int m,
                               int m_pad, int n_strikes, float one_m_theta,
                               float theta, int american, int method,
                               void *stream) {
  if (!valid(n_t, m, m_pad, n_strikes, method))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float *pr = static_cast<const float *>(par);
  const float *k = static_cast<const float *>(K);
  const float *sg = static_cast<const float *>(sign);
  float *pf = static_cast<float *>(plan);
  float *out = static_cast<float *>(V_out);
  cudaError_t err = launch_plan(pr, static_cast<const float *>(sig), pf, n_t,
                                m, m_pad, one_m_theta, theta, method, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  const float4 *pl = reinterpret_cast<const float4 *>(pf);
  const float *disc = pf + static_cast<long long>(n_t) * m_pad * PLAN_WORDS;
  const float *S_row = disc + n_t + 1;
  if (method == 0) {
    const int blocks = (n_strikes + PCR_STRIKES - 1) / PCR_STRIKES;
    const size_t smem =
        static_cast<size_t>(3 * PCR_STRIKES + 4) * m_pad * sizeof(float);
    auto kernel = american ? fd_lv_pcr_kernel<true> : fd_lv_pcr_kernel<false>;
    if ((err = allow_smem(kernel, smem)) != cudaSuccess)
      return static_cast<int>(err);
    kernel<<<blocks, m_pad, smem, s>>>(pr, k, sg, pl, disc, S_row, out, n_t,
                                       m, m_pad, n_strikes);
  } else {
    const int blocks = (n_strikes + THOMAS_STRIKES - 1) / THOMAS_STRIKES;
    const bool in_smem = m_pad <= THOMAS_SMEM_ROWS;
    const size_t smem =
        in_smem ? static_cast<size_t>(THOMAS_ROW_WORDS) * m_pad * sizeof(float)
                : 0;
    auto kernel = american ? (in_smem ? fd_lv_thomas_kernel<true, true>
                                      : fd_lv_thomas_kernel<true, false>)
                           : (in_smem ? fd_lv_thomas_kernel<false, true>
                                      : fd_lv_thomas_kernel<false, false>);
    if ((err = allow_smem(kernel, smem)) != cudaSuccess)
      return static_cast<int>(err);
    kernel<<<blocks, THOMAS_THREADS, smem, s>>>(
        pr, k, sg, pl, disc, S_row, out, static_cast<float *>(scratch), n_t,
        m, m_pad, n_strikes);
  }
  return static_cast<int>(cudaGetLastError());
}
