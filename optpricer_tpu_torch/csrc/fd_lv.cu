// The whole local-vol theta-scheme march of a strike ladder in one kernel
// (K8), with a plain C interface (bound with ctypes by
// optpricer_tpu_torch/ops/fd_lv.py, built by optpricer_tpu_torch/_build.py
// with -fmad=false).
//
// fd_lv_pcr_kernel and fd_lv_thomas_kernel replace
// optpricer_tpu/ops/pallas_fd_lv.py:_fd_lv_kernel (method "pcr" and
// "thomas"). Per time step, for every strike: sigma(S, t_n) from the
// (n_t, m_pad) table, the operator diagonals aL = alpha - beta,
// cL = alpha + beta, bL = -(aL + cL) - r, the rhs (I + (1-theta)dt L) V with
// the Dirichlet transfer of both boundaries, the implicit solve, and the
// optional American projection. Nothing but the final interior values
// reaches device memory in the PCR form; the Thomas form keeps V and c' in
// an (m_pad, B) scratch.
//
// Arithmetic: the TPU kernel's f32 operations in its order, each rounded
// on its own (-fmad=false), so the plain torch version (ops/fd_lv.py
// _fd_lv_plain) rounds alike: interior nodes x = x_min + (row+1) dx and
// S = exp32(x), the boundary discount through exp32, S_min and S_max
// through expf, tau = (n_t - n) dt, PCR normalised by the diagonal first
// (rb0) and then one reciprocal per level, Thomas one reciprocal per row.
// Rows m..m_pad-1 are identity equations that solve to 0.
//
// * PCR: one block per strike, one thread per grid row (m_pad <= 1024).
//   V stays in a register; the rhs reads its neighbours through shared
//   memory, and the (a, c, d) of each cyclic-reduction level live in shared
//   memory, double-buffered, one __syncthreads per level. Where the TPU
//   roll wrapped around and multiplied the garbage by an exact zero
//   (a_i = 0 for i < 2^k, c_i = 0 for i >= m_pad - 2^k), an index outside
//   [0, m_pad) reads 0 here: the same result.
// * Thomas: one thread per strike walks the rows; V and c' live in the
//   (m_pad, B) layout, so a warp's loads of one row are coalesced across
//   strikes. The rhs is formed row by row in the forward sweep from the
//   previous layer (kept in registers one row behind the overwrite).
//
// What bounds them: operations. The least work is the Thomas form's ~20
// float ops per row, step and strike; PCR does about nine levels of ~12
// more by construction, and both recompute the sigma-derived coefficients
// (shared by every strike) in every strike. The Thomas form is a chain of
// dependent reciprocals per strike (latency-bound at one thread a strike).

#include <cuda_runtime.h>

#include "fastmath.cuh"

namespace optpricer {
namespace {

constexpr int THOMAS_THREADS = 32;

struct Params {
  float x_min, dx, dt, r, q;
};

__device__ __forceinline__ Params load_params(const float *par) {
  return Params{par[0], par[1], par[2], par[3], par[4]};
}

// (left, right) Dirichlet values at time-to-expiry tau
__device__ __forceinline__ void bc_pair(float K, bool is_call, float r,
                                        float tau, float S_min, float S_max,
                                        float &left, float &right) {
  const float disc_K = K * exp32(-r * tau);
  left = is_call ? 0.0f : fmaxf(disc_K - S_min, 0.0f);
  right = is_call ? fmaxf(S_max - disc_K, 0.0f) : 0.0f;
}

template <bool AMERICAN>
__global__ void fd_lv_pcr_kernel(const float *__restrict__ par,
                                 const float *__restrict__ Ks,
                                 const float *__restrict__ sign,
                                 const float *__restrict__ sig,
                                 float *__restrict__ V_out, int n_t, int m,
                                 int m_pad, int n_strikes, float one_m_theta,
                                 float theta) {
  extern __shared__ float sm[];
  // the previous layer, then (a, c, d) of a PCR level, double-buffered:
  // buffer k of a at sm + (1 + k) m_pad, of c at (3 + k), of d at (5 + k)
  float *Vs = sm;

  const int b = blockIdx.x;
  const int row = threadIdx.x;
  const Params p = load_params(par);
  const float e = one_m_theta * p.dt;
  const float td = theta * p.dt;
  const float interior = row < m ? 1.0f : 0.0f;
  const float row0 = row == 0 ? 1.0f : 0.0f;
  const float rowL = row == m - 1 ? 1.0f : 0.0f;
  const float not0 = row != 0 ? 1.0f : 0.0f;
  const float notL = row != m - 1 ? 1.0f : 0.0f;

  const float x = p.x_min + (static_cast<float>(row) + 1.0f) * p.dx;
  const float S = exp32(x);
  const float S_min = expf(p.x_min);
  const float S_max = expf(p.x_min + static_cast<float>(m + 1) * p.dx);
  const float K = Ks[b];
  const float sg = sign[b];
  const bool is_call = sg > 0.0f;
  const float intrinsic = fmaxf(sg * (S - K), 0.0f) * interior;

  float v = intrinsic;
  float bl_old, br_old;
  bc_pair(K, is_call, p.r, 0.0f, S_min, S_max, bl_old, br_old);

  for (int i = 0; i < n_t; ++i) {
    const int n_i = (n_t - 1) - i;
    const float n = static_cast<float>(n_t - 1) - static_cast<float>(i);
    const float tau = (static_cast<float>(n_t) - n) * p.dt;
    const float s = sig[static_cast<long long>(n_i) * m_pad + row];
    const float alpha = 0.5f * s * s / (p.dx * p.dx);
    const float beta = (p.r - p.q - 0.5f * s * s) / (2.0f * p.dx);
    const float AL = (alpha - beta) * interior;
    const float CL = (alpha + beta) * interior;
    float bl_new, br_new;
    bc_pair(K, is_call, p.r, tau, S_min, S_max, bl_new, br_new);

    Vs[row] = v;
    __syncthreads();
    const float vm1 = row == 0 ? bl_old : Vs[row - 1];
    const float vp1 =
        row == m - 1 ? br_old : (row + 1 < m_pad ? Vs[row + 1] : 0.0f);
    const float bL = -(AL + CL) - p.r * interior;
    float d = (1.0f + e * bL) * v + e * AL * vm1 + e * CL * vp1 +
              td * AL * row0 * bl_new + td * CL * rowL * br_new;

    // diagonal-normalised PCR
    const float rb0 = 1.0f / (1.0f + td * (AL + CL + p.r * interior));
    d = d * rb0;
    float a = -td * AL * not0 * rb0;
    float c = -td * CL * notL * rb0;
    int cur = 0;
    sm[m_pad + row] = a;
    sm[3 * m_pad + row] = c;
    sm[5 * m_pad + row] = d;
    __syncthreads();
    for (int sft = 1; sft < m_pad; sft <<= 1) {
      const float *A = sm + (1 + cur) * m_pad;
      const float *C = sm + (3 + cur) * m_pad;
      const float *D = sm + (5 + cur) * m_pad;
      const bool lo = row >= sft;
      const bool hi = row + sft < m_pad;
      const float am = lo ? A[row - sft] : 0.0f;
      const float cm = lo ? C[row - sft] : 0.0f;
      const float dm = lo ? D[row - sft] : 0.0f;
      const float ap = hi ? A[row + sft] : 0.0f;
      const float cpv = hi ? C[row + sft] : 0.0f;
      const float dpv = hi ? D[row + sft] : 0.0f;
      const float rcp = 1.0f / (1.0f - a * cm - c * ap);
      const float new_a = -rcp * a * am;
      const float new_c = -rcp * c * cpv;
      const float new_d = rcp * (d - a * dm - c * dpv);
      a = new_a;
      c = new_c;
      d = new_d;
      cur ^= 1;
      sm[(1 + cur) * m_pad + row] = a;
      sm[(3 + cur) * m_pad + row] = c;
      sm[(5 + cur) * m_pad + row] = d;
      __syncthreads();
    }
    v = AMERICAN ? fmaxf(d, intrinsic) : d;
    bl_old = bl_new;
    br_old = br_new;
  }
  V_out[static_cast<long long>(row) * n_strikes + b] = v;
}

template <bool AMERICAN>
__global__ void __launch_bounds__(THOMAS_THREADS)
fd_lv_thomas_kernel(const float *__restrict__ par,
                    const float *__restrict__ Ks,
                    const float *__restrict__ sign,
                    const float *__restrict__ sig, float *__restrict__ V,
                    float *__restrict__ CP, int n_t, int m, int m_pad,
                    int n_strikes, float one_m_theta, float theta) {
  const int b = blockIdx.x * THOMAS_THREADS + threadIdx.x;
  if (b >= n_strikes) return;
  const long long ld = n_strikes;
  const Params p = load_params(par);
  const float e = one_m_theta * p.dt;
  const float td = theta * p.dt;
  const float S_min = expf(p.x_min);
  const float S_max = expf(p.x_min + static_cast<float>(m + 1) * p.dx);
  const float K = Ks[b];
  const float sg = sign[b];
  const bool is_call = sg > 0.0f;
  auto intrinsic = [&](int row) {
    const float x = p.x_min + (static_cast<float>(row) + 1.0f) * p.dx;
    return fmaxf(sg * (exp32(x) - K), 0.0f) * (row < m ? 1.0f : 0.0f);
  };

  for (int row = 0; row < m_pad; ++row) V[row * ld + b] = intrinsic(row);
  float bl_old, br_old;
  bc_pair(K, is_call, p.r, 0.0f, S_min, S_max, bl_old, br_old);

  for (int i = 0; i < n_t; ++i) {
    const int n_i = (n_t - 1) - i;
    const float n = static_cast<float>(n_t - 1) - static_cast<float>(i);
    const float tau = (static_cast<float>(n_t) - n) * p.dt;
    const float *sg_row = sig + static_cast<long long>(n_i) * m_pad;
    float bl_new, br_new;
    bc_pair(K, is_call, p.r, tau, S_min, S_max, bl_new, br_new);

    // forward sweep: rhs of row j from the previous layer, then the
    // elimination; d' overwrites V[j] once the old V[j] is in v0
    float vm1 = bl_old;
    float v0 = V[b];
    float cp_prev = 0.0f, dp_prev = 0.0f;
    for (int row = 0; row < m_pad; ++row) {
      const float v_next = row + 1 < m_pad ? V[(row + 1) * ld + b] : 0.0f;
      const float vp1 = row == m - 1 ? br_old : v_next;
      const float interior = row < m ? 1.0f : 0.0f;
      const float s = sg_row[row];
      const float alpha = 0.5f * s * s / (p.dx * p.dx);
      const float beta = (p.r - p.q - 0.5f * s * s) / (2.0f * p.dx);
      const float AL = (alpha - beta) * interior;
      const float CL = (alpha + beta) * interior;
      const float bL = -(AL + CL) - p.r * interior;
      const float row0 = row == 0 ? 1.0f : 0.0f;
      const float rowL = row == m - 1 ? 1.0f : 0.0f;
      const float d = (1.0f + e * bL) * v0 + e * AL * vm1 + e * CL * vp1 +
                      td * AL * row0 * bl_new + td * CL * rowL * br_new;
      const float a_lhs = row == 0 ? 0.0f : -td * AL;
      const float b_lhs = 1.0f + td * (AL + CL + p.r * interior);
      const float c_lhs = -td * CL;
      const float rcp = 1.0f / (b_lhs - a_lhs * cp_prev);
      cp_prev = c_lhs * rcp;
      dp_prev = (d - a_lhs * dp_prev) * rcp;
      CP[row * ld + b] = cp_prev;
      V[row * ld + b] = dp_prev;
      vm1 = v0;
      v0 = v_next;
    }
    // back substitution, the carried value unprojected
    float x_next = 0.0f;
    for (int row = m_pad - 1; row >= 0; --row) {
      const float cj = row == m_pad - 1 ? 0.0f : CP[row * ld + b];
      x_next = V[row * ld + b] - cj * x_next;
      V[row * ld + b] = AMERICAN ? fmaxf(x_next, intrinsic(row)) : x_next;
    }
    bl_old = bl_new;
    br_old = br_new;
  }
}

}  // namespace
}  // namespace optpricer

using namespace optpricer;

// One local-vol ladder march. par: f32[6] (x_min, dx, dt, r, q, T); K, sign:
// f32[n_strikes]; sig: f32[n_t, m_pad]; V_out: f32[m_pad, n_strikes];
// scratch: f32[m_pad, n_strikes] (Thomas only). method: 0 PCR, 1 Thomas.
extern "C" int optpricer_fd_lv(const void *par, const void *K,
                               const void *sign, const void *sig, void *V_out,
                               void *scratch, int n_t, int m, int m_pad,
                               int n_strikes, float one_m_theta, float theta,
                               int american, int method, void *stream) {
  if (n_t < 1 || m < 1 || m_pad < m || n_strikes < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float *pr = static_cast<const float *>(par);
  const float *k = static_cast<const float *>(K);
  const float *sg = static_cast<const float *>(sign);
  const float *sv = static_cast<const float *>(sig);
  float *out = static_cast<float *>(V_out);
  if (method == 0) {
    if (m_pad > 1024) return static_cast<int>(cudaErrorInvalidValue);
    const size_t smem = 7 * static_cast<size_t>(m_pad) * sizeof(float);
    if (american)
      fd_lv_pcr_kernel<true><<<n_strikes, m_pad, smem, s>>>(
          pr, k, sg, sv, out, n_t, m, m_pad, n_strikes, one_m_theta, theta);
    else
      fd_lv_pcr_kernel<false><<<n_strikes, m_pad, smem, s>>>(
          pr, k, sg, sv, out, n_t, m, m_pad, n_strikes, one_m_theta, theta);
  } else if (method == 1) {
    const int blocks = (n_strikes + THOMAS_THREADS - 1) / THOMAS_THREADS;
    float *cp = static_cast<float *>(scratch);
    if (american)
      fd_lv_thomas_kernel<true><<<blocks, THOMAS_THREADS, 0, s>>>(
          pr, k, sg, sv, out, cp, n_t, m, m_pad, n_strikes, one_m_theta,
          theta);
    else
      fd_lv_thomas_kernel<false><<<blocks, THOMAS_THREADS, 0, s>>>(
          pr, k, sg, sv, out, cp, n_t, m, m_pad, n_strikes, one_m_theta,
          theta);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
