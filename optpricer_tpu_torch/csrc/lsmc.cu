// The Longstaff-Schwartz strike ladder's date loop on Hopper, with a plain C
// interface (bound with ctypes by optpricer_tpu_torch/ops/lsmc.py, built by
// optpricer_tpu_torch/_build.py).
//
// It replaces no TPU kernel: the JAX package's ladder
// (optpricer_tpu/models/american_mc.py:_lsmc_backward_batch) is plain jnp,
// two matmuls, a batched solve and elementwise passes a date. Its torch
// version (optpricer_tpu_torch/models/american_mc.py:_lsmc_backward_batch)
// is this kernel's plain version, and the card tests hold it to that.
//
// The work. B strikes share one path matrix S (n_steps + 1, n). Going back
// from maturity, each date t = n_steps - 1 ... 1 regresses every strike's
// discounted cashflow y on the powers of x = S_t / S_0 - 1 over its
// in-the-money paths, then exercises where the intrinsic beats the fit.
// The state that has to survive from one date to the next is, per (strike,
// path), the date at which the path stops: tau, one byte. The cashflow is
// rebuilt from it, y_t = max(sign (S_tau - K), 0) disc^(tau - t), from the
// path matrix that the strikes share. So a date is one read and one write
// of B x n bytes, ~40 operations per (strike, path), and a small solve.
//
// lsmc_date_kernel, one launch a date t, one pass over tau:
// * it applies date t+1's exercise with beta_{t+1}: tau = t+1 where the
//   intrinsic is positive and beats the fit (strict >, the plain version's
//   rule);
// * it sums date t's normal equations for each strike over the block's
//   paths: the in-the-money count and the sums of x^m (m = 1 ... 6: with a
//   basis of powers, X^T W X is a Hankel matrix of 7 distinct moments) and
//   of y x^m (m = 0 ... 3);
// * it writes them as one partial row per (strike, block).
// A warp holds 32 strikes, a lane one strike, and the warp walks a staged
// chunk of CHUNK paths in lockstep, so each path's record (S_t, S_{t+1},
// x_{t+1} and x_t's powers) is a broadcast from shared memory and each
// lane's S_tau a lookup in the path's column of S_{t+1..n_steps}, stored
// with an odd stride so that the columns of consecutive paths do not share
// a bank; the columns arrive by asynchronous copies, all in flight at
// once. tau is laid out so that each lane's 16 consecutive paths are one
// 16-byte word and a warp's 32 words are 512 contiguous bytes: one
// coalesced load and one store a lane per 16 paths. The per-path body has
// no branch: the in-the-money test is a 0/1 weight in the sums' FMAs, the
// exercise a select, and the last chunk's paths past n read NaN spots.
// The launch for t = 0 applies date 1's exercise and sums each strike's
// discounted cashflow v = max(sign (S_tau - K), 0) disc^tau and the squares
// of v - c, c the strike's intrinsic at t = 0 (a shift near the mean: the
// variance is not the f32 difference of two large sums).
//
// lsmc_reduce_kernel, one launch a date: a block of 32 strikes sums each
// strike's partial rows in double in a fixed order (warp w the rows
// w, w + 16, ..., then the 16 warps in order), then one thread a strike
// normalises by max(n_itm, 1), adds the ridge 1e-7 I and solves the 4 x 4
// system by Cholesky in double, and writes beta_t (or, at t = 0, the price
// max(mean, c) and the standard error). No atomics: a seed gives the same
// bits on every run. Nothing is read back: the date loop makes no host
// sync.
//
// What bounds it: instruction issue (~40 a strike, path and date; the tau
// traffic, 2 B x n bytes a date, overlaps it). The design keeps every
// (strike, path) quantity in registers for the one pass, and everything a
// path shares among the strikes in shared memory, computed once a chunk.
// Tried and left out: two strikes a lane (the path's broadcasts shared by
// two strikes) was 3.6% faster at 512 x 400 000 x 50 for 80 registers and a
// third more code; the kernel is held by its arithmetic, not by shared
// memory.

#include <cuda_pipeline.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace optpricer {
namespace {

constexpr int THREADS = 256;           // 8 warps, 8 strike tiles a block
constexpr int WARPS = THREADS / 32;
constexpr int CHUNK = 128;             // paths a block stages at a time
constexpr int GROUP = 16;              // paths in a lane's 16-byte tau word
constexpr int REC = 12;                // floats of a path's record
constexpr int NSUM = 11;               // n_itm, sum x^1..6, sum y x^0..3
constexpr int NMOM = 2;                // sum v, sum (v - c)^2
constexpr int MAX_STEPS = 255;         // tau is one byte
constexpr int RED_WARPS = 16;
constexpr double RIDGE = 1e-7;

// byte b of w, and w with byte b replaced by the low byte of v
__device__ __forceinline__ unsigned get_byte(unsigned w, int b) {
  return __byte_perm(w, 0u, 0x4440u + b);
}
__device__ __forceinline__ unsigned set_byte(unsigned w, unsigned v, int b) {
  return __byte_perm(w, v, (0x3210u & ~(0xfu << 4 * b)) | (0x4u << 4 * b));
}

__device__ __forceinline__ float intrinsic(float sg, float k, float S) {
  return fmaxf(sg * (S - k), 0.0f);
}

// Shared memory of a date pass: the columns, then the records.
__host__ __device__ constexpr int col_stride(int n_steps) {
  return (n_steps + 1) | 1;
}
size_t date_smem(int n_steps) {
  return sizeof(float) * CHUNK * (col_stride(n_steps) + REC);
}

// Date t's pass (FINAL: t = 0) over the chunks [blockIdx.x * cpb, ...) of
// the strikes blockIdx.y * THREADS + threadIdx.x. beta_next: (B, 4) of date
// t+1, or null (t+1 is maturity). first: tau is not read but starts at
// n_steps. part: (gridDim.x, NSUM or NMOM, B).
template <bool FINAL>
__global__ void __launch_bounds__(THREADS, 4)
lsmc_date_kernel(const float *__restrict__ paths, const float *__restrict__ K,
                 const float *__restrict__ sign,
                 const float *__restrict__ disc,
                 const float *__restrict__ beta_next, uint4 *__restrict__ tau,
                 float *__restrict__ part, int n, int n_steps, int B, int t,
                 int first, int cpb) {
  extern __shared__ __align__(16) float smem[];
  __shared__ float dtab[MAX_STEPS + 1];
  const int stride = col_stride(n_steps);
  float *col = smem;                     // S_j of path p at p * stride + j
  float *rec = smem + CHUNK * stride;    // [CHUNK][REC]
  constexpr int NS = FINAL ? NMOM : NSUM;

  const int lane = threadIdx.x & 31;
  const int bx = blockIdx.x;
  const int tile = blockIdx.y * WARPS + (threadIdx.x >> 5);
  const int strike = tile * 32 + lane;
  const bool warp_live = tile * 32 < B;
  const bool live = strike < B;
  // a lane past the ladder has sign 0: out of the money everywhere;
  // fmaf(sg, S, nsk) is sg (S - K) with its rounding, sg being +-1
  const float sg = live ? sign[strike] : 0.0f;
  const float k = live ? K[strike] : 0.0f;
  const float nsk = -sg * k;
  // with no exercise at t+1 (maturity) the fit is +inf
  float4 beta = make_float4(INFINITY, 0.0f, 0.0f, 0.0f);
  if (beta_next != nullptr && live)
    beta = reinterpret_cast<const float4 *>(beta_next)[strike];
  const float s_ref = paths[0];
  const float shift = intrinsic(sg, k, s_ref);
  if (threadIdx.x == 0) {                // dtab[j] = disc^(j - t)
    const double d = static_cast<double>(*disc);
    double a = 1.0;
    for (int j = t; j <= n_steps; ++j, a *= d) dtab[j] = static_cast<float>(a);
  }

  const int r_lo = t + 1;                // the dates a path can stop at
  const int rows = n_steps + 1 - r_lo;
  const int n_chunks = (n + CHUNK - 1) / CHUNK;
  const long long words = static_cast<long long>(n_chunks) * (CHUNK / GROUP);
  const int c_end = min((bx + 1) * cpb, n_chunks);
  const float nan = __int_as_float(0x7fffffff);
  float acc[NS];
#pragma unroll
  for (int m = 0; m < NS; ++m) acc[m] = 0.0f;

  for (int c = bx * cpb; c < c_end; ++c) {
    const int p0 = c * CHUNK;
    const int valid = min(CHUNK, n - p0);
    __syncthreads();                     // the last chunk's readers are done
    // the columns by asynchronous copies, all in flight at once. A path
    // past n (the last chunk's tail) reads NaN spots and zero powers:
    // never in the money, never exercised, adding 0 to every sum.
    for (int i = threadIdx.x; i < rows * CHUNK; i += THREADS) {
      const int row = r_lo + i / CHUNK, p = i % CHUNK;
      float *dst = col + p * stride + row;
      if (p < valid)
        __pipeline_memcpy_async(
            dst, paths + static_cast<size_t>(row) * n + p0 + p, sizeof(float));
      else
        *dst = nan;
    }
    __pipeline_commit();
    if (threadIdx.x < CHUNK) {
      // ra = (S_t, S_{t+1}, x_{t+1}, x), rb = (x^2 .. x^5), rc.x = x^6; at
      // t = 0 ra.w is the path's weight, 1 or 0 past n
      const int p = threadIdx.x;
      const bool ok = p < valid;
      float *r = rec + p * REC;
      const float s1 = ok ? paths[static_cast<size_t>(t + 1) * n + p0 + p]
                          : nan;
      r[1] = s1;
      r[2] = ok ? s1 / s_ref - 1.0f : 0.0f;
      if (FINAL) {
        r[3] = ok ? 1.0f : 0.0f;
      } else {
        const float s = ok ? paths[static_cast<size_t>(t) * n + p0 + p]
                           : nan;
        const float x = ok ? s / s_ref - 1.0f : 0.0f;
        r[0] = s;
        float xm = x;
        r[3] = xm;
#pragma unroll
        for (int m = 2; m <= 6; ++m) {
          xm *= x;
          r[2 + m] = xm;
        }
      }
    }
    __pipeline_wait_prior(0);
    __syncthreads();
    if (!warp_live) continue;

    uint4 *tw = tau + (static_cast<long long>(tile) * words
                       + static_cast<long long>(c) * (CHUNK / GROUP)) * 32
                + lane;
    for (int g = 0; g * GROUP < valid; ++g) {
      uint4 word;
      if (first) {
        const unsigned s4 = 0x01010101u * static_cast<unsigned>(n_steps);
        word = make_uint4(s4, s4, s4, s4);
      } else {
        word = tw[g * 32];
      }
      unsigned wv[4] = {word.x, word.y, word.z, word.w};
#pragma unroll
      for (int i = 0; i < GROUP; ++i) {
        const int p = g * GROUP + i;
        const float4 ra = *reinterpret_cast<const float4 *>(rec + p * REC);
        // date t+1's exercise: the intrinsic positive and above the fit
        const float u1 = fmaf(sg, ra.y, nsk);
        const float fit =
            fmaf(fmaf(fmaf(beta.w, ra.z, beta.z), ra.z, beta.y), ra.z, beta.x);
        unsigned st = get_byte(wv[i >> 2], i & 3);
        st = u1 > 0.0f && u1 > fit ? static_cast<unsigned>(t + 1) : st;
        wv[i >> 2] = set_byte(wv[i >> 2], st, i & 3);
        const float y =
            fmaxf(fmaf(sg, col[p * stride + st], nsk), 0.0f) * dtab[st];
        if (FINAL) {
          const float dv = y - shift;
          acc[0] += y;
          acc[1] = fmaf(ra.w * dv, dv, acc[1]);
        } else {
          const float4 rb = *reinterpret_cast<const float4 *>(rec + p * REC + 4);
          const float x6 = rec[p * REC + 8];
          // date t's normal equations over the in-the-money paths, as
          // products with a 0/1 weight: no branch
          const float w = fmaf(sg, ra.x, nsk) > 0.0f ? 1.0f : 0.0f;
          const float wy = w * y;
          acc[0] += w;
          acc[1] = fmaf(w, ra.w, acc[1]);
          acc[2] = fmaf(w, rb.x, acc[2]);
          acc[3] = fmaf(w, rb.y, acc[3]);
          acc[4] = fmaf(w, rb.z, acc[4]);
          acc[5] = fmaf(w, rb.w, acc[5]);
          acc[6] = fmaf(w, x6, acc[6]);
          acc[7] += wy;
          acc[8] = fmaf(wy, ra.w, acc[8]);
          acc[9] = fmaf(wy, rb.x, acc[9]);
          acc[10] = fmaf(wy, rb.y, acc[10]);
        }
      }
      if (!FINAL) tw[g * 32] = make_uint4(wv[0], wv[1], wv[2], wv[3]);
    }
  }
  if (live) {
#pragma unroll
    for (int m = 0; m < NS; ++m)
      part[(static_cast<size_t>(bx) * NS + m) * B + strike] = acc[m];
  }
}

// Each strike's partial rows summed in double in a fixed order; then, one
// thread a strike, beta_t of the ridge-regularised normal equations (or, at
// t = 0, the price and its standard error into out (2, B)).
template <bool FINAL>
__global__ void __launch_bounds__(RED_WARPS * 32)
lsmc_reduce_kernel(const float *__restrict__ part, int n_pb, int B, int n,
                   const float *__restrict__ paths,
                   const float *__restrict__ K,
                   const float *__restrict__ sign, float *__restrict__ beta,
                   float *__restrict__ out) {
  constexpr int NS = FINAL ? NMOM : NSUM;
  __shared__ double red[RED_WARPS][NS][32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int strike = blockIdx.x * 32 + lane;
  const bool live = strike < B;
  double s[NS];
#pragma unroll
  for (int m = 0; m < NS; ++m) s[m] = 0.0;
  if (live) {
    for (int pb = warp; pb < n_pb; pb += RED_WARPS) {
#pragma unroll
      for (int m = 0; m < NS; ++m)
        s[m] += static_cast<double>(
            part[(static_cast<size_t>(pb) * NS + m) * B + strike]);
    }
  }
#pragma unroll
  for (int m = 0; m < NS; ++m) red[warp][m][lane] = s[m];
  __syncthreads();
  if (warp != 0 || !live) return;
#pragma unroll
  for (int m = 0; m < NS; ++m) {
    double v = 0.0;
    for (int w = 0; w < RED_WARPS; ++w) v += red[w][m][lane];
    s[m] = v;
  }
  if (FINAL) {
    const double c = static_cast<double>(intrinsic(sign[strike], K[strike],
                                                   paths[0]));
    const double nn = static_cast<double>(n);
    const double mean = s[0] / nn;
    const double dm = mean - c;
    const double var = fmax((s[1] - nn * dm * dm) / (nn - 1.0), 0.0);
    out[strike] = static_cast<float>(fmax(mean, c));
    out[B + strike] = static_cast<float>(sqrt(var / nn));
    return;
  }
  // A[i][j] = sum x^(i+j) / n_itm + ridge [i == j], b[i] = sum y x^i / n_itm
  const double inv = 1.0 / fmax(s[0], 1.0);
  double A[4][4], b[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j)
      A[i][j] = s[i + j] * inv + (i == j ? RIDGE : 0.0);
    b[i] = s[7 + i] * inv;
  }
  // Cholesky A = L L^T (A is a Gram matrix plus the ridge: positive
  // definite), then L z = b and L^T beta = z
  double L[4][4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    double d = A[j][j];
#pragma unroll
    for (int q = 0; q < j; ++q) d -= L[j][q] * L[j][q];
    L[j][j] = sqrt(d);
#pragma unroll
    for (int i = j + 1; i < 4; ++i) {
      double v = A[i][j];
#pragma unroll
      for (int q = 0; q < j; ++q) v -= L[i][q] * L[j][q];
      L[i][j] = v / L[j][j];
    }
  }
  double z[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    double v = b[i];
#pragma unroll
    for (int q = 0; q < i; ++q) v -= L[i][q] * z[q];
    z[i] = v / L[i][i];
  }
#pragma unroll
  for (int i = 3; i >= 0; --i) {
    double v = z[i];
#pragma unroll
    for (int q = i + 1; q < 4; ++q) v -= L[q][i] * z[q];
    z[i] = v / L[i][i];
  }
  reinterpret_cast<float4 *>(beta)[strike] =
      make_float4(static_cast<float>(z[0]), static_cast<float>(z[1]),
                  static_cast<float>(z[2]), static_cast<float>(z[3]));
}

template <bool FINAL>
cudaError_t launch(const float *paths, const float *K, const float *sign,
                   const float *disc, const float *beta_next, float *beta_out,
                   uint4 *tau, float *part, float *out, int n, int n_steps,
                   int B, int t, int first, int cpb, int n_pb,
                   cudaStream_t s) {
  const size_t smem = date_smem(n_steps);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        lsmc_date_kernel<FINAL>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  const dim3 grid(n_pb, (B + THREADS - 1) / THREADS);
  lsmc_date_kernel<FINAL><<<grid, THREADS, smem, s>>>(
      paths, K, sign, disc, beta_next, tau, part, n, n_steps, B, t, first,
      cpb);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  lsmc_reduce_kernel<FINAL><<<(B + 31) / 32, RED_WARPS * 32, 0, s>>>(
      part, n_pb, B, n, paths, K, sign, beta_out, out);
  return cudaGetLastError();
}

}  // namespace
}  // namespace optpricer

using namespace optpricer;

// Date t of the ladder's backward pass: the date pass and its reduction.
// paths: f32 (n_steps + 1, n); K, sign: f32 (B,); disc: f32[1];
// beta_next: f32 (B, 4) of date t+1 or null; beta_out: f32 (B, 4) of date t
// (t >= 1); tau: the stopping dates, (ceil(B/32) x n_chunks x 8) words of
// 32 x 16 bytes; part: f32 (n_pb, 11, B) scratch; out: f32 (2, B), the
// prices and standard errors (t = 0). first: tau starts at n_steps.
extern "C" int optpricer_lsmc_date(const void *paths, const void *K,
                                   const void *sign, const void *disc,
                                   const void *beta_next, void *beta_out,
                                   void *tau, void *part, void *out, int n,
                                   int n_steps, int B, int t, int first,
                                   int cpb, int n_pb, void *stream) {
  if (n_steps < 1 || n_steps > MAX_STEPS || t < 0 || t >= n_steps)
    return static_cast<int>(cudaErrorInvalidValue);
  if (B == 0 || n == 0) return static_cast<int>(cudaSuccess);  // no work
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float *pa = static_cast<const float *>(paths);
  const float *kk = static_cast<const float *>(K);
  const float *sg = static_cast<const float *>(sign);
  const float *dc = static_cast<const float *>(disc);
  const float *bn = static_cast<const float *>(beta_next);
  uint4 *tw = static_cast<uint4 *>(tau);
  float *pt = static_cast<float *>(part);
  cudaError_t err =
      t == 0 ? launch<true>(pa, kk, sg, dc, bn, nullptr, tw, pt,
                            static_cast<float *>(out), n, n_steps, B, t,
                            first, cpb, n_pb, s)
             : launch<false>(pa, kk, sg, dc, bn,
                             static_cast<float *>(beta_out), tw, pt, nullptr,
                             n, n_steps, B, t, first, cpb, n_pb, s);
  return static_cast<int>(err);
}

// Resident blocks per SM of the date pass at n_steps, or -1.
extern "C" int optpricer_lsmc_occupancy(int n_steps) {
  if (n_steps < 1 || n_steps > MAX_STEPS) return -1;
  const size_t smem = date_smem(n_steps);
  if (smem > 48 * 1024 &&
      cudaFuncSetAttribute(lsmc_date_kernel<false>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           static_cast<int>(smem)) != cudaSuccess)
    return -1;
  int blocks = 0;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &blocks, lsmc_date_kernel<false>, THREADS, smem) != cudaSuccess)
    return -1;
  return blocks;
}

// The layout ops/lsmc.py sizes the buffers by, into out[6]: strikes a block,
// paths a chunk, paths a stopping-date word, strikes a word tile (a warp),
// floats of a partial row, the most steps.
extern "C" int optpricer_lsmc_layout(void *out) {
  int *o = static_cast<int *>(out);
  o[0] = THREADS;
  o[1] = CHUNK;
  o[2] = GROUP;
  o[3] = 32;
  o[4] = NSUM;
  o[5] = MAX_STEPS;
  return 0;
}
