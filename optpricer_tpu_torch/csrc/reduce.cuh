// Fixed-order reductions shared by the Monte-Carlo kernels: no atomics, so
// one seed gives bitwise-identical statistics on every run.
//
// * kahan_step: one compensated accumulation of NSTAT sums per thread (the
//   per-rep loop of the TPU kernels, ops/stats.kahan_add);
// * block_row: a warp-shuffle tree, then the warps in order, into one row;
// * combine: a second pass that Kahan-sums consecutive rows in row order,
//   like ops/stats.combine_scan, and scales stat k of each sum by 1/2 or
//   1/4 where bit k of `half` or `quarter` is set (exact: a power of two).
//
// Everything is in an anonymous namespace, so each translation unit that
// includes this header has its own copy of the kernels.
#pragma once

#include <cuda_runtime.h>

namespace optpricer {
namespace {

template <int NSTAT>
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

// Sum of the first NSTAT accumulators of every thread of the block into
// row[0, NSTAT); the block must have THREADS threads.
template <int NSTAT, int THREADS>
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

// out[seg] = Kahan sum of rows[seg * rows_per_seg : (seg + 1) * rows_per_seg]
// in row order; one thread per (segment, stat). Rows are ROW floats apart.
template <int NSTAT, int ROW>
__global__ void combine_rows_kernel(const float *rows, int rows_per_seg,
                                    int n_seg, float *out, unsigned half,
                                    unsigned quarter) {
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
  const float scale =
      (half >> k) & 1u ? 0.5f : ((quarter >> k) & 1u ? 0.25f : 1.0f);
  out[static_cast<size_t>(seg) * ROW + k] = acc * scale;
}

template <int NSTAT, int ROW>
inline cudaError_t combine(const float *rows, int rows_per_seg, int n_seg,
                           float *out, cudaStream_t stream,
                           unsigned half = 0u, unsigned quarter = 0u) {
  const int threads = 128;
  const int blocks = (n_seg * NSTAT + threads - 1) / threads;
  combine_rows_kernel<NSTAT, ROW><<<blocks, threads, 0, stream>>>(
      rows, rows_per_seg, n_seg, out, half, quarter);
  return cudaGetLastError();
}

}  // namespace
}  // namespace optpricer
