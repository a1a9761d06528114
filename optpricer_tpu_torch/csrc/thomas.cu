// Batched Thomas solve on Hopper, one system per thread (K7), with a plain
// C interface (bound with ctypes by optpricer_tpu_torch/ops/thomas.py,
// built by optpricer_tpu_torch/_build.py).
//
// thomas_kernel replaces optpricer_tpu/ops/pallas_tridiag.py:_thomas_kernel.
// It computes the same function in the same arithmetic: forward elimination
// c'_i = c_i / den, d'_i = (d_i - a_i d'_{i-1}) / den with
// den = b_i - a_i c'_{i-1} (two divisions, no reciprocal), then
// x_i = d'_i - c'_i x_{i+1}. a[0] and c[n-1] are never read, so whatever
// they hold cannot reach the solution (the PDE stack broadcasts its
// coefficients over every row, so c[n-1] is not 0 there); on the TPU a
// padded row or the kernel's `last` mask zeroed that term.
//
// Layout (n, batch): thread j owns system j and walks its rows, so a warp's
// loads of row i are 32 neighbouring words. Each of a, b, c is read at
// i*row + j*col, so a column shared by every system (col = 0) is one
// broadcast load and is never expanded to the batch. d' goes straight into
// x and is overwritten by the back substitution; c' goes to a scratch of
// the same layout (n = 511 rows do not fit in registers).
//
// What bounds it: latency. The recurrence is a chain of n dependent
// divisions per system, and there is one thread per system: 1024 systems
// make 32 warps for 132 SMs, a single-strike local-vol price one thread.
// The least time for the work is the bytes (a, b, c, d read once, x written
// once) over the memory rate; this design does not approach it. Cyclic
// reduction per system in shared memory, or prefetching rows, is a later
// change.

#include <cuda_runtime.h>

namespace optpricer {
namespace {

constexpr int THREADS = 32;  // one warp per block spreads the systems over SMs

template <typename T>
__global__ void __launch_bounds__(THREADS)
thomas_kernel(const T *__restrict__ a, long long a_row, long long a_col,
              const T *__restrict__ b, long long b_row, long long b_col,
              const T *__restrict__ c, long long c_row, long long c_col,
              const T *__restrict__ d, T *__restrict__ x, T *__restrict__ cp,
              int n, int batch) {
  const int j = blockIdx.x * THREADS + threadIdx.x;
  if (j >= batch) return;
  const long long ld = batch;
  // row 0: a[0] is treated as 0
  T den = b[j * b_col];
  T cp_prev = c[j * c_col] / den;
  T dp_prev = d[j] / den;
  cp[j] = cp_prev;
  x[j] = dp_prev;
  for (int i = 1; i < n; ++i) {
    const T ai = a[i * a_row + j * a_col];
    den = b[i * b_row + j * b_col] - ai * cp_prev;
    cp_prev = c[i * c_row + j * c_col] / den;
    dp_prev = (d[i * ld + j] - ai * dp_prev) / den;
    cp[i * ld + j] = cp_prev;
    x[i * ld + j] = dp_prev;
  }
  // back substitution; x[n-1] = d'[n-1] (c[n-1] is treated as 0)
  T x_next = dp_prev;
  for (int i = n - 2; i >= 0; --i) {
    x_next = x[i * ld + j] - cp[i * ld + j] * x_next;
    x[i * ld + j] = x_next;
  }
}

template <typename T>
cudaError_t launch(const void *a, long long ar, long long ac, const void *b,
                   long long br, long long bc, const void *c, long long cr,
                   long long cc, const void *d, void *x, void *cp, int n,
                   int batch, cudaStream_t s) {
  const int blocks = (batch + THREADS - 1) / THREADS;
  thomas_kernel<T><<<blocks, THREADS, 0, s>>>(
      static_cast<const T *>(a), ar, ac, static_cast<const T *>(b), br, bc,
      static_cast<const T *>(c), cr, cc, static_cast<const T *>(d),
      static_cast<T *>(x), static_cast<T *>(cp), n, batch);
  return cudaGetLastError();
}

}  // namespace
}  // namespace optpricer

using namespace optpricer;

// Solve batch tridiagonal systems of n rows. d, x, cp: (n, batch)
// contiguous; a, b, c at i*row + j*col. is_double: 0 float, 1 double.
extern "C" int optpricer_thomas(const void *a, long long a_row,
                                long long a_col, const void *b,
                                long long b_row, long long b_col,
                                const void *c, long long c_row,
                                long long c_col, const void *d, void *x,
                                void *cp, int n, int batch, int is_double,
                                void *stream) {
  if (n < 1 || batch < 1) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err =
      is_double ? launch<double>(a, a_row, a_col, b, b_row, b_col, c, c_row,
                                 c_col, d, x, cp, n, batch, s)
                : launch<float>(a, a_row, a_col, b, b_row, b_col, c, c_row,
                                c_col, d, x, cp, n, batch, s);
  return static_cast<int>(err);
}
