// Batched tridiagonal solve on Hopper by parallel cyclic reduction (K7),
// with a plain C interface (bound with ctypes by
// optpricer_tpu_torch/ops/thomas.py, built by optpricer_tpu_torch/_build.py).
//
// tridiag_pcr_kernel and tridiag_partition_kernel replace
// optpricer_tpu/ops/pallas_tridiag.py:_thomas_kernel. They compute what it
// computes, the solution of T x = d for a batch of systems with a[0] and
// c[n-1] never read (whatever they hold cannot reach the solution: the PDE
// stack broadcasts its coefficients over every row, so c[n-1] is not 0
// there), but not in Thomas's order: a chain of n dependent divisions per
// system, one thread per system, leaves the card idle (one thread for a
// single local-vol system, 32 warps for 1 024 systems).
//
// * tridiag_pcr_kernel, n <= PCR_MAX_ROWS: one block per system, one
//   thread per row. Each thread loads its row (a, b, c, d) and normalises
//   it by the diagonal; then ceil(log2 n) levels of cyclic reduction, each
//   row eliminating its neighbours at distance 2^k:
//     r = 1 / (1 - a c_{i-s} - c a_{i+s}),
//     a' = -r a a_{i-s},  c' = -r c c_{i+s},
//     d' = r (d - a d_{i-s} - c d_{i+s}),
//   with the level's (a, c, d) in shared memory, double-buffered, one
//   __syncthreads a level (as csrc/fd_lv.cu's PCR march). A neighbour
//   outside [0, n) reads 0. After the last level x_i = d_i.
// * tridiag_partition_kernel, n > PCR_MAX_ROWS: one block of PART_THREADS
//   threads per system; thread t owns M = ceil(n / PART_THREADS) >= 3
//   consecutive rows (rows past n are identity rows that solve to 0). Each
//   thread eliminates its chunk down and up so that every row depends only
//   on the chunk's first and last unknowns (Laszlo, Giles & Appleyard's
//   hybrid Thomas-PCR); the 2 * PART_THREADS boundary unknowns form a
//   unit-diagonal tridiagonal system that the block solves by the same
//   PCR in shared memory; then each thread substitutes them back into its
//   chunk. The chunk's modified rows go to a scratch (3, batch, M,
//   PART_THREADS), interleaved so that a warp's accesses are coalesced.
//
// Layout: system j is the pair (q, r) = (j / inner, j % inner), and
// element (i, j), row i of system j, of each operand sits at
// i*row + r*col + q*outer, each operand with its own strides. The PDE
// stack's (..., n) rows pass with row = 1 and col = n, so a block reads
// its system as contiguous words; the (n, batch) layout passes row = batch
// and col = 1 (inner = batch, q = 0); a coefficient column shared by every
// system passes col = outer = 0 and is read through the cache by every
// block. The two levels let a batch of matrices against a set of
// right-hand sides (tridiag_inv: matrix q, unit vector r) read each
// matrix's bands with col = 0 and the one identity with outer = 0.
// Nothing is transposed or copied.
//
// Shared memory: 6 buffers of the level's rows, 6 * 1024 * 8 bytes = 48 KB
// at most (f64, n = 1024, or the partitioned kernel's 2 * 512 boundary
// rows), so no launch needs the opt-in above 48 KB.
//
// What bounds it: bytes. The least time is a, b, c, d read once and x
// written once over the memory rate. PCR does ~log2 n levels of ~12 flops
// and one reciprocal per row, which the card's float64 rate covers many
// times over at the PDE stack's n <= 1 024; a single system (the per-step
// solve of a local-vol or PSOR march) is one block, bound by its levels'
// latency (a reciprocal and a barrier each) and the launch. Built with FMA
// contraction: the result is held by tolerance against the plain versions
// (ops/thomas.py _thomas_plain, and _pcr_plain, this kernel's arithmetic).

#include <cuda_runtime.h>

namespace optpricer {
namespace {

constexpr int PCR_MAX_ROWS = 1024;   // ops/thomas.PCR_MAX_ROWS
constexpr int PART_THREADS = 512;    // ops/thomas.PART_THREADS

struct Strides {
  long long row, col, outer;
};

// One operand of one system: element i at base[i * row].
template <typename T>
struct Column {
  const T *base;
  long long row;
  __device__ __forceinline__ T operator[](long long i) const {
    return base[i * row];
  }
};

// System j = (q, r): q = j / inner, r = j % inner.
struct System {
  long long q, r;
};

__device__ __forceinline__ System system_of(int j, int inner) {
  return System{j / inner, j % inner};
}

__device__ __forceinline__ long long offset(Strides s, System sys) {
  return sys.r * s.col + sys.q * s.outer;
}

template <typename T>
__device__ __forceinline__ Column<T> column(const T *p, Strides s,
                                            System sys) {
  return Column<T>{p + offset(s, sys), s.row};
}

// Cyclic reduction of a unit-diagonal system of n rows held in shared
// memory; the calling thread owns rows r0 + k, k < R (R = 1 or 2), with its
// (a, c, d) in registers, and gets their solution back in d. sm holds six
// buffers of `stride` >= n elements: a, c, d for each parity of the level.
template <typename T, int R>
__device__ __forceinline__ void pcr(T (&a)[R], T (&c)[R], T (&d)[R], int r0,
                                    int n, T *sm, int stride) {
  T *A = sm, *C = sm + 2 * stride, *D = sm + 4 * stride;
  int cur = 0;
#pragma unroll
  for (int k = 0; k < R; ++k) {
    A[r0 + k] = a[k];
    C[r0 + k] = c[k];
    D[r0 + k] = d[k];
  }
  __syncthreads();
  for (int s = 1; s < n; s <<= 1) {
    const T *Ac = A + cur * stride, *Cc = C + cur * stride,
            *Dc = D + cur * stride;
#pragma unroll
    for (int k = 0; k < R; ++k) {
      const int i = r0 + k;
      if (i >= n) continue;
      const bool lo = i >= s, hi = i + s < n;
      const T am = lo ? Ac[i - s] : T(0), cm = lo ? Cc[i - s] : T(0),
              dm = lo ? Dc[i - s] : T(0);
      const T ap = hi ? Ac[i + s] : T(0), cp = hi ? Cc[i + s] : T(0),
              dp = hi ? Dc[i + s] : T(0);
      const T r = T(1) / (T(1) - a[k] * cm - c[k] * ap);
      d[k] = r * (d[k] - a[k] * dm - c[k] * dp);
      a[k] = -r * a[k] * am;
      c[k] = -r * c[k] * cp;
    }
    cur ^= 1;
#pragma unroll
    for (int k = 0; k < R; ++k) {
      A[cur * stride + r0 + k] = a[k];
      C[cur * stride + r0 + k] = c[k];
      D[cur * stride + r0 + k] = d[k];
    }
    __syncthreads();
  }
}

template <typename T>
__global__ void __launch_bounds__(PCR_MAX_ROWS)
tridiag_pcr_kernel(const T *__restrict__ a, Strides as,
                   const T *__restrict__ b, Strides bs,
                   const T *__restrict__ c, Strides cs,
                   const T *__restrict__ d, Strides ds, T *__restrict__ x,
                   Strides xs, int n, int inner) {
  extern __shared__ __align__(16) unsigned char smem[];
  T *sm = reinterpret_cast<T *>(smem);
  const System j = system_of(blockIdx.x, inner);
  const int i = threadIdx.x;
  T ar[1] = {T(0)}, cr[1] = {T(0)}, dr[1] = {T(0)};
  if (i < n) {
    const T rb = T(1) / column(b, bs, j)[i];
    ar[0] = i > 0 ? column(a, as, j)[i] * rb : T(0);          // a[0] unused
    cr[0] = i < n - 1 ? column(c, cs, j)[i] * rb : T(0);      // c[n-1] unused
    dr[0] = column(d, ds, j)[i] * rb;
  }
  pcr<T, 1>(ar, cr, dr, i, n, sm, blockDim.x);
  if (i < n) x[offset(xs, j) + i * xs.row] = dr[0];
}

// Row g of the system, or an identity row past n; a[0] and c[n-1] read 0.
template <typename T>
__device__ __forceinline__ void load_row(const Column<T> &A,
                                         const Column<T> &B,
                                         const Column<T> &C,
                                         const Column<T> &D, long long g,
                                         int n, T &a, T &b, T &c, T &d) {
  if (g >= n) {
    a = T(0);
    b = T(1);
    c = T(0);
    d = T(0);
    return;
  }
  a = g > 0 ? A[g] : T(0);
  b = B[g];
  c = g < n - 1 ? C[g] : T(0);
  d = D[g];
}

template <typename T>
__global__ void __launch_bounds__(PART_THREADS)
tridiag_partition_kernel(const T *__restrict__ a, Strides as,
                         const T *__restrict__ b, Strides bs,
                         const T *__restrict__ c, Strides cs,
                         const T *__restrict__ d, Strides ds,
                         T *__restrict__ x, Strides xs, T *__restrict__ work,
                         int n, int M, int inner) {
  extern __shared__ __align__(16) unsigned char smem[];
  T *sm = reinterpret_cast<T *>(smem);
  const int j = blockIdx.x;
  const int t = threadIdx.x;
  const System sys = system_of(j, inner);
  const Column<T> A = column(a, as, sys), B = column(b, bs, sys),
                  C = column(c, cs, sys), D = column(d, ds, sys);
  // this system's modified rows: (a, c, d) of local row l at l * P + t
  const long long P = PART_THREADS;
  const long long plane = static_cast<long long>(gridDim.x) * M * P;
  T *wa = work + static_cast<long long>(j) * M * P + t;
  T *wc = wa + plane, *wd = wa + 2 * plane;
  const long long g0 = static_cast<long long>(t) * M;

  // down: rows 0 and 1 normalised; row l >= 2 rid of x_{l-1}, its a now
  // the coefficient of the chunk's first unknown x_0
  T ai, bi, ci, di;
  T ap, cp, dp;  // the row above, modified
  for (int l = 0; l < M; ++l) {
    load_row(A, B, C, D, g0 + l, n, ai, bi, ci, di);
    if (l < 2) {
      const T rb = T(1) / bi;
      ap = ai * rb;
      cp = ci * rb;
      dp = di * rb;
    } else {
      const T r = T(1) / (bi - ai * cp);
      dp = r * (di - ai * dp);
      ap = -r * ai * ap;
      cp = r * ci;
    }
    wa[l * P] = ap;
    wc[l * P] = cp;
    wd[l * P] = dp;
  }
  // the last row couples x_0 to the next chunk's first unknown
  T red_a[2], red_c[2], red_d[2];
  red_a[1] = ap;
  red_c[1] = cp;
  red_d[1] = dp;
  // up: rows M-3 .. 1 rid of x_{l+1}, their c now the coefficient of the
  // chunk's last unknown x_{M-1}
  T an = wa[(M - 2) * P], cn = wc[(M - 2) * P], dn = wd[(M - 2) * P];
  for (int l = M - 3; l >= 1; --l) {
    const T al = wa[l * P], cl = wc[l * P], dl = wd[l * P];
    dn = dl - cl * dn;
    an = al - cl * an;
    cn = -cl * cn;
    wa[l * P] = an;
    wc[l * P] = cn;
    wd[l * P] = dn;
  }
  // row 0 rid of x_1: it couples the previous chunk's last unknown to x_0
  // and x_{M-1}
  {
    const T a0 = wa[0], c0 = wc[0], d0 = wd[0];
    const T r = T(1) / (T(1) - c0 * an);
    red_d[0] = r * (d0 - c0 * dn);
    red_a[0] = r * a0;
    red_c[0] = -r * c0 * cn;
  }
  pcr<T, 2>(red_a, red_c, red_d, 2 * t, 2 * PART_THREADS, sm,
            2 * PART_THREADS);
  const T x0 = red_d[0], xl = red_d[1];
  T *xj = x + offset(xs, sys);
  for (int l = 0; l < M; ++l) {
    const long long g = g0 + l;
    if (g >= n) break;
    T v;
    if (l == 0) {
      v = x0;
    } else if (l == M - 1) {
      v = xl;
    } else {
      v = wd[l * P] - wa[l * P] * x0 - wc[l * P] * xl;
    }
    xj[g * xs.row] = v;
  }
}

template <typename T>
cudaError_t launch(const void *a, Strides as, const void *b, Strides bs,
                   const void *c, Strides cs, const void *d, Strides ds,
                   void *x, Strides xs, void *work, int n, int batch,
                   int inner, cudaStream_t s) {
  const T *A = static_cast<const T *>(a), *B = static_cast<const T *>(b),
          *C = static_cast<const T *>(c), *D = static_cast<const T *>(d);
  T *X = static_cast<T *>(x);
  if (n <= PCR_MAX_ROWS) {
    const int threads = (n + 31) / 32 * 32;
    const size_t shm = 6 * static_cast<size_t>(threads) * sizeof(T);
    tridiag_pcr_kernel<T><<<batch, threads, shm, s>>>(A, as, B, bs, C, cs, D,
                                                      ds, X, xs, n, inner);
  } else {
    if (work == nullptr) return cudaErrorInvalidValue;
    const int M = (n + PART_THREADS - 1) / PART_THREADS;
    const size_t shm = 6 * 2 * static_cast<size_t>(PART_THREADS) * sizeof(T);
    tridiag_partition_kernel<T><<<batch, PART_THREADS, shm, s>>>(
        A, as, B, bs, C, cs, D, ds, X, xs, static_cast<T *>(work), n, M,
        inner);
  }
  return cudaGetLastError();
}

}  // namespace
}  // namespace optpricer

using namespace optpricer;

// Solve batch tridiagonal systems of n rows. System j is (q, r) = (j /
// inner, j % inner); element (i, j) of a, b, c, d and x at i*row + r*col +
// q*outer (each its own strides). work: scratch of 3 * batch * ceil(n /
// 512) * 512 elements when n > 1024, else unused (may be null). is_double:
// 0 float, 1 double.
extern "C" int optpricer_thomas(
    const void *a, long long a_row, long long a_col, long long a_outer,
    const void *b, long long b_row, long long b_col, long long b_outer,
    const void *c, long long c_row, long long c_col, long long c_outer,
    const void *d, long long d_row, long long d_col, long long d_outer,
    void *x, long long x_row, long long x_col, long long x_outer, void *work,
    int n, int batch, int inner, int is_double, void *stream) {
  if (n < 1 || batch < 1 || inner < 1 || batch % inner != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Strides as{a_row, a_col, a_outer}, bs{b_row, b_col, b_outer},
      cs{c_row, c_col, c_outer}, ds{d_row, d_col, d_outer},
      xs{x_row, x_col, x_outer};
  cudaError_t err =
      is_double ? launch<double>(a, as, b, bs, c, cs, d, ds, x, xs, work, n,
                                 batch, inner, s)
                : launch<float>(a, as, b, bs, c, cs, d, ds, x, xs, work, n,
                                batch, inner, s);
  return static_cast<int>(err);
}
