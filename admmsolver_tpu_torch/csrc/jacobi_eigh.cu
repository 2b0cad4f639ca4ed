// Batched real-symmetric eigendecomposition by parallel-order Jacobi, for
// Hopper (sm_90a), CUDA C++.
//
// Replaces the JAX package's `jacobi_eigh` / `_jacobi_eigh_scan`
// (admmsolver_tpu/ops/linop.py:184-431).  That is no Pallas kernel: it is
// the route the JAX package takes on its accelerator for the PSD prox of
// every real slice up to n = 64 (f32: 32) and for the Gram SVD of the
// nuclear prox up to n = 256, because a batched library eigh inside a
// solver loop is slow there.  On this card the same holds for PyTorch's
// `torch.linalg.eigh`, which runs one cuSOLVER solve per slice above n = 32
// (~100 ms for 64 slices of 128 x 128 in float64 on an H100, chip_smoke.py
// phase 10d).
//
// What it computes, for each slice of a (batch, n, n), n even, 2..256:
// `sweeps` sweeps of n - 1 rounds of the circle-method schedule.  Round k of
// a sweep pairs the labels arr_k[t] and arr_k[n-1-t] for t < n/2, where
// arr_k = [0, then 1..n-1 rotated right by k]: every pair once a sweep, n/2
// disjoint pairs a round.  Each pair (p, q) is rotated by
//     theta = atan2(2 a_pq, a_qq - a_pp) / 2, folded to |theta| <= pi/4,
// columns first (A <- A G), then rows (A <- G^T A), and V <- V G.  The
// output is w = diag(A) and V, in label order, unsorted: the same rounds,
// angles and order of operations as the plain version
// (ops/kernels.py, jacobi_eigh_reference), which keeps the matrix in a
// permuted layout instead of indexing pairs by label.
//
// Design: one thread block a slice.  A round is two steps with a block-wide
// barrier after each: the n/2 angles (one thread each), then every 2x2
// block (rows p_i, q_i; columns p_j, q_j) of A rotated on both sides by one
// thread, and every row's pair of columns of V.  Pairs are disjoint, so no
// element is written twice in a round.  A and V live in shared memory where
// both fit one block (mode 0: 2 n^2 elements, float64 to n = 120, float32
// to n = 168), else both in device memory (mode 1, to n = 256).  The angle
// step also writes each pair's two labels
// to shared memory for the rotation step.  Consecutive threads take
// consecutive pairs, and the labels of consecutive pairs are mostly
// consecutive, so reads and writes are largely unit-stride.  All sweeps
// run in one launch.
//
// What bounds it on this card: operations.  A round costs about 9 n^2
// flops (12 for each of A's n^2/4 blocks, 6 for each of V's n^2/2 pairs), a
// call 9 n^2 (n - 1) sweeps per slice, against 16 n^2 bytes of device
// memory per slice read and written once.  The kernel is far from that
// bound: each round waits on two barriers and on n/2 atan2/sincos, and a
// block of a slice with n <= 16 keeps most of a warp idle.  Fusing several
// small slices a block, or a slice's rounds into registers, is later work.
#include <cuda_runtime.h>

#include <cstddef>

namespace {

constexpr int MODE_SHARED = 0;  // A and V in shared memory
constexpr int MODE_GLOBAL = 1;  // both in device memory

__device__ __forceinline__ float atan2_(float y, float x) { return atan2f(y, x); }
__device__ __forceinline__ double atan2_(double y, double x) { return atan2(y, x); }
__device__ __forceinline__ void sincos_(float x, float* s, float* c) { sincosf(x, s, c); }
__device__ __forceinline__ void sincos_(double x, double* s, double* c) { sincos(x, s, c); }
__device__ __forceinline__ float fold_(float th, float quarter, float half) {
  return fabsf(th) > quarter ? th - copysignf(half, th) : th;
}
__device__ __forceinline__ double fold_(double th, double quarter, double half) {
  return fabs(th) > quarter ? th - copysign(half, th) : th;
}

// Label at position t of round k's arrangement (circle method, n even).
__device__ __forceinline__ int label(int t, int k, int n) {
  if (t == 0) return 0;
  int r = (t - 1 - k) % (n - 1);
  return 1 + (r < 0 ? r + n - 1 : r);
}

// Shared memory of a block: the matrices the mode keeps there, then each
// pair's cos and sin (n values), then its two labels (n ints).
template <typename T>
size_t smem_bytes(int n, int mode) {
  const size_t nn = (size_t)n * n;
  return ((mode == MODE_SHARED ? 2 * nn : 0) + n) * sizeof(T) + n * sizeof(int);
}

template <typename T, int MODE>
__global__ void jacobi_kernel(const T* __restrict__ a, T* __restrict__ work, T* __restrict__ w,
                              T* __restrict__ v, int n, int sweeps) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* sm = reinterpret_cast<T*>(smem_raw);
  const int m = n / 2;
  const size_t nn = (size_t)n * n;
  const size_t slice = blockIdx.x;
  T* A = MODE == MODE_GLOBAL ? work + slice * nn : sm;
  T* V = MODE == MODE_SHARED ? sm + nn : v + slice * nn;
  T* cs = sm + (MODE == MODE_SHARED ? 2 * nn : 0);
  int* pq = reinterpret_cast<int*>(cs + n);  // pair t: labels pq[t], pq[m + t]
  const T* a_in = a + slice * nn;

  for (int e = threadIdx.x; e < (int)nn; e += blockDim.x) {
    A[e] = a_in[e];
    V[e] = (e / n == e % n) ? T(1) : T(0);
  }
  __syncthreads();

  const T quarter_pi = T(0.78539816339744830962);
  const T half_pi = T(1.57079632679489661923);
  const int rounds = sweeps * (n - 1);
  for (int r = 0; r < rounds; ++r) {
    const int k = r % (n - 1);
    for (int t = threadIdx.x; t < m; t += blockDim.x) {
      const int p = label(t, k, n), q = label(n - 1 - t, k, n);
      const T th = fold_(T(0.5) * atan2_(T(2) * A[p * n + q], A[q * n + q] - A[p * n + p]),
                         quarter_pi, half_pi);
      T s, c;
      sincos_(th, &s, &c);
      cs[t] = c;
      cs[m + t] = s;
      pq[t] = p;
      pq[m + t] = q;
    }
    __syncthreads();
    // A <- G^T (A G), one thread a 2x2 block (pair i's rows, pair j's columns)
    for (int e = threadIdx.x; e < m * m; e += blockDim.x) {
      const int i = e / m, j = e - (e / m) * m;
      const int pi = pq[i], qi = pq[m + i], pj = pq[j], qj = pq[m + j];
      const T ci = cs[i], si = cs[m + i], cj = cs[j], sj = cs[m + j];
      const T a00 = A[pi * n + pj], a01 = A[pi * n + qj];
      const T a10 = A[qi * n + pj], a11 = A[qi * n + qj];
      const T b00 = a00 * cj - a01 * sj, b01 = a00 * sj + a01 * cj;
      const T b10 = a10 * cj - a11 * sj, b11 = a10 * sj + a11 * cj;
      A[pi * n + pj] = b00 * ci - b10 * si;
      A[qi * n + pj] = b00 * si + b10 * ci;
      A[pi * n + qj] = b01 * ci - b11 * si;
      A[qi * n + qj] = b01 * si + b11 * ci;
    }
    // V <- V G, one thread a row's pair of columns
    for (int e = threadIdx.x; e < n * m; e += blockDim.x) {
      const int row = e / m, j = e - (e / m) * m;
      const int pj = pq[j], qj = pq[m + j];
      const T cj = cs[j], sj = cs[m + j];
      const T x0 = V[row * n + pj], x1 = V[row * n + qj];
      V[row * n + pj] = x0 * cj - x1 * sj;
      V[row * n + qj] = x0 * sj + x1 * cj;
    }
    __syncthreads();
  }

  for (int i = threadIdx.x; i < n; i += blockDim.x) w[slice * n + i] = A[i * n + i];
  if (MODE == MODE_SHARED)
    for (int e = threadIdx.x; e < (int)nn; e += blockDim.x) v[slice * nn + e] = V[e];
}

template <typename T, int MODE>
int launch(const T* a, T* work, T* w, T* v, int batch, int n, int sweeps, int threads,
           cudaStream_t stream) {
  const size_t smem = smem_bytes<T>(n, MODE);
  cudaError_t err = cudaFuncSetAttribute(
      jacobi_kernel<T, MODE>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  jacobi_kernel<T, MODE><<<batch, threads, smem, stream>>>(a, work, w, v, n, sweeps);
  return cudaGetLastError();
}

template <typename T>
int launch_mode(const void* a, void* work, void* w, void* v, int batch, int n, int sweeps,
                int mode, int threads, cudaStream_t stream) {
  const T* a_ = static_cast<const T*>(a);
  T* work_ = static_cast<T*>(work);
  T* w_ = static_cast<T*>(w);
  T* v_ = static_cast<T*>(v);
  switch (mode) {
    case MODE_SHARED:
      return launch<T, MODE_SHARED>(a_, work_, w_, v_, batch, n, sweeps, threads, stream);
    case MODE_GLOBAL:
      return launch<T, MODE_GLOBAL>(a_, work_, w_, v_, batch, n, sweeps, threads, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// Dynamic shared memory, in bytes, of one block for slices of n x n in
// float64 (f64 = 1) or float32, in `mode` (0: A and V shared, 1: neither).
size_t jacobi_eigh_smem_bytes(int n, int f64, int mode) {
  return f64 ? smem_bytes<double>(n, mode) : smem_bytes<float>(n, mode);
}

// The device's opt-in shared-memory limit per block, in bytes.
int jacobi_eigh_max_smem(int device, int* bytes) {
  return cudaDeviceGetAttribute(bytes, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
}

const char* jacobi_eigh_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

// Launch on `stream` without synchronising; returns cudaGetLastError() after
// the launch (0 on success).  a: (batch, n, n) input, row-major, not
// written; work: (batch, n, n) scratch, used in mode 1 only; w: (batch, n)
// and v: (batch, n, n) outputs.  n even, 2..256; one block of `threads`
// threads a slice.
int jacobi_eigh_launch(int device, const void* a, void* work, void* w, void* v, int batch, int n,
                       int sweeps, int f64, int mode, int threads, void* stream) {
  if (batch < 1 || n < 2 || n > 256 || n % 2 || sweeps < 0 || threads < 1 || threads > 1024)
    return cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  cudaStream_t s = (cudaStream_t)stream;
  return f64 ? launch_mode<double>(a, work, w, v, batch, n, sweeps, mode, threads, s)
             : launch_mode<float>(a, work, w, v, batch, n, sweeps, mode, threads, s);
}

}  // extern "C"
