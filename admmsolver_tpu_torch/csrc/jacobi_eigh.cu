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
// Three designs, chosen by the wrapper (ops/kernels.py, _jacobi_mode):
//
// Warp path, n <= 32 (mode 2).  One warp holds floor(32 / n) slices, one
// lane a column: lane L of a slice keeps column L of A and column L of V in
// registers, n values each, for the whole call; lanes past the last slice
// run along on zeros and store nothing.  Every loop over rows is unrolled
// and every register index is a constant, so A and V never leave the
// register file; there is no block barrier, only warp shuffles and
// __syncwarp.  A lane keeps one label's column for good (columns are never
// permuted), while the rows within a lane sit in the plain version's paired
// layout: round k's pairs are the row positions (2i, 2i+1), and each round
// ends with the plain version's permutation `pi` as a fixed register
// permutation (register moves, no shuffle).  That halves the shuffles of
// the plain version's layout, in which the columns are permuted too (a
// shuffle of every register of A and V a round), and keeps the round loop
// rolled (one body a type and n, where keeping the rows by label would
// need a sweep's n - 1 rounds unrolled).  A round of lane L, label L at
// position t of the circle arrangement (t advances by one a round):
//   angle     the pair's two rows of this column, positions 2i and 2i+1
//             (i is the lane's pair index, a runtime value: picked by a
//             tree of selects over the registers), swapped with the partner
//             lane by two shuffles; both lanes take a_pp and a_qq from the
//             diagonal and a_pq from row p of column q, as the plain
//             version does, and compute the same angle bit for bit
//             (atan2, the fold to |theta| <= pi/4, then sin and cos by a
//             polynomial on that range: sincos_folded);
//   columns   A <- A G and V <- V G: each register rotated with the partner
//             column's, fetched by one shuffle a register (A's before the
//             angle, so that the shuffles run under its latency);
//   rows      A <- G^T A: each register pair (2j, 2j+1) rotated by pair j's
//             (c, s), which the pair's first lane wrote to a 32-entry table
//             of the warp in shared memory (between two __syncwarp) and
//             every lane reads back as one 8- or 16-byte broadcast a pair.
// V's rows stay in label order.  Output: w (the diagonal, by label) and V,
// as the block kernel's; no scratch.  A block is one warp: the finest grain
// lets the block scheduler spread the warps evenly over the SMs (256
// slices of 32 x 32 are 256 warps, two an SM at most).
// What bounds it: the latency of a round, which is one dependent chain
// (select, shuffle, atan2 with its division and long polynomial, sin/cos,
// the table, then the rotations: ~6n flops and ~2n shuffles a lane, a
// float64 shuffle being two), with too few warps to hide it.  At n = 8, 4096 slices
// are 1024 warps, about two a scheduler, and the float64 atan2 is most of
// a round; at n = 32, 256 slices are 256 warps, at most one a scheduler,
// and the round's ~6n float64 flops run at 16 lanes a clock.  The flop
// bound of the `bound_ms` column (9 n^2 (n - 1) a sweep) is far below
// either (PERF.md).  Float32 keeps the same chain in float32 arithmetic.
// ptxas keeps every instantiation in registers, float64 n = 32 included
// (254 registers, no stack frame, no spill); chip_smoke.py 10d reads its
// report in the build log and fails on any local memory.
//
// Tile path, 34 <= n <= 128 (mode 3).  One thread block a slice and one
// __syncthreads a round.  Shared memory holds V transposed (Vt[l][row],
// n^2), A's strict upper triangle (n (n - 1) / 2 values, row-major: entry
// (a, b) of a != b at tri(min, max)) and, in two parities (r & 1), each
// pair's (c, s), the diagonal d (n) and each pair's pivot a_pq (e, n/2):
// (3 n^2 + 9 n) / 2 values, 201,216 bytes at float64 n = 128, so A and V
// stay on chip at every n of the path.  A is rotated in place: each of
// the m (m - 1) / 2 blocks of two pairs (m = n / 2) is read and written by
// one thread, once a round, so no entry is written twice in a round; the m
// diagonal blocks live in d and e and never touch A.  What makes one
// barrier enough: the next round's angles are computed in this round.  The
// circle schedule puts pair t of round k + 1 inside block (t - 1, t + 1)
// of round k (three exceptions at the ends, tile_block), and the thread
// that rotates that block takes the pair's a_pq from its own result,
// recomputes the pair's two diagonal entries from this round's d, e and
// (c, s) (tables no thread writes in this round), computes the angle
// (rotation_folded), writes the next round's tables, and stores the
// pivot entry of A at its value after the next round, since no block
// touches it then.  So a round reads only what the round before wrote.
// The first ceil(m / 32) warps take only those m pivot blocks, one a
// thread, so that the angle chain runs beside the rotations of the other
// warps; these take the other blocks (band dl of the circulant order,
// pairs i and i + dl mod m, consecutive threads on consecutive i) and V's
// m n / 2 items (pair j, rows 2 rp and 2 rp + 1 as one 16- or 8-byte
// vector, consecutive threads on consecutive rp: unit stride).  Threads:
// 256, 512 or 768 by n (_jacobi_threads, from a sweep on the H100).  The
// angle is the plain version's, atan2 and the fold, with sin and cos by
// sincos_folded (rotation_folded), not the library's sincos, whose slow
// path keeps a stack frame.  A rational form (t = tan theta as the smaller
// root of t^2 + 2 tau t - 1 = 0, c = 1 / sqrt(1 + t^2), s = t c) was timed
// against it on the H100 80GB HBM3 at 700 W: 2% faster in the block
// kernel's design (64 slices of 64 x 64, float64: 1.207 against 1.231 ms,
// the library's sincos 1.282), and in this path 2-5% faster at n <= 64 but
// 0.5-4% slower at n >= 96; and it left V four times less orthogonal
// (0.12-0.19 of 10 n eps against 0.02-0.05): its c^2 + s^2 strays from 1
// by 0.7 ulp rms where sin and cos stray by 0.3.  ptxas keeps both
// instantiations in registers (no stack frame, no spill; chip_smoke.py 10d
// fails otherwise).
// What bounds it, by estimate (a bank model at an assumed 1.755 GHz clock,
// not a profile): shared-memory bandwidth.  A round moves about 3 n^2
// values (A's triangle and V, each read and written once) through the SM's
// 128 bytes a clock, and most of A's accesses cost two wavefronts where one
// would do (a bank model of the schedule: the labels of a warp's blocks
// fall into two or three runs whose banks overlap).  At small n the
// barrier and the pivot warps' chain (one block, two diagonal entries,
// atan2 and sincos_folded) weigh more.  The flop bound of `bound_ms`,
// 9 n^2 (n - 1) a sweep over all 132 SMs, is far below it (PERF.md).
//
// Block path, any even n to 256 (modes 0 and 1; the default above n =
// 128).  One thread block a slice.  A round is two steps with a block-wide
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
// What bounds the block path on this card: operations.  A round costs about
// 9 n^2 flops (12 for each of A's n^2/4 blocks, 6 for each of V's n^2/2
// pairs), a call 9 n^2 (n - 1) sweeps per slice, against 16 n^2 bytes of
// device memory per slice read and written once.  The kernel is far from
// that bound: each round waits on two barriers and on n/2 atan2/sincos.
#include <cuda_runtime.h>

#include <cstddef>

namespace {

constexpr int MODE_SHARED = 0;  // A and V in shared memory
constexpr int MODE_GLOBAL = 1;  // both in device memory
constexpr int MODE_WARP = 2;    // n <= 32: A and V in registers, a lane a column
constexpr int MODE_TILE = 3;    // 34 <= n <= 128: one stored triangle of A, one barrier a round
constexpr int TILE_MIN_N = 34, TILE_MAX_N = 128, TILE_MAX_THREADS = 768;
constexpr int WARP_MAX_N = 32;
constexpr unsigned FULL_MASK = 0xffffffffu;

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

// sin and cos of a folded angle, |x| <= pi/4, by their Taylor series to
// x^15 / x^16 (float: x^9 / x^10), whose remainder there is below half an
// ulp (within 0.5 ulp of sin and cos over the range, measured).  The
// library's sincos would give the same to an ulp but keeps a slow path
// for large arguments that works in local memory and makes ptxas save
// registers around its call; the warp and tile paths must not leave
// registers.
__device__ __forceinline__ void sincos_folded(double x, double* s, double* c) {
  const double x2 = x * x;
  double ps = -1.0 / 1307674368000.0;
  ps = fma(ps, x2, 1.0 / 6227020800.0);
  ps = fma(ps, x2, -1.0 / 39916800.0);
  ps = fma(ps, x2, 1.0 / 362880.0);
  ps = fma(ps, x2, -1.0 / 5040.0);
  ps = fma(ps, x2, 1.0 / 120.0);
  ps = fma(ps, x2, -1.0 / 6.0);
  *s = fma(x * x2, ps, x);
  double pc = 1.0 / 20922789888000.0;
  pc = fma(pc, x2, -1.0 / 87178291200.0);
  pc = fma(pc, x2, 1.0 / 479001600.0);
  pc = fma(pc, x2, -1.0 / 3628800.0);
  pc = fma(pc, x2, 1.0 / 40320.0);
  pc = fma(pc, x2, -1.0 / 720.0);
  pc = fma(pc, x2, 1.0 / 24.0);
  pc = fma(pc, x2, -0.5);
  *c = fma(x2, pc, 1.0);
}
__device__ __forceinline__ void sincos_folded(float x, float* s, float* c) {
  const float x2 = x * x;
  float ps = 1.0f / 362880.0f;
  ps = fmaf(ps, x2, -1.0f / 5040.0f);
  ps = fmaf(ps, x2, 1.0f / 120.0f);
  ps = fmaf(ps, x2, -1.0f / 6.0f);
  *s = fmaf(x * x2, ps, x);
  float pc = -1.0f / 3628800.0f;
  pc = fmaf(pc, x2, 1.0f / 40320.0f);
  pc = fmaf(pc, x2, -1.0f / 720.0f);
  pc = fmaf(pc, x2, 1.0f / 24.0f);
  pc = fmaf(pc, x2, -0.5f);
  *c = fmaf(x2, pc, 1.0f);
}

// (c, s) of the plain version's folded angle: atan2, the fold, then
// sincos_folded.
template <typename T>
__device__ __forceinline__ void rotation_folded(T app, T apq, T aqq, T* c, T* s) {
  const T th = fold_(T(0.5) * atan2_(T(2) * apq, aqq - app), T(0.78539816339744830962),
                     T(1.57079632679489661923));
  sincos_folded(th, s, c);
}

// Label at position t of round k's arrangement (circle method, n even).
__device__ __forceinline__ int label(int t, int k, int n) {
  if (t == 0) return 0;
  int r = (t - 1 - k) % (n - 1);
  return 1 + (r < 0 ? r + n - 1 : r);
}

// The paired layout of the plain version (ops/kernels.py, _jacobi_layout):
// the label at row position j in round 0 (d0), and the permutation that
// takes each round's rows to the next round's (new row j = old row pi[j]).
__host__ __device__ constexpr int layout0(int j, int n) {
  return j % 2 == 0 ? j / 2 : n - 1 - j / 2;
}
__host__ __device__ constexpr int position0(int l, int n) {
  return l < n / 2 ? 2 * l : 2 * (n - 1 - l) + 1;
}
__host__ __device__ constexpr int arrangement1(int t, int n) {
  return t == 0 ? 0 : t == 1 ? n - 1 : t - 1;
}
__host__ __device__ constexpr int perm(int j, int n) {
  return position0(arrangement1(j % 2 == 0 ? j / 2 : n - 1 - j / 2, n), n);
}

template <typename T>
struct Rot;
template <>
struct Rot<float> {
  using type = float2;
};
template <>
struct Rot<double> {
  using type = double2;
};

// u[0] <- u[i] for a runtime i < LEN, by a tree of selects on i's bits:
// every index a constant, so u stays in registers.
template <int LEN, typename T>
__device__ __forceinline__ void pick(T* u, int i) {
  if constexpr (LEN > 1) {
    const bool hi = i & 1;
#pragma unroll
    for (int j = 0; j < (LEN + 1) / 2; ++j) {
      if (2 * j + 1 < LEN)
        u[j] = hi ? u[2 * j + 1] : u[2 * j];
      else
        u[j] = u[2 * j];
    }
    pick<(LEN + 1) / 2>(u, i >> 1);
  }
}

// The warp path (see the header): floor(32 / N) slices a warp, lane L of a
// slice holds column L of A (x, rows in the round's paired layout) and of V
// (y, rows by label).
template <typename T, int N>
__global__ void __launch_bounds__(32)
    jacobi_warp_kernel(const T* __restrict__ a, T* __restrict__ w, T* __restrict__ v,
                       int batch, int sweeps) {
  using T2 = typename Rot<T>::type;
  constexpr int M = N / 2, S = 32 / N;
  constexpr size_t NN = (size_t)N * N;
  __shared__ T2 table[32];  // each pair's (c, s), S * M <= 32
  const int lane = threadIdx.x;
  const int group = lane / N, base = group * N, L = lane - base;
  const long long slice = (long long)blockIdx.x * S + group;
  const bool active = group < S && slice < batch;
  T2* cs = table + group * M;  // idle lanes: entries no slice reads

  T x[N], y[N];
  const T* a_in = a + (active ? slice : 0) * NN + L;
#pragma unroll
  for (int r = 0; r < N; ++r) {
    x[r] = active ? a_in[layout0(r, N) * N] : T(0);
    y[r] = r == L ? T(1) : T(0);
  }

  const T quarter_pi = T(0.78539816339744830962);
  const T half_pi = T(1.57079632679489661923);
  const int rounds = sweeps * (N - 1);
  int t = L, k = 0;  // the label's position in round k's arrangement
  for (int r = 0; r < rounds; ++r) {
    const bool first = t < M;
    const int i = first ? t : N - 1 - t;
    const int partner = base + (t == N - 1 ? 0 : 1 + (3 * N - 4 - t - k) % (N - 1));
    T u[M], z[M];
#pragma unroll
    for (int j = 0; j < M; ++j) {
      u[j] = x[2 * j];
      z[j] = x[2 * j + 1];
    }
    pick<M>(u, i);
    pick<M>(z, i);
    T o[N];  // the partner's column of A, fetched while the angle is computed
#pragma unroll
    for (int j = 0; j < N; ++j) o[j] = __shfl_sync(FULL_MASK, x[j], partner);
    const T uo = __shfl_sync(FULL_MASK, u[0], partner);
    const T zo = __shfl_sync(FULL_MASK, z[0], partner);
    const T app = first ? u[0] : uo, apq = first ? uo : u[0], aqq = first ? zo : z[0];
    const T th =
        fold_(T(0.5) * atan2_(T(2) * apq, aqq - app), quarter_pi, half_pi);
    T s, c;
    sincos_folded(th, &s, &c);
    __syncwarp();  // every lane has read the last round's table
    if (first) cs[i] = T2{c, s};
    // columns: p <- p c - q s, q <- p s + q c
    const T sg = first ? -s : s;
#pragma unroll
    for (int j = 0; j < N; ++j) x[j] = x[j] * c + o[j] * sg;
#pragma unroll
    for (int j = 0; j < N; ++j) {
      const T ov = __shfl_sync(FULL_MASK, y[j], partner);
      y[j] = y[j] * c + ov * sg;
    }
    __syncwarp();  // the table is written
    // rows, pair j at positions (2j, 2j+1)
#pragma unroll
    for (int j = 0; j < M; ++j) {
      const T2 g = cs[j];
      const T r0 = x[2 * j], r1 = x[2 * j + 1];
      x[2 * j] = r0 * g.x - r1 * g.y;
      x[2 * j + 1] = r0 * g.y + r1 * g.x;
    }
    T nx[N];
#pragma unroll
    for (int j = 0; j < N; ++j) nx[j] = x[perm(j, N)];
#pragma unroll
    for (int j = 0; j < N; ++j) x[j] = nx[j];
    t = t == 0 ? 0 : t == N - 1 ? 1 : t + 1;
    k = k == N - 2 ? 0 : k + 1;
  }

  // After whole sweeps the rows are in round 0's layout again.
  T u[N];
#pragma unroll
  for (int j = 0; j < N; ++j) u[j] = x[j];
  pick<N>(u, position0(L, N));
  if (active) {
    w[slice * N + L] = u[0];
    T* v_out = v + slice * NN + L;
#pragma unroll
    for (int r = 0; r < N; ++r) v_out[r * N] = y[r];
  }
}

template <typename T, int N = 2>
int launch_warp(int n, const T* a, T* w, T* v, int batch, int sweeps, cudaStream_t stream) {
  if constexpr (N > WARP_MAX_N) {
    return cudaErrorInvalidValue;
  } else {
    if (n != N) return launch_warp<T, N + 2>(n, a, w, v, batch, sweeps, stream);
    constexpr int S = 32 / N;
    jacobi_warp_kernel<T, N><<<(batch + S - 1) / S, 32, 0, stream>>>(a, w, v, batch, sweeps);
    return cudaGetLastError();
  }
}

// Shared memory of a block: the matrices the mode keeps there, then each
// pair's cos and sin (n values), then its two labels (n ints).
template <typename T>
size_t smem_bytes(int n, int mode) {
  if (mode == MODE_WARP) return 0;  // a static table of 32 (c, s)
  const size_t nn = (size_t)n * n;
  // tile: V^T, two (c, s) tables, two diagonals, two pivot tables, A's
  // strict upper triangle
  if (mode == MODE_TILE) return (nn + 2 * n + 2 * n + n + nn / 2 - n / 2) * sizeof(T);
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

// The tile path (see the header).  A's strict upper triangle, row-major:
// entry (a, b) of a != b at tri(min, max).
__device__ __forceinline__ int tri(int a, int b, int n) {
  const int lo = min(a, b), hi = max(a, b);
  return ((lo * (2 * n - lo - 1)) >> 1) + hi - lo - 1;
}

// label(t, k, n) without the modulo (0 <= t < n, 0 <= k < n - 1).
__device__ __forceinline__ int tile_label(int t, int k, int n) {
  const int r = t - 1 - k;
  return t == 0 ? 0 : 1 + (r < 0 ? r + n - 1 : r);
}

// A pair's diagonal block [[app, apq], [apq, aqq]] after its rotation by
// (c, s), columns first and then rows as in the plain version: new a_pp,
// a_qq and a_pq.
template <typename T>
__device__ __forceinline__ T rotated_pp(T app, T apq, T aqq, T c, T s) {
  const T b00 = app * c - apq * s, b10 = apq * c - aqq * s;
  return b00 * c - b10 * s;
}
template <typename T>
__device__ __forceinline__ T rotated_qq(T app, T apq, T aqq, T c, T s) {
  const T b01 = app * s + apq * c, b11 = apq * s + aqq * c;
  return b01 * s + b11 * c;
}
template <typename T>
__device__ __forceinline__ T rotated_pq(T app, T apq, T aqq, T c, T s) {
  const T b01 = app * s + apq * c, b11 = apq * s + aqq * c;
  return b01 * c - b11 * s;
}

// Round k's rotation A <- G^T A G of the 2x2 block of pairs lo < hi, its
// four entries of the triangle A read and written in place (columns by pair
// hi first, then rows by pair lo).  With PIVOT the block holds the pivot of
// round k + 1's pair tn, and also computes that pair's two diagonal entries
// (from round k's tables d, e and (c, s) of parity cur), its angle, and the
// tables of parity cur ^ 1; the pivot entry skips to its value after round
// k + 1.  Pair tn = (p', q') sits in block (tn - 1, tn + 1) at (p_lo,
// q_hi), except pair 0 in (0, 1) at (p_0, q_1), pair 1 in (0, 2) at (q_0,
// q_2) and pair m - 1 in (m - 2, m - 1) at (p_lo, p_hi).
template <typename T, bool PIVOT>
__device__ __forceinline__ void tile_block(T* A, typename Rot<T>::type* cs, T* d, T* e, int cur,
                                           int lo, int hi, int tn, int k, int n, int m) {
  using T2 = typename Rot<T>::type;
  const int pi = tile_label(lo, k, n), qi = tile_label(n - 1 - lo, k, n);
  const int pj = tile_label(hi, k, n), qj = tile_label(n - 1 - hi, k, n);
  const int a00 = tri(pi, pj, n), a01 = tri(pi, qj, n), a10 = tri(qi, pj, n),
            a11 = tri(qi, qj, n);
  const T x00 = A[a00], x01 = A[a01], x10 = A[a10], x11 = A[a11];
  const T2 gi = cs[cur * m + lo], gj = cs[cur * m + hi];
  const T y00 = x00 * gj.x - x01 * gj.y, y01 = x00 * gj.y + x01 * gj.x;
  const T y10 = x10 * gj.x - x11 * gj.y, y11 = x10 * gj.y + x11 * gj.x;
  T z00 = y00 * gi.x - y10 * gi.y, z01 = y01 * gi.x - y11 * gi.y;
  const T z10 = y00 * gi.y + y10 * gi.x;
  T z11 = y01 * gi.y + y11 * gi.x;
  if (PIVOT) {
    const T* d_r = d + cur * n;
    const T* e_r = e + cur * m;
    const int nxt = cur ^ 1;
    const bool q_lo = tn == 1, p_hi = tn == m - 1;
    const T apq = q_lo ? z11 : p_hi ? z00 : z01;
    const T app = q_lo ? rotated_qq(d_r[pi], e_r[lo], d_r[qi], gi.x, gi.y)
                       : rotated_pp(d_r[pi], e_r[lo], d_r[qi], gi.x, gi.y);
    const T aqq = p_hi ? rotated_pp(d_r[pj], e_r[hi], d_r[qj], gj.x, gj.y)
                       : rotated_qq(d_r[pj], e_r[hi], d_r[qj], gj.x, gj.y);
    T c, s;
    rotation_folded(app, apq, aqq, &c, &s);
    cs[nxt * m + tn] = T2{c, s};
    e[nxt * m + tn] = apq;
    d[nxt * n + (q_lo ? qi : pi)] = app;
    d[nxt * n + (p_hi ? pj : qj)] = aqq;
    const T piv = rotated_pq(app, apq, aqq, c, s);
    if (q_lo)
      z11 = piv;
    else if (p_hi)
      z00 = piv;
    else
      z01 = piv;
  }
  A[a00] = z00;
  A[a01] = z01;
  A[a10] = z10;
  A[a11] = z11;
}

template <typename T>
__global__ void __launch_bounds__(TILE_MAX_THREADS)
    jacobi_tile_kernel(const T* __restrict__ a, T* __restrict__ w, T* __restrict__ v, int n,
                       int sweeps) {
  using T2 = typename Rot<T>::type;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int m = n / 2, nb = m * (m - 1) / 2, h = n / 2;
  const size_t nn = (size_t)n * n;
  const size_t slice = blockIdx.x;
  T* Vt = reinterpret_cast<T*>(smem_raw);  // Vt[l * n + row] = V[row][l]
  T2* cs = reinterpret_cast<T2*>(Vt + nn);  // round r's pair i: cs[(r & 1) * m + i]
  T* d = reinterpret_cast<T*>(cs + 2 * m);  // a_ll before round r: d[(r & 1) * n + l]
  T* e = d + 2 * n;                         // a_{p_i q_i} before round r: e[(r & 1) * m + i]
  T* A = e + 2 * m;                         // the strict upper triangle, tri()
  const T* a_in = a + slice * nn;
  const int tid = threadIdx.x, nt = blockDim.x;

  for (int x = tid; x < (int)nn; x += nt) {
    const int row = x / n, col = x - row * n;
    const T val = a_in[x];
    if (row < col)
      A[tri(row, col, n)] = val;
    else if (row == col)
      d[row] = val;
    Vt[x] = row == col ? T(1) : T(0);
  }
  __syncthreads();
  // Round 0's angles; each pivot entry of A takes its value after round 0.
  for (int t = tid; t < m; t += nt) {
    const int p = tile_label(t, 0, n), q = tile_label(n - 1 - t, 0, n), at = tri(p, q, n);
    const T app = d[p], apq = A[at], aqq = d[q];
    T c, s;
    rotation_folded(app, apq, aqq, &c, &s);
    cs[t] = T2{c, s};
    e[t] = apq;
    A[at] = rotated_pq(app, apq, aqq, c, s);
  }
  __syncthreads();

  // The first ceil(m / 32) warps rotate the m pivot blocks of the next
  // round, one a thread, and compute its angles.  The other warps (thread
  // tp of ntp) rotate the other blocks and V.  The blocks in the circulant
  // order u = (dl - 1) m + i (pairs i and i + dl mod m) are the pivot
  // blocks at u = 0, m - 2 and m .. 2m - 3; the other warps take the rest
  // as u' = tp + g ntp: u' < m the other m blocks of bands 1 and 2, u' >= m
  // block u = u' + m.  Their V items: u = tp + g ntp, pair j = u / h, row
  // pair rp = u % h.
  const int npt = (m + 31) / 32 * 32;
  const bool pivot_warp = tid < npt;
  const int tp = tid - npt, ntp = nt - npt;
  const int up0 = tp < m ? tp + ntp : tp;  // the first u' >= m
  const int i0 = (up0 + m) % m, dl0 = 1 + (up0 + m) / m;
  const int step_i = ntp % m, step_dl = ntp / m, step_j = ntp / h, step_rp = ntp % h;
  const int rounds = sweeps * (n - 1);
  for (int r = 0, k = 0; r < rounds; ++r, k = k == n - 2 ? 0 : k + 1) {
    const int cur = r & 1;
    if (pivot_warp) {
      const int tn = tid;
      if (tn < m) {
        const int lo = tn == 0 ? 0 : tn == m - 1 ? m - 2 : tn - 1;
        tile_block<T, true>(A, cs, d, e, cur, lo, tn == 0 ? 1 : tn == m - 1 ? m - 1 : tn + 1,
                            tn, k, n, m);
      }
    } else {
      if (tp < m) {
        const int i = tp < m - 3 ? tp + 1 : tp == m - 3 ? m - 1 : tp;
        int j = i + (tp < m - 2 ? 1 : 2);
        j -= j >= m ? m : 0;
        tile_block<T, false>(A, cs, d, e, cur, min(i, j), max(i, j), -1, k, n, m);
      }
      for (int up = up0, i = i0, dl = dl0; up < nb - m; up += ntp) {
        int j = i + dl;
        j -= j >= m ? m : 0;
        tile_block<T, false>(A, cs, d, e, cur, min(i, j), max(i, j), -1, k, n, m);
        i += step_i;
        dl += step_dl;
        if (i >= m) {
          i -= m;
          ++dl;
        }
      }
      // V <- V G: rows 2 rp and 2 rp + 1 of pair j's two columns (rows of Vt)
      const T2* cs_r = cs + cur * m;
      for (int u = tp, j = tp / h, rp = tp % h; u < m * h; u += ntp) {
        const T2 g = cs_r[j];
        T2* vp = reinterpret_cast<T2*>(Vt + tile_label(j, k, n) * n) + rp;
        T2* vq = reinterpret_cast<T2*>(Vt + tile_label(n - 1 - j, k, n) * n) + rp;
        const T2 x0 = *vp, x1 = *vq;
        *vp = T2{x0.x * g.x - x1.x * g.y, x0.y * g.x - x1.y * g.y};
        *vq = T2{x0.x * g.y + x1.x * g.x, x0.y * g.y + x1.y * g.x};
        j += step_j;
        rp += step_rp;
        if (rp >= h) {
          rp -= h;
          ++j;
        }
      }
    }
    __syncthreads();
  }

  const T* w_out = d + (rounds & 1) * n;
  for (int l = tid; l < n; l += nt) w[slice * n + l] = w_out[l];
  for (int x = tid; x < (int)nn; x += nt) {
    const int row = x / n, l = x - row * n;
    v[slice * nn + x] = Vt[l * n + row];
  }
}

template <typename T>
int launch_tile(const T* a, T* w, T* v, int batch, int n, int sweeps, int threads,
                cudaStream_t stream) {
  // the pivot warps and at least m threads beside them (each of which takes
  // one of the other blocks of bands 1 and 2)
  const int m = n / 2;
  if (n < TILE_MIN_N || n > TILE_MAX_N || threads % 32 || threads > TILE_MAX_THREADS ||
      threads < (m + 31) / 32 * 32 + m)
    return cudaErrorInvalidValue;
  const size_t smem = smem_bytes<T>(n, MODE_TILE);
  cudaError_t err = cudaFuncSetAttribute(
      jacobi_tile_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  jacobi_tile_kernel<T><<<batch, threads, smem, stream>>>(a, w, v, n, sweeps);
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
    case MODE_WARP:
      if (threads != 32) return cudaErrorInvalidValue;
      return launch_warp<T>(n, a_, w_, v_, batch, sweeps, stream);
    case MODE_TILE:
      return launch_tile<T>(a_, w_, v_, batch, n, sweeps, threads, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// Dynamic shared memory, in bytes, of one block for slices of n x n in
// float64 (f64 = 1) or float32, in `mode` (0: A and V shared, 1: neither,
// 2: the warp path, none, 3: the tile path).
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
// and v: (batch, n, n) outputs.  n even, 2..256; modes 0 and 1: one block
// of `threads` threads a slice; mode 2 (n <= 32): blocks of one warp
// (`threads` = 32), floor(32 / n) slices a block; mode 3 (34 <= n <= 128):
// one block of `threads` a slice, a multiple of 32, at most 768 and at
// least ceil(n / 64) warps plus n / 2.
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
