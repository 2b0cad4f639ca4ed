// Fused two-block ADMM chunk for Hopper (sm_90a), CUDA C++.
//
// Replaces the Pallas TPU kernel `fused_two_block_chunk`
// (admmsolver_tpu/ops/kernels.py:116, body `_iteration_body` at :56 and
// `_chunk_kernel` at :92).  It runs `n_iters` Gauss-Seidel ADMM iterations
// of the identity-coupled basis-pursuit / nonnegative family on every lane:
//
//     v   = acy + h + mu*x1
//     x0  = ((v U) * dinv) Ut            (+ v/mu in the thin rank-R form)
//     z   = x0 - h/mu
//     x1  = soft_threshold(z, thr) or max(z, 0); `_even` modes zero odd columns
//     h  += mu (x1 - x0)
//
// and returns (x0, x1, h, x0_prev), x0_prev being the x0 the last
// iteration started from.
//
// What bounds it on this card: the two products, 4*B*N*R FLOPs per
// iteration, run as full f32 FMA on the CUDA cores (TF32 keeps ~1e-3
// relative accuracy, which corrupts the shifted-quadratic solve), against
// the L2 reads of U and Ut: at N=512, R=256 each is 512 KiB, more than a
// block's 227 KB of shared memory, so every block streams both from L2 in
// k-tiles once per iteration.  That is 2*N*R*4 bytes of L2 traffic for
// 4*TB*N*R FLOPs, TB/2 FLOP per L2 byte for a tile of TB lanes.
//
// What the design does about it: one block owns TB lanes for the whole
// chunk and keeps their x0, x1, h, acy, v and the (TB,R) intermediate w in
// shared memory, so device memory sees the state once per chunk; the host
// side picks the largest TB whose footprint fits, to raise FLOPs per L2
// byte.  Each thread accumulates a TM x 4 register tile of each product
// from k-tiles of U/Ut staged in shared memory; the next k-tile's L2 loads
// are in flight while the current one is computed on.  Lanes are independent:
// blocks never synchronise with each other.  Ragged B, N and R edges are
// masked here; nothing needs padding to the TPU's 128-lane width.
//
// Plain C interface, loaded with ctypes (admmsolver_tpu_torch/ops/_build.py).

#include <cuda_runtime.h>
#include <stddef.h>

namespace {

constexpr int THREADS = 256;
constexpr int TILE = 4096;  // floats in one staged k-tile of U or Ut
constexpr int KPAD = 32;    // v and w rows are zero-padded to a multiple of this

__host__ __device__ inline int round_up(int a, int b) { return (a + b - 1) / b * b; }

template <int TB>
struct Layout {
  static constexpr int TM = TB < 4 ? TB : 4;  // rows (lanes) per thread
  static constexpr int RG = TB / TM;          // row groups
  static constexpr int CG = THREADS / RG;     // threads per row group
  static constexpr int TN = 4;                // columns per thread, CG apart
  static constexpr int CW = CG * TN;          // columns per pass
  static constexpr int KT = TILE / CW;        // depth of a k-tile
  static_assert(KPAD % KT == 0, "row padding must cover every k-tile");
  static_assert(KT % 4 == 0, "lane rows are read as float4 along k");
  static_assert(CG >= 32, "a warp must share its row group");
};

constexpr int PER_THREAD = TILE / THREADS;  // floats of a k-tile each thread fetches

// This thread's share of the k-tile of Bg starting at row k0, columns
// [c0, c0 + CW), zero past K and ncols, into registers.
template <int TB>
__device__ __forceinline__ void fetch_tile(float (&pre)[PER_THREAD],
                                           const float* __restrict__ Bg, int K,
                                           int ncols, int c0, int k0) {
  using L = Layout<TB>;
#pragma unroll
  for (int p = 0; p < PER_THREAD; ++p) {
    const int idx = threadIdx.x + p * THREADS;
    const int k = k0 + idx / L::CW;
    const int c = c0 + idx % L::CW;
    pre[p] = (k < K && c < ncols) ? __ldg(Bg + (size_t)k * ncols + c) : 0.f;
  }
}

// acc[i][j] = sum_k A_s[row_i * lda + k] * Bg[k * ncols + col_j] over k < K,
// for row_i = rg*TM + i and col_j = c0 + cg + j*CG, accumulated in k order.
// A_s lies in shared memory, 16-byte aligned, with rows zero-padded to
// lda >= round_up(K, KPAD); Bg is a row-major (K, ncols) matrix in global
// memory, staged through Bs one k-tile at a time while the next k-tile's
// loads are in flight.
template <int TB>
__device__ __forceinline__ void tile_product(
    const float* __restrict__ A_s, int lda, const float* __restrict__ Bg,
    int K, int ncols, int c0, float* __restrict__ Bs,
    float (&acc)[Layout<TB>::TM][Layout<TB>::TN], int rg, int cg) {
  using L = Layout<TB>;
#pragma unroll
  for (int i = 0; i < L::TM; ++i)
#pragma unroll
    for (int j = 0; j < L::TN; ++j) acc[i][j] = 0.f;

  float pre[PER_THREAD];
  fetch_tile<TB>(pre, Bg, K, ncols, c0, 0);
  for (int k0 = 0; k0 < K; k0 += L::KT) {
    // Every thread is done with the previous tile (and with whatever
    // shared state the caller wrote before this call).
    __syncthreads();
#pragma unroll
    for (int p = 0; p < PER_THREAD; ++p) Bs[threadIdx.x + p * THREADS] = pre[p];
    __syncthreads();
    if (k0 + L::KT < K) fetch_tile<TB>(pre, Bg, K, ncols, c0, k0 + L::KT);
#pragma unroll
    for (int kk = 0; kk < L::KT; kk += 4) {
      float a[L::TM][4];
#pragma unroll
      for (int i = 0; i < L::TM; ++i) {
        const float4 t = *reinterpret_cast<const float4*>(A_s + (rg * L::TM + i) * lda + k0 + kk);
        a[i][0] = t.x;
        a[i][1] = t.y;
        a[i][2] = t.z;
        a[i][3] = t.w;
      }
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        float b[L::TN];
#pragma unroll
        for (int j = 0; j < L::TN; ++j) b[j] = Bs[(kk + q) * L::CW + cg + j * L::CG];
#pragma unroll
        for (int i = 0; i < L::TM; ++i)
#pragma unroll
          for (int j = 0; j < L::TN; ++j) acc[i][j] = fmaf(a[i][q], b[j], acc[i][j]);
      }
    }
  }
}

size_t smem_bytes(int tb, int n, int r) {
  return sizeof(float) * ((size_t)5 * tb * round_up(n, KPAD) +
                          (size_t)tb * round_up(r, KPAD) + TILE + 2 * (size_t)tb);
}

// prox: bit 1 set = nonneg (else soft-threshold), bit 0 set = `_even` mode.
template <int TB>
__global__ void __launch_bounds__(THREADS) fused_two_block_kernel(
    const float* __restrict__ U, const float* __restrict__ Ut,
    const float* __restrict__ dinv, const float* __restrict__ acy,
    const float* __restrict__ mu, const float* __restrict__ thr,
    const float* __restrict__ x0, const float* __restrict__ x1,
    const float* __restrict__ h, float* __restrict__ x0o,
    float* __restrict__ x1o, float* __restrict__ ho, float* __restrict__ x0p,
    int B, int N, int R, int n_iters, int prox, int thin) {
  using L = Layout<TB>;
  extern __shared__ __align__(16) float smem[];
  const int Np = round_up(N, KPAD);
  const int Rp = round_up(R, KPAD);
  float* acy_s = smem;
  float* h_s = acy_s + TB * Np;
  float* x1_s = h_s + TB * Np;
  float* x0_s = x1_s + TB * Np;
  float* v_s = x0_s + TB * Np;
  float* w_s = v_s + TB * Np;
  float* Bs = w_s + TB * Rp;
  float* mu_s = Bs + TILE;
  float* thr_s = mu_s + TB;

  const int b0 = blockIdx.x * TB;
  const int rg = threadIdx.x / L::CG;
  const int cg = threadIdx.x % L::CG;
  const bool nonneg = prox & 2;
  const bool even = prox & 1;

  // Load the tile.  Lanes past B and columns past N hold zeros (mu = 1),
  // which stay zero and finite through every iteration.
  for (int idx = threadIdx.x; idx < TB * Np; idx += THREADS) {
    const int b = b0 + idx / Np, n = idx % Np;
    const bool ok = b < B && n < N;
    const size_t g = (size_t)b * N + n;
    acy_s[idx] = ok ? acy[g] : 0.f;
    h_s[idx] = ok ? h[g] : 0.f;
    x1_s[idx] = ok ? x1[g] : 0.f;
    x0_s[idx] = ok ? x0[g] : 0.f;
  }
  for (int idx = threadIdx.x; idx < TB * Rp; idx += THREADS) w_s[idx] = 0.f;
  for (int r = threadIdx.x; r < TB; r += THREADS) {
    const bool ok = b0 + r < B;
    mu_s[r] = ok ? mu[b0 + r] : 1.f;
    thr_s[r] = ok ? thr[b0 + r] : 0.f;
  }
  __syncthreads();
  for (int idx = threadIdx.x; idx < TB * Np; idx += THREADS)
    v_s[idx] = acy_s[idx] + h_s[idx] + mu_s[idx / Np] * x1_s[idx];

  for (int it = 0; it < n_iters; ++it) {
    const bool last = it == n_iters - 1;
    // w = (v U) * dinv.  tile_product's leading barrier orders these reads
    // after the writes of v.
    for (int c0 = 0; c0 < R; c0 += L::CW) {
      float acc[L::TM][L::TN];
      tile_product<TB>(v_s, Np, U, N, R, c0, Bs, acc, rg, cg);
#pragma unroll
      for (int i = 0; i < L::TM; ++i) {
        const int r = rg * L::TM + i, b = b0 + r;
#pragma unroll
        for (int j = 0; j < L::TN; ++j) {
          const int c = c0 + cg + j * L::CG;
          if (c < R) w_s[r * Rp + c] = b < B ? acc[i][j] * dinv[(size_t)b * R + c] : 0.f;
        }
      }
    }
    // x0 = w Ut (+ v/mu), prox, dual ascent, and the next iteration's v.
    // Each (lane, column) belongs to one thread, which alone reads and
    // writes its x0, x1, h and v here.
    for (int c0 = 0; c0 < N; c0 += L::CW) {
      float acc[L::TM][L::TN];
      tile_product<TB>(w_s, Rp, Ut, R, N, c0, Bs, acc, rg, cg);
#pragma unroll
      for (int i = 0; i < L::TM; ++i) {
        const int r = rg * L::TM + i, b = b0 + r;
        const float m = mu_s[r];
#pragma unroll
        for (int j = 0; j < L::TN; ++j) {
          const int n = c0 + cg + j * L::CG;
          if (n >= N) continue;
          const int e = r * Np + n;
          const float hh = h_s[e];
          float x0n = acc[i][j];
          if (thin) x0n += v_s[e] / m;
          const float z = x0n - hh / m;
          float x1n;
          if (nonneg) {
            x1n = z < 0.f ? 0.f : z;
          } else {
            const float s = fmaxf(fabsf(z) - thr_s[r], 0.f);
            x1n = z > 0.f ? s : (z < 0.f ? -s : z * 0.f);
          }
          if (even && (n & 1)) x1n = 0.f;
          const float hn = hh + m * (x1n - x0n);
          if (last && b < B) x0p[(size_t)b * N + n] = x0_s[e];
          x0_s[e] = x0n;
          x1_s[e] = x1n;
          h_s[e] = hn;
          v_s[e] = acy_s[e] + hn + m * x1n;
        }
      }
    }
  }
  __syncthreads();

  for (int idx = threadIdx.x; idx < TB * Np; idx += THREADS) {
    const int b = b0 + idx / Np, n = idx % Np;
    if (b >= B || n >= N) continue;
    const size_t g = (size_t)b * N + n;
    x0o[g] = x0_s[idx];
    x1o[g] = x1_s[idx];
    ho[g] = h_s[idx];
    if (n_iters == 0) x0p[g] = x0_s[idx];
  }
}

template <int TB>
int launch(const float* U, const float* Ut, const float* dinv, const float* acy,
           const float* mu, const float* thr, const float* x0, const float* x1,
           const float* h, float* x0o, float* x1o, float* ho, float* x0p, int B,
           int N, int R, int n_iters, int prox, int thin, cudaStream_t stream) {
  const size_t smem = smem_bytes(TB, N, R);
  cudaError_t err = cudaFuncSetAttribute(
      fused_two_block_kernel<TB>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((B + TB - 1) / TB);
  fused_two_block_kernel<TB><<<grid, THREADS, smem, stream>>>(
      U, Ut, dinv, acy, mu, thr, x0, x1, h, x0o, x1o, ho, x0p, B, N, R, n_iters, prox, thin);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Dynamic shared memory, in bytes, of a block of `tb` lanes.
size_t fused_two_block_smem_bytes(int tb, int n, int r) { return smem_bytes(tb, n, r); }

// The device's opt-in shared-memory limit per block, in bytes.
int fused_two_block_max_smem(int device, int* bytes) {
  return cudaDeviceGetAttribute(bytes, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
}

const char* fused_two_block_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

// Launch on `stream` without synchronising; returns cudaGetLastError()
// after the launch (0 on success).  tb must be 1, 2, 4, 8, 16 or 32.
int fused_two_block_chunk(int device, const float* U, const float* Ut,
                          const float* dinv, const float* acy, const float* mu,
                          const float* thr, const float* x0, const float* x1,
                          const float* h, float* x0o, float* x1o, float* ho,
                          float* x0p, int B, int N, int R, int n_iters, int prox,
                          int thin, int tb, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  cudaStream_t s = (cudaStream_t)stream;
#define FTB_LAUNCH(T)                                                                   \
  case T:                                                                               \
    return launch<T>(U, Ut, dinv, acy, mu, thr, x0, x1, h, x0o, x1o, ho, x0p, B, N, R, \
                     n_iters, prox, thin, s);
  switch (tb) {
    FTB_LAUNCH(1)
    FTB_LAUNCH(2)
    FTB_LAUNCH(4)
    FTB_LAUNCH(8)
    FTB_LAUNCH(16)
    FTB_LAUNCH(32)
    default:
      return cudaErrorInvalidValue;
  }
#undef FTB_LAUNCH
}

}  // extern "C"
