// The SpM chunk's per-lane factor refresh for Hopper (sm_90a), CUDA C++: one
// launch where the plain version (ops/kernels.py,
// spm_factor_refresh_reference) makes about twenty (a batched Cholesky, a
// triangular solve against I, a product, the same three again for the
// sum-rule block, four batched products and the elementwise steps).
//
// It replaces no Pallas kernel.  The JAX package makes these factors in
// XLA (admmsolver_tpu/parallel/fused_spm.py, `_factors`) through
// `inv_hpd_schur`, an unpivoted block LDL (admmsolver_tpu/ops/linop.py:124);
// on this card the library's batched routines for tiny matrices take as
// long as the 100-iteration SpM chunk kernel they feed.
//
// What it computes, for each lane b of B:
//
//     Mpen = alpha_b AcA + mu1_b I + mu2_b W          (nl x nl, HPD)
//     Bf   = Mpen^{-1}
//     nc = 0:  M = Bf,  b2 = alpha_b Bf acy_b
//     nc > 0:  xi2 = -Bf C^T,  S = C xi2,  Sinv = -(-S)^{-1}
//              M  = Bf - xi2 Sinv (C Bf)
//              b2 = alpha_b M acy_b + xi2 Sinv D
//
// AcA, W (nl x nl), C (nc x nl) and D (nc) are shared by all lanes; alpha,
// mu1, mu2 (B, strided) and acy (B, nl, row stride given) are the lanes'.
// Outputs: M (B, nl, nl) and b2 (B, nl), contiguous, and info (B) int32:
// 0, or the 1-based column of the first pivot that is not positive and
// finite (k + 1 for Mpen's column k, nl + c + 1 for -S's column c), as
// torch.linalg.cholesky_ex reports a leading minor that is not positive
// definite.  Like cholesky_ex the kernel reads only the lower triangles of
// AcA, W and S.
//
// Two kernels compute it.  spm_factor_refresh_kernel<NP> ("warp", nl <= 32,
// nc <= 4, the SpM problem's own widths):
// one warp a lane, thread j holding column j of the matrix in
// registers (NP values; NP = 8, 16 or 32 by instantiation, the smallest that
// holds nl; the padding is the identity's, so that sweeping its pivots leaves
// the real block as it is).  The inverse is the symmetric sweep
// (Gauss-Jordan without pivoting, which positive definite matrices need
// none of): sweeping pivot k of a symmetric A takes
//
//     v_i = a_ki / sqrt(a_kk);   a_ij <- a_ij - v_i v_j      (i, j != k)
//     a_ik = a_ki <- v_i / sqrt(a_kk);   a_kk <- -1 / a_kk
//
// and the nl sweeps leave -A^{-1}.  The pivot a_kk is the Schur complement
// of the leading k x k block, the square of Cholesky's L_kk, so its sign is
// Cholesky's test.  Every entry is rounded the same way as its mirror (a
// fused v_i v_j is symmetric), so the matrix stays bitwise symmetric and row
// k is column k: each sweep, thread j computes v_j from its own register for
// row k, writes it to a buffer of NP floats in shared memory (the buffer's
// two halves alternating, so that one __syncwarp a sweep suffices) and every
// thread reads the row back as NP / 4 broadcast 16-byte loads; the pivot
// itself comes from a shuffle, so that the row is stored already scaled.
// The sweep loop stays rolled: each sweep rotates the
// registers down one (register i takes the result of row k + i + 1), so that
// the pivot is always register 0 and every index is a constant, and thread j
// writes v_j to the buffer's slot j - k (mod NP), where register i finds row
// k + i.  After NP sweeps the registers are in row order again.  1 /
// sqrt(a_kk) is the hardware's reciprocal square root (MUFU.RSQ; the same
// bits as __frsqrt_rn on every lane tried), -1 / a_kk its square with one
// Newton step: neither needs a branch.  -S (nc x nc) goes through the same
// sweep in every thread's registers, which gives Sinv directly; each thread
// then folds its own column, M[:, j] = Bf[:, j] - xi2 Sinv (C Bf)[:, j]
// ((C Bf)[:, j] being -xi2[j, :] by Bf's symmetry), reading xi2's rows from
// shared memory, and b2[j] from its own column of M (M's row j but for
// rounding) and acy.  The matrix is kept negated from the sweep on (-Bf, -M:
// the signs ride on the fused multiply-adds) and negated as it is stored.
// AcA and W go to shared memory once a block of eight lanes, read row by row
// from their lower triangles (every load issued before any store) and
// mirrored; C and D too.
//
// What bounds it on this card: bytes, far below what it takes.  At B = 4096,
// nl = 30 it writes M, 14.7 MB (4.7 us with its inputs at 3.35 TB/s), and
// does ~4096 x 30k multiply-adds (~4 us at 67 TFLOP/s).  It takes ~29 us on
// an H100 (PERF.md), against ~0.40 ms for the plain version: the sweeps
// issue ~100 instructions each (31 selects and 31 fused multiply-adds of the
// update, the row's 8 loads, the pivot's chain), 32 of them a lane, and the
// warps that hold the SMs' schedulers issue them at close to the peak rate;
// the rest is the staging's and the fold's latency.  Measured on the way
// (H100, the same shape): the unscaled row read back first and the pivot
// taken from it, with IEEE sqrt and division, 50 us; the sweeps unrolled
// over 32 steps, as fast as rolled but ~4x the code; the correctly rounded
// __frsqrt_rn and __frcp_rn, +7 us; four warps a block, +7%; 64 registers
// forced for one wave of blocks, no faster (it spills).
//
// spm_factor_refresh_block_kernel ("block", every other nl and nc): one block
// of 256 threads a lane, the matrix in shared memory (nl^2 + 3 nc nl + 2 nl
// floats and a few more, so nl up to ~230 within the card's 227 KB), the same
// symmetric sweep of the lower triangle over the whole block with two
// barriers a pivot, then the sum-rule fold with -S swept the same way: the
// same arithmetic as the warp kernel but for the order of some sums.  It is
// there so that every shape a solve hands over runs hand-written code; the
// benchmark's shape never takes it.  On an H100 at B = 4096 it beats the
// library's Cholesky inverses up to nl = 64 (1.18 against 1.64 ms) and
// trails them at nl = 128 (7.68 against 6.54 ms; PERF.md).

#include <cuda_runtime.h>

#include <cmath>
#include <cstddef>

namespace {

constexpr unsigned FULL_MASK = 0xffffffffu;
constexpr int WARPS = 8;  // lanes (warps) a block
constexpr int NC_MAX = 4;

template <int NP>
struct Shared {
  float aca[NP * NP];  // AcA, mirrored from its lower triangle, zero padded
  float w[NP * NP];    // W, the same
  __align__(16) float c[NC_MAX * NP];
  float d[NC_MAX];
  // a warp's own: the sweep's row (two halves), xi2 by column, acy
  __align__(16) float row[WARPS][2 * NP];
  __align__(16) float xi[WARPS][NC_MAX * NP];
  __align__(16) float acy[WARPS][NP];
};

// The NP values of s (16-byte aligned) into v, as broadcast loads.
template <int NP>
__device__ __forceinline__ void load_row(const float* s, float* v) {
#pragma unroll
  for (int q = 0; q < NP / 4; ++q) {
    const float4 t = reinterpret_cast<const float4*>(s)[q];
    v[4 * q] = t.x;
    v[4 * q + 1] = t.y;
    v[4 * q + 2] = t.z;
    v[4 * q + 3] = t.w;
  }
}

// The symmetric sweep of the n x n matrix x (n <= NC_MAX, held alike by
// every thread) on each of its pivots: x <- -x^{-1}.  The first pivot that
// is not positive and finite sets *bad to base + its column + 1.
__device__ __forceinline__ void sweep_small(float (&x)[NC_MAX][NC_MAX], int n, int base,
                                            int* bad) {
#pragma unroll
  for (int k = 0; k < NC_MAX; ++k) {
    if (k < n) {
      const float p = x[k][k];
      if (!(p > 0.f && p < INFINITY) && *bad == 0) *bad = base + k + 1;
      const float rs = __frsqrt_rn(p);
      float v[NC_MAX];
#pragma unroll
      for (int i = 0; i < NC_MAX; ++i) v[i] = __fmul_rn(x[k][i], rs);
#pragma unroll
      for (int i = 0; i < NC_MAX; ++i) {
#pragma unroll
        for (int j = 0; j < NC_MAX; ++j)
          if (i != k && j != k) x[i][j] = __fmaf_rn(-v[i], v[j], x[i][j]);
      }
#pragma unroll
      for (int i = 0; i < NC_MAX; ++i) {
        if (i != k) x[i][k] = x[k][i] = __fmul_rn(v[i], rs);
      }
      x[k][k] = -__frcp_rn(p);
    }
  }
}

template <int NP>
__global__ void __launch_bounds__(WARPS * 32)
    spm_factor_refresh_kernel(const float* __restrict__ aca, const float* __restrict__ wmat,
                              const float* __restrict__ cmat, const float* __restrict__ dvec,
                              const float* __restrict__ alpha, const float* __restrict__ mu1,
                              const float* __restrict__ mu2, const float* __restrict__ acy,
                              float* __restrict__ m_out, float* __restrict__ b2_out,
                              int* __restrict__ info_out, int batch, int nl, int nc,
                              int alpha_stride, int mu1_stride, int mu2_stride, int acy_stride) {
  __shared__ Shared<NP> sh;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const long long b = (long long)blockIdx.x * WARPS + warp;
  const bool live = b < batch, col = lane < nl;  // col: a thread of a real column
  // the lane's own inputs first, so that their loads overlap the staging
  float al = 0.f, m1 = 0.f, m2 = 0.f, y = 0.f;
  if (live) {
    al = alpha[b * alpha_stride];
    m1 = mu1[b * mu1_stride];
    m2 = mu2[b * mu2_stride];
    if (col) y = acy[b * acy_stride + lane];
  }
  // AcA and W: row-major reads of the lower triangles, each entry stored at
  // (i, j) and (j, i); the padding rows and columns zero
  constexpr int STAGE = (NP * NP + WARPS * 32 - 1) / (WARPS * 32);
  float sa[STAGE], sw[STAGE];
#pragma unroll
  for (int s = 0; s < STAGE; ++s) {  // every load first (in bounds, then masked), then the stores
    const int e = s * WARPS * 32 + threadIdx.x, i = e / NP, j = e % NP;
    const int at = (i < nl ? i : nl - 1) * nl + (j < nl ? j : nl - 1);
    sa[s] = aca[at];
    sw[s] = wmat[at];
  }
#pragma unroll
  for (int s = 0; s < STAGE; ++s) {
    const int e = s * WARPS * 32 + threadIdx.x, i = e / NP, j = e % NP;
    if (e < NP * NP && j <= i) {
      const bool in = i < nl;
      sh.aca[i * NP + j] = sh.aca[j * NP + i] = in ? sa[s] : 0.f;
      sh.w[i * NP + j] = sh.w[j * NP + i] = in ? sw[s] : 0.f;
    }
  }
#pragma unroll
  for (int e0 = 0; e0 < NC_MAX * NP; e0 += WARPS * 32) {
    const int e = e0 + threadIdx.x, c = e / NP, i = e % NP;
    if (e < NC_MAX * NP) sh.c[e] = c < nc && i < nl ? cmat[c * nl + i] : 0.f;
  }
  if (threadIdx.x < NC_MAX) sh.d[threadIdx.x] = threadIdx.x < nc ? dvec[threadIdx.x] : 0.f;
  if (lane < NP) sh.acy[warp][lane] = y;
  __syncthreads();
  if (!live) return;  // the whole warp: no block barrier follows

  // column `lane` of Mpen (the plain version's order: alpha AcA + mu1 I, then + mu2 W);
  // padding columns are the identity's, so sweeping their pivots leaves the rest as it is
  float a[NP];
#pragma unroll
  for (int i = 0; i < NP; ++i) {
    const int e = i * NP + (lane < NP ? lane : 0);
    a[i] = col ? __fmaf_rn(m2, sh.w[e], __fmaf_rn(al, sh.aca[e], i == lane ? m1 : 0.f))
               : (i == lane ? 1.f : 0.f);
  }

  // NP sweeps, the loop rolled; each ends by rotating the registers down one
  // (a[i] takes row i + 1's result), so that pivot k is always a[0] and after
  // NP sweeps a[i] holds row i again.  Thread j writes its v to the buffer's
  // slot j - k (mod NP), where register i of every thread finds v of row k + i.
  int bad = 0;
  float* const buf = sh.row[warp];
  int half = 0, slot = lane & (NP - 1);  // the buffer's half and this thread's slot, j - k mod NP
#pragma unroll 1
  for (int k = 0; k < NP; ++k) {
    // a padding pivot is 1, so only a real one can fail (NaN fails too)
    const float p = __shfl_sync(FULL_MASK, a[0], k & 31);
    if (!(p > 0.f && p < INFINITY) && bad == 0) bad = k + 1;
    const float rs = rsqrtf(p);  // MUFU.RSQ
    const float vj = __fmul_rn(a[0], rs);  // v of this thread's column
    if (lane < NP) buf[half + slot] = vj;
    __syncwarp();
    float v[NP];
    load_row<NP>(buf + half, v);
    const bool own = lane == k;
    const float t = own ? -rs : vj;
#pragma unroll
    for (int i = 1; i < NP; ++i) a[i - 1] = __fmaf_rn(-v[i], t, own ? 0.f : a[i]);
    // 1 / p from rs^2 and one Newton step, without the branch of a division
    const float r2 = __fmul_rn(rs, rs);
    a[NP - 1] = own ? -__fmaf_rn(r2, __fmaf_rn(-p, r2, 1.f), r2) : __fmul_rn(vj, rs);
    half ^= NP;
    slot = (slot - 1) & (NP - 1);
  }
  // a holds -Bf's column `lane`; rows past nl are zero

  float fold = 0.f;
  if (nc > 0) {
    // -(C Bf)[:, lane] = xi2[lane, :]
    float xi[NC_MAX];
#pragma unroll
    for (int c = 0; c < NC_MAX; ++c) {
      xi[c] = 0.f;
      if (c < nc) {
        float cr[NP];
        load_row<NP>(sh.c + c * NP, cr);
#pragma unroll
        for (int i = 0; i < NP; ++i) xi[c] = __fmaf_rn(a[i], cr[i], xi[c]);
      }
    }
    // -S = C Bf C^T over the warp (a butterfly: every thread the same bits);
    // its lower triangle, mirrored, through the sweep gives Sinv
    float x[NC_MAX][NC_MAX];
#pragma unroll
    for (int c = 0; c < NC_MAX; ++c) {
#pragma unroll
      for (int d = 0; d <= c; ++d) {
        float s = 0.f;
        if (c < nc) {  // the whole warp
          if (col) s = -__fmul_rn(sh.c[c * NP + lane], xi[d]);
#pragma unroll
          for (int off = 16; off; off >>= 1)
            s = __fadd_rn(s, __shfl_xor_sync(FULL_MASK, s, off));
        }
        x[c][d] = x[d][c] = s;
      }
    }
    sweep_small(x, nc, nl, &bad);
    // -q = Sinv xi2[lane, :]; xi2's rows to every thread
    float q[NC_MAX];
#pragma unroll
    for (int c = 0; c < NC_MAX; ++c) {
      q[c] = 0.f;
#pragma unroll
      for (int d = 0; d < NC_MAX; ++d)
        if (d < nc) q[c] = __fmaf_rn(x[c][d], xi[d], q[c]);
    }
    if (lane < NP) {
#pragma unroll
      for (int c = 0; c < NC_MAX; ++c) sh.xi[warp][c * NP + lane] = xi[c];
    }
    __syncwarp();
    // M = Bf - xi2 Sinv (C Bf), column `lane`, kept negated: a += xi2[:, c] q[c]
#pragma unroll
    for (int c = 0; c < NC_MAX; ++c) {
      if (c < nc) {
        float xr[NP];
        load_row<NP>(sh.xi[warp] + c * NP, xr);
#pragma unroll
        for (int i = 0; i < NP; ++i) a[i] = __fmaf_rn(-xr[i], q[c], a[i]);
      }
    }
    // xi2[lane, :] Sinv D
#pragma unroll
    for (int c = 0; c < NC_MAX; ++c) {
      float sd = 0.f;
#pragma unroll
      for (int d = 0; d < NC_MAX; ++d)
        if (d < nc) sd = __fmaf_rn(x[c][d], sh.d[d], sd);
      if (c < nc) fold = __fmaf_rn(xi[c], sd, fold);
    }
  }
  if (!col) return;

  // b2[lane] from column `lane` of M and acy (staged before the block barrier)
  float ay[NP];
  load_row<NP>(sh.acy[warp], ay);
  float my = 0.f;
#pragma unroll
  for (int i = 0; i < NP; ++i) my = __fmaf_rn(a[i], ay[i], my);
  float* mo = m_out + b * nl * nl + lane;
#pragma unroll
  for (int i = 0; i < NP; ++i, mo += nl)
    if (i < nl) *mo = -a[i];
  b2_out[b * nl + lane] = nc > 0 ? __fmaf_rn(-al, my, fold) : -__fmul_rn(al, my);
  if (lane == 0) info_out[b] = bad;
}

template <int NP>
cudaError_t launch(const void* aca, const void* w, const void* c, const void* d,
                   const void* alpha, const void* mu1, const void* mu2, const void* acy, void* m,
                   void* b2, void* info, int batch, int nl, int nc, int sa, int s1, int s2,
                   int sy, cudaStream_t stream) {
  const int blocks = (batch + WARPS - 1) / WARPS;
  spm_factor_refresh_kernel<NP><<<blocks, WARPS * 32, 0, stream>>>(
      (const float*)aca, (const float*)w, (const float*)c, (const float*)d,
      (const float*)alpha, (const float*)mu1, (const float*)mu2, (const float*)acy, (float*)m,
      (float*)b2, (int*)info, batch, nl, nc, sa, s1, s2, sy);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------
// "block": one block a lane, the matrix in shared memory, any nl and nc
// ---------------------------------------------------------------------

constexpr int BLOCK_THREADS = 256;

// Offsets, in floats, of the block kernel's dynamic shared memory: the
// matrix, the sweep's row, xi2 by column, Sinv xi2^T by row, -S (then Sinv),
// Sinv D, C, D and acy.
struct BlockDims {
  int a, v, xi, q, s, sd, c, d, y, total;
};

__host__ __device__ inline BlockDims block_dims(int nl, int nc) {
  BlockDims m;
  m.a = 0;
  m.v = m.a + nl * nl;
  m.xi = m.v + (nl > nc ? nl : nc);
  m.q = m.xi + nc * nl;
  m.s = m.q + nc * nl;
  m.sd = m.s + nc * nc;
  m.c = m.sd + nc;
  m.d = m.c + nc * nl;
  m.y = m.d + nc;
  m.total = m.y + nl;
  return m;
}

// The symmetric sweep of the n x n matrix a (shared, row-major, symmetric)
// on each of its pivots, by the whole block: a <- -a^{-1}, with the warp
// kernel's arithmetic.  Only the lower triangle is swept (row k of the
// matrix is its column k), then mirrored.  v: n floats of shared scratch.
// The first pivot that is not positive and finite sets thread 0's bad to
// base + its column + 1.
__device__ void block_sweep(float* __restrict__ a, int n, float* __restrict__ v, int base,
                            int& bad) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int k = 0; k < n; ++k) {
    const float p = a[k * n + k];
    if (threadIdx.x == 0 && !(p > 0.f && p < INFINITY) && bad == 0) bad = base + k + 1;
    const float rs = rsqrtf(p);
    for (int i = threadIdx.x; i < n; i += BLOCK_THREADS)
      v[i] = __fmul_rn(a[i < k ? k * n + i : i * n + k], rs);
    __syncthreads();
    const float r2 = __fmul_rn(rs, rs);
    const float pinv = __fmaf_rn(r2, __fmaf_rn(-p, r2, 1.f), r2);  // 1 / p
    for (int i = warp; i < n; i += BLOCK_THREADS / 32) {
      const float vi = v[i];
#pragma unroll 4
      for (int j = lane; j <= i; j += 32) {
        float& x = a[i * n + j];
        if (i != k && j != k)
          x = __fmaf_rn(-vi, v[j], x);
        else if (i != k || j != k)
          x = __fmul_rn(i == k ? v[j] : vi, rs);
        else
          x = -pinv;
      }
    }
    __syncthreads();
  }
  for (int i = warp; i < n; i += BLOCK_THREADS / 32)
    for (int j = lane; j < i; j += 32) a[j * n + i] = a[i * n + j];
  __syncthreads();
}

__global__ void __launch_bounds__(BLOCK_THREADS)
    spm_factor_refresh_block_kernel(const float* __restrict__ aca,
                                    const float* __restrict__ wmat,
                                    const float* __restrict__ cmat,
                                    const float* __restrict__ dvec,
                                    const float* __restrict__ alpha,
                                    const float* __restrict__ mu1,
                                    const float* __restrict__ mu2,
                                    const float* __restrict__ acy, float* __restrict__ m_out,
                                    float* __restrict__ b2_out, int* __restrict__ info_out,
                                    int nl, int nc, int alpha_stride, int mu1_stride,
                                    int mu2_stride, int acy_stride) {
  extern __shared__ float4 smem4[];
  float* const sh = reinterpret_cast<float*>(smem4);
  const BlockDims m = block_dims(nl, nc);
  float *a = sh + m.a, *v = sh + m.v, *xi = sh + m.xi, *q = sh + m.q, *s = sh + m.s,
        *sd = sh + m.sd, *c = sh + m.c, *d = sh + m.d, *y = sh + m.y;
  const long long b = blockIdx.x;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const float al = alpha[b * alpha_stride], m1 = mu1[b * mu1_stride], m2 = mu2[b * mu2_stride];
  // Mpen from the lower triangles of AcA and W, mirrored (the warp kernel's order)
  for (int i = warp; i < nl; i += BLOCK_THREADS / 32) {
    for (int j = lane; j <= i; j += 32) {
      const float x = __fmaf_rn(m2, wmat[i * nl + j],
                                __fmaf_rn(al, aca[i * nl + j], i == j ? m1 : 0.f));
      a[i * nl + j] = x;
      a[j * nl + i] = x;
    }
  }
  for (int e = threadIdx.x; e < nc * nl; e += BLOCK_THREADS) c[e] = cmat[e];
  for (int e = threadIdx.x; e < nc; e += BLOCK_THREADS) d[e] = dvec[e];
  for (int e = threadIdx.x; e < nl; e += BLOCK_THREADS) y[e] = acy[b * acy_stride + e];
  __syncthreads();

  int bad = 0;
  block_sweep(a, nl, v, 0, bad);  // a = -Bf
  if (nc > 0) {
    // xi[c][i] = (-Bf C^T)[i][c] = xi2[i][c]
    for (int e = threadIdx.x; e < nc * nl; e += BLOCK_THREADS) {
      const int r = e / nl, i = e - r * nl;
      float t = 0.f;
      for (int j = 0; j < nl; ++j) t = __fmaf_rn(a[i * nl + j], c[r * nl + j], t);
      xi[e] = t;
    }
    __syncthreads();
    // -S = -C xi2 (its lower triangle, mirrored), swept into Sinv
    for (int e = threadIdx.x; e < nc * nc; e += BLOCK_THREADS) {
      const int r = e / nc, t = e - r * nc;
      if (t <= r) {
        float x = 0.f;
        for (int i = 0; i < nl; ++i) x = __fmaf_rn(c[r * nl + i], xi[t * nl + i], x);
        s[r * nc + t] = s[t * nc + r] = -x;
      }
    }
    __syncthreads();
    block_sweep(s, nc, v, nl, bad);
    // q = Sinv xi2^T (nc x nl) and Sinv D
    for (int e = threadIdx.x; e < nc * nl; e += BLOCK_THREADS) {
      const int r = e / nl, j = e - r * nl;
      float t = 0.f;
      for (int u = 0; u < nc; ++u) t = __fmaf_rn(s[r * nc + u], xi[u * nl + j], t);
      q[e] = t;
    }
    for (int r = threadIdx.x; r < nc; r += BLOCK_THREADS) {
      float t = 0.f;
      for (int u = 0; u < nc; ++u) t = __fmaf_rn(s[r * nc + u], d[u], t);
      sd[r] = t;
    }
    __syncthreads();
    // -M = -Bf - xi2 Sinv xi2^T  (M = Bf - xi2 Sinv (C Bf), C Bf = -xi2^T)
    for (int i = warp; i < nl; i += BLOCK_THREADS / 32) {
      for (int j = lane; j < nl; j += 32) {
        float x = a[i * nl + j];
        for (int r = 0; r < nc; ++r) x = __fmaf_rn(-xi[r * nl + i], q[r * nl + j], x);
        a[i * nl + j] = x;
      }
    }
    __syncthreads();
  }
  // M (negated as it is stored) and b2 = alpha M acy + xi2 Sinv D, from M's column j
  float* const mo = m_out + b * nl * nl;
  for (int e = threadIdx.x; e < nl * nl; e += BLOCK_THREADS) mo[e] = -a[e];
  for (int j = threadIdx.x; j < nl; j += BLOCK_THREADS) {
    float my = 0.f, fold = 0.f;
    for (int i = 0; i < nl; ++i) my = __fmaf_rn(a[i * nl + j], y[i], my);
    for (int r = 0; r < nc; ++r) fold = __fmaf_rn(xi[r * nl + j], sd[r], fold);
    b2_out[b * nl + j] = nc > 0 ? __fmaf_rn(-al, my, fold) : -__fmul_rn(al, my);
  }
  if (threadIdx.x == 0) info_out[b] = bad;
}

cudaError_t launch_block(const void* aca, const void* w, const void* c, const void* d,
                         const void* alpha, const void* mu1, const void* mu2, const void* acy,
                         void* m, void* b2, void* info, int batch, int nl, int nc, int sa,
                         int s1, int s2, int sy, cudaStream_t stream) {
  const size_t smem = sizeof(float) * (size_t)block_dims(nl, nc).total;
  cudaError_t err = cudaFuncSetAttribute(spm_factor_refresh_block_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  spm_factor_refresh_block_kernel<<<batch, BLOCK_THREADS, smem, stream>>>(
      (const float*)aca, (const float*)w, (const float*)c, (const float*)d,
      (const float*)alpha, (const float*)mu1, (const float*)mu2, (const float*)acy, (float*)m,
      (float*)b2, (int*)info, nl, nc, sa, s1, s2, sy);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Shared memory, in bytes, of one block of the kernel that takes (nl, nc):
// the warp kernel's static shared memory at nl <= 32, nc <= 4 when `block`
// is 0, else the block kernel's dynamic shared memory.
size_t spm_factor_refresh_smem_bytes(int nl, int nc, int block) {
  if (!block)
    return nl <= 8 ? sizeof(Shared<8>) : nl <= 16 ? sizeof(Shared<16>) : sizeof(Shared<32>);
  return sizeof(float) * (size_t)block_dims(nl, nc).total;
}

// The device's opt-in shared-memory limit per block, in bytes.
int spm_factor_refresh_max_smem(int device, int* bytes) {
  return cudaDeviceGetAttribute(bytes, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
}

const char* spm_factor_refresh_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

// Launch on `stream` without synchronising; returns cudaGetLastError() after
// the launch (0 on success).  aca, w: (nl, nl), lower triangles read; c:
// (nc, nl) and d: (nc), unread at nc = 0; alpha, mu1, mu2: B values each,
// `sa`, `s1`, `s2` elements apart; acy: (B, nl), rows `sy` elements apart;
// outputs m: (B, nl, nl), b2: (B, nl), info: (B) int32, contiguous.  All
// f32 but info.  `block` 0: the warp kernel (1 <= nl <= 32, 0 <= nc <= 4);
// else the block kernel (any nl >= 1, nc >= 0 whose shared memory fits).
int spm_factor_refresh_launch(int device, const void* aca, const void* w, const void* c,
                              const void* d, const void* alpha, const void* mu1, const void* mu2,
                              const void* acy, void* m, void* b2, void* info, int batch, int nl,
                              int nc, int sa, int s1, int s2, int sy, int block, void* stream) {
  if (batch < 1 || nl < 1 || nc < 0 || (nc && (!c || !d)) ||
      (!block && (nl > 32 || nc > NC_MAX)))
    return cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  cudaStream_t s = (cudaStream_t)stream;
  if (block) return launch_block(aca, w, c, d, alpha, mu1, mu2, acy, m, b2, info, batch, nl, nc,
                                 sa, s1, s2, sy, s);
  if (nl <= 8) return launch<8>(aca, w, c, d, alpha, mu1, mu2, acy, m, b2, info, batch, nl, nc,
                                sa, s1, s2, sy, s);
  if (nl <= 16) return launch<16>(aca, w, c, d, alpha, mu1, mu2, acy, m, b2, info, batch, nl, nc,
                                  sa, s1, s2, sy, s);
  return launch<32>(aca, w, c, d, alpha, mu1, mu2, acy, m, b2, info, batch, nl, nc, sa, s1, s2,
                    sy, s);
}

}  // extern "C"
