// Fused 3-block SpM (sparse-modeling analytic continuation) ADMM chunk for
// Hopper (sm_90a), CUDA C++.
//
// Replaces the Pallas TPU kernel `fused_spm_chunk`
// (admmsolver_tpu/ops/kernels.py:268, body `_spm_iteration` at :218 and
// `_spm_chunk_kernel` at :241).  It runs `n_iters` Gauss-Seidel iterations of
// the SpM family (constrained least squares + L1 + nonnegativity through a
// projector P) on every lane:
//
//     hk0 = -h10 - mu1*x1 - P^T (h20 + mu2*x2)
//     x0  = b2 - M hk0                            (per-lane nl x nl matvec)
//     x1  = soft_threshold(-(h10 - mu1*x0)/mu1, thr1)
//     Px0 = P x0
//     x2  = max(-(h20 - mu2*Px0)/mu2, 0)
//     h10 += mu1 (x1 - x0);   h20 += mu2 (x2 - Px0)
//
// and returns (x0, x1, x2, h10, h20, x0_prev), x0_prev being the x0 the last
// iteration started from.
//
// Layout: batch-major.  P (nw, nl) is shared by all lanes (one copy serves
// P x0 and P^T t); M (B, nl, nl), b2 (B, nl), mu (B, 2) = [mu1, mu2],
// thr (B, 1); state x0/x1/h10 (B, nl), x2/h20 (B, nw); all f32, row-major.
// The TPU kernel's feature-major layout and its padding of nl, nw to 8 and
// of B to the lane tile do not carry over: nl, nw and B are taken as they
// are, and the ragged edges are masked here.
//
// Two kernels compute it; the wrapper (ops/kernels.py, _spm_tiling) takes
// the tensor-core kernel (further down, with its own comment) wherever
// nl <= 32 and nw <= 256, which covers the SpM problem's own width, and the
// FMA kernel below otherwise.  Both are full f32 in meaning.
//
// What bounds them on this card: operations.  One lane-iteration is
// 4*nl*nw + 2*nl*nl FMA-flops plus about 10*(nl+nw) elementwise ones
// (28.2 kflop at nl=30, nw=201), against 4*(nl*nl + 4*nl + 2*nw) bytes of
// device memory per lane once per chunk.  As f32 FMA on the CUDA cores the
// chunk of 100 iterations at B=4096 cannot take less than 0.17 ms; with the
// two products against P in split TF32 on the tensor cores, 0.085 ms.
// What stands between the FMA kernel and its bound is shared-memory load
// traffic: every FMA needs an element of P and an element of a lane's
// vector, and an element of P it loads serves only the lanes its warp owns.
//
// What the FMA kernel's design does about it: a warp owns L lanes (L = 1, 2
// or 4) for the whole chunk and needs no block-wide barrier inside the
// iteration loop.  Each element of P a thread loads from shared memory is
// used for L lanes (and each 16-byte broadcast load of a lane's vector for
// 4 FMAs per row of P), so a group of 4 lanes needs about 0.3-0.5 shared
// loads per FMA where one lane alone needs 2.  All per-lane state stays in
// shared memory across the chunk, M included (nl*(nl_pad+1) floats per
// lane: reading it from L2 every iteration would be 1.5 GB per chunk at
// B=4096).  x2 itself is not kept: an iteration reads it only through
// t = h20 + mu2*x2, so the kernel keeps t and h20 and stores x2 from
// registers in the last iteration.  That brings a lane to 6240 bytes at
// nl=30, nw=201, so that 32 lanes and P fit the 227 KB of one SM and B=4096
// runs as one wave of 128 blocks on 132 SMs.  Rows of P and of M are padded
// to an odd stride so that threads walking down a column hit different
// banks.  The wrapper chooses L and the warps per block: one wave first,
// then the most warps.  On an H100 (80GB HBM3, 700 W) at that shape, 100
// iterations take 0.99 ms with 16 warps of 2 lanes, 1.15 ms with 8 warps of
// 4 (fewer shared loads per FMA, but too few warps to hide their latency)
// and 1.28 ms with 16 warps of 1 lane (two waves); the tensor-core kernel
// takes 0.39 ms.
//
// Plain C interface, loaded with ctypes (admmsolver_tpu_torch/ops/_build.py).

#include <cuda_runtime.h>
#include <stddef.h>

#include <type_traits>

namespace {

constexpr int WARP = 32;
constexpr int MAX_WARPS = 16;  // warps per block
constexpr int KR = 4;          // rows of P per thread and pass in P x0

__host__ __device__ inline int round_up(int a, int b) { return (a + b - 1) / b * b; }

// x / m from rm = 1 / m rounded to nearest: the quotient estimate x * rm
// corrected once by its exact remainder, the correctly rounded quotient up
// to rare last-bit cases, without the branch to a slow path of `x / m`.
__device__ __forceinline__ float div_by(float x, float m, float rm) {
  const float q = x * rm;
  return fmaf(fmaf(-q, m, x), rm, q);
}

// Shared-memory geometry.  Vectors are zero-padded to a multiple of 4 floats
// (they are read as float4); rows of P and M have the odd stride nlp + 1,
// with zeros past column nl.
struct Dims {
  int nlp, nwp, ld, p_floats, lane_floats;
};

__host__ __device__ inline Dims dims(int nl, int nw) {
  Dims d;
  d.nlp = round_up(nl, 4);
  d.nwp = round_up(nw, 4);
  d.ld = d.nlp + 1;
  d.p_floats = d.nwp * d.ld;  // a multiple of 4, as nwp is
  // hk0, x0, x1, h10, b2 (nlp each), h20, t (nwp each), M (nl rows)
  d.lane_floats = 5 * d.nlp + 2 * d.nwp + round_up(nl * d.ld, 4);
  return d;
}

size_t smem_bytes(int lanes, int nl, int nw) {
  const Dims d = dims(nl, nw);
  return sizeof(float) * ((size_t)d.p_floats + (size_t)lanes * d.lane_floats);
}

template <int L>
__global__ void __launch_bounds__(WARP * MAX_WARPS) fused_spm_kernel(
    const float* __restrict__ P, const float* __restrict__ M,
    const float* __restrict__ b2, const float* __restrict__ mu,
    const float* __restrict__ thr, const float* __restrict__ x0,
    const float* __restrict__ x1, const float* __restrict__ x2,
    const float* __restrict__ h10, const float* __restrict__ h20,
    float* __restrict__ x0o, float* __restrict__ x1o, float* __restrict__ x2o,
    float* __restrict__ h10o, float* __restrict__ h20o, float* __restrict__ x0p,
    int B, int nl, int nw, int n_iters) {
  extern __shared__ __align__(16) float smem[];
  const Dims d = dims(nl, nw);
  const int nlp = d.nlp, nwp = d.nwp, ld = d.ld;
  const int warp = threadIdx.x / WARP, lane = threadIdx.x % WARP;
  const int b0 = (blockIdx.x * (blockDim.x / WARP) + warp) * L;

  // Offsets of one lane's arrays from its base.
  const int o_hk = 0, o_x0 = nlp, o_x1 = 2 * nlp, o_h1 = 3 * nlp, o_b2 = 4 * nlp;
  const int o_h2 = 5 * nlp, o_t = o_h2 + nwp, o_m = o_t + nwp;
  float* const P_s = smem;
  float* const lanes_s = smem + d.p_floats + (size_t)warp * L * d.lane_floats;

  for (int idx = threadIdx.x; idx < d.p_floats; idx += blockDim.x) {
    const int w = idx / ld, j = idx % ld;
    P_s[idx] = (w < nw && j < nl) ? P[(size_t)w * nl + j] : 0.f;
  }

  // Lanes past B run on zeros with mu = 1, which stay zero and finite, and
  // are not stored.
  float mu1[L], mu2[L], th[L];
#pragma unroll
  for (int l = 0; l < L; ++l) {
    const int b = b0 + l;
    const bool ok = b < B;
    mu1[l] = ok ? mu[2 * (size_t)b] : 1.f;
    mu2[l] = ok ? mu[2 * (size_t)b + 1] : 1.f;
    th[l] = ok ? thr[b] : 0.f;
    float* const s = lanes_s + l * d.lane_floats;
    for (int j = lane; j < nlp; j += WARP) {
      const bool in = ok && j < nl;
      const size_t g = (size_t)b * nl + j;
      s[o_hk + j] = 0.f;
      s[o_x0 + j] = in ? x0[g] : 0.f;
      s[o_x1 + j] = in ? x1[g] : 0.f;
      s[o_h1 + j] = in ? h10[g] : 0.f;
      s[o_b2 + j] = in ? b2[g] : 0.f;
    }
    for (int w = lane; w < nwp; w += WARP) {
      const bool in = ok && w < nw;
      const size_t g = (size_t)b * nw + w;
      const float h = in ? h20[g] : 0.f;
      const float x = in ? x2[g] : 0.f;
      s[o_h2 + w] = h;
      s[o_t + w] = h + mu2[l] * x;
      if (in && n_iters == 0) x2o[g] = x;
    }
    for (int idx = lane; idx < nl * ld; idx += WARP) {
      const int i = idx / ld, j = idx % ld;
      s[o_m + idx] = (ok && j < nl) ? M[((size_t)b * nl + i) * nl + j] : 0.f;
    }
  }
  __syncthreads();
  if (b0 >= B) return;  // no block-wide barrier below

  for (int it = 0; it < n_iters; ++it) {
    const bool last = it == n_iters - 1;

    // 1. hk0 = -h10 - mu1*x1 - P^T t.  Thread j sums column j of P over the
    //    rows in order; t is read four rows at a time, as a broadcast.
    for (int j0 = 0; j0 < nl; j0 += WARP) {
      const int j = j0 + lane;
      const float* const pc = P_s + (j < nl ? j : nl - 1);
      float acc[L];
#pragma unroll
      for (int l = 0; l < L; ++l) acc[l] = 0.f;
#pragma unroll 2
      for (int w = 0; w < nwp; w += 4) {
        const float p0 = pc[w * ld], p1 = pc[(w + 1) * ld];
        const float p2 = pc[(w + 2) * ld], p3 = pc[(w + 3) * ld];
#pragma unroll
        for (int l = 0; l < L; ++l) {
          const float4 t =
              *reinterpret_cast<const float4*>(lanes_s + l * d.lane_floats + o_t + w);
          acc[l] = fmaf(p0, t.x, acc[l]);
          acc[l] = fmaf(p1, t.y, acc[l]);
          acc[l] = fmaf(p2, t.z, acc[l]);
          acc[l] = fmaf(p3, t.w, acc[l]);
        }
      }
      if (j < nl) {
#pragma unroll
        for (int l = 0; l < L; ++l) {
          float* const s = lanes_s + l * d.lane_floats;
          s[o_hk + j] = -s[o_h1 + j] - mu1[l] * s[o_x1 + j] - acc[l];
        }
      }
    }
    __syncwarp();

    // 2. x0 = b2 - M hk0, then x1 and h10.  Thread i owns row i of M and
    //    entry i of x0, x1 and h10.
    for (int i0 = 0; i0 < nl; i0 += WARP) {
      const int i = i0 + lane;
      const int mrow = o_m + (i < nl ? i : nl - 1) * ld;
      float acc[L];
#pragma unroll
      for (int l = 0; l < L; ++l) acc[l] = 0.f;
      for (int j = 0; j < nlp; j += 4) {
#pragma unroll
        for (int l = 0; l < L; ++l) {
          const float* const s = lanes_s + l * d.lane_floats;
          const float4 v = *reinterpret_cast<const float4*>(s + o_hk + j);
          const float* const m = s + mrow + j;
          acc[l] = fmaf(m[0], v.x, acc[l]);
          acc[l] = fmaf(m[1], v.y, acc[l]);
          acc[l] = fmaf(m[2], v.z, acc[l]);
          acc[l] = fmaf(m[3], v.w, acc[l]);
        }
      }
      if (i < nl) {
#pragma unroll
        for (int l = 0; l < L; ++l) {
          float* const s = lanes_s + l * d.lane_floats;
          const float m = mu1[l], h = s[o_h1 + i];
          const float x0n = s[o_b2 + i] - acc[l];
          const float z = -(h - m * x0n) / m;
          const float a = fmaxf(fabsf(z) - th[l], 0.f);
          const float x1n = z > 0.f ? a : (z < 0.f ? -a : z * 0.f);
          if (last && b0 + l < B) x0p[(size_t)(b0 + l) * nl + i] = s[o_x0 + i];
          s[o_x0 + i] = x0n;
          s[o_x1 + i] = x1n;
          s[o_h1 + i] = h + m * (x1n - x0n);
        }
      }
    }
    __syncwarp();

    // 3. Px0 = P x0, then x2, h20 and the next iteration's t.  A thread
    //    takes KR rows of P, 32 apart, per pass; x0 is read four entries at
    //    a time, as a broadcast.  Rows past nw are clamped and dropped.
    for (int w0 = 0; w0 < nw; w0 += WARP * KR) {
      float acc[KR][L];
      const float* prow[KR];
#pragma unroll
      for (int k = 0; k < KR; ++k) {
        const int w = w0 + k * WARP + lane;
        prow[k] = P_s + (w < nwp ? w : nwp - 1) * ld;
#pragma unroll
        for (int l = 0; l < L; ++l) acc[k][l] = 0.f;
      }
      for (int j = 0; j < nlp; j += 4) {
        float4 v[L];
#pragma unroll
        for (int l = 0; l < L; ++l)
          v[l] = *reinterpret_cast<const float4*>(lanes_s + l * d.lane_floats + o_x0 + j);
#pragma unroll
        for (int k = 0; k < KR; ++k) {
          if (w0 + k * WARP >= nw) continue;  // the same for the whole warp
          const float p0 = prow[k][j], p1 = prow[k][j + 1];
          const float p2 = prow[k][j + 2], p3 = prow[k][j + 3];
#pragma unroll
          for (int l = 0; l < L; ++l) {
            acc[k][l] = fmaf(p0, v[l].x, acc[k][l]);
            acc[k][l] = fmaf(p1, v[l].y, acc[k][l]);
            acc[k][l] = fmaf(p2, v[l].z, acc[k][l]);
            acc[k][l] = fmaf(p3, v[l].w, acc[k][l]);
          }
        }
      }
#pragma unroll
      for (int k = 0; k < KR; ++k) {
        const int w = w0 + k * WARP + lane;
        if (w >= nw) continue;
#pragma unroll
        for (int l = 0; l < L; ++l) {
          float* const s = lanes_s + l * d.lane_floats;
          const float m = mu2[l], h = s[o_h2 + w], px = acc[k][l];
          const float z = -(h - m * px) / m;
          const float x2n = z < 0.f ? 0.f : z;
          const float hn = h + m * (x2n - px);
          s[o_h2 + w] = hn;
          s[o_t + w] = hn + m * x2n;
          if (last && b0 + l < B) x2o[(size_t)(b0 + l) * nw + w] = x2n;
        }
      }
    }
    __syncwarp();
  }

#pragma unroll
  for (int l = 0; l < L; ++l) {
    const int b = b0 + l;
    if (b >= B) continue;
    const float* const s = lanes_s + l * d.lane_floats;
    for (int j = lane; j < nl; j += WARP) {
      const size_t g = (size_t)b * nl + j;
      x0o[g] = s[o_x0 + j];
      x1o[g] = s[o_x1 + j];
      h10o[g] = s[o_h1 + j];
      if (n_iters == 0) x0p[g] = s[o_x0 + j];
    }
    for (int w = lane; w < nw; w += WARP) h20o[(size_t)b * nw + w] = s[o_h2 + w];
  }
}

// ---------------------------------------------------------------------
// The same chunk with the two products against P on the tensor cores, for
// nl <= 32 and nw <= 256 (the SpM problem's own width: the notebook's
// nl = 30, nw = 61, and nw = 201).
//
// Split TF32: every f32 operand x is big + small, big = x rounded to TF32
// and small = x - big, and a product is a_small*b_big + a_big*b_small +
// a_big*b_big, three `mma.sync.m16n8k8` with f32 accumulation into three
// accumulators; the dropped term is below 2^-21 of the product.  The tensor
// core adds into its accumulator by truncation, so no chain of mma is
// longer than 32 steps of k: P x0 has nl <= 32 steps, and P^T t runs over
// nw in chains of four k8 steps whose sums a rounded f32 add joins, inside
// the warp that owns the output.  M hk0 and the elementwise steps stay f32.
//
// A block holds 16 lanes, the 16 rows of every mma tile, in 8 warps, and
// two blocks share a multiprocessor, so that B = 4096 runs as one wave of
// 256 blocks.  An iteration is three steps between block-wide barriers:
//   C. hk0 = u - P^T t.  Warp w < ceil(nl / 8) owns coefficients 8 w ..
//      8 w + 7 of the 16 lanes over all frequencies (A: t^T, B: P); u =
//      -h10 - mu1 x1 was left by step D.
//   D. x0 = b2 - M hk0.  Each thread keeps two rows of one lane's M in
//      registers (M never passes through shared memory), reads the lane's
//      hk0 as eight float4, and updates x1, h10 and u of its two elements;
//      x0 goes out as the A fragments of step A.
//   A. P x0 (A: x0^T, B: P^T).  Warp w takes the tiles of eight frequencies
//      w, w + 8, ... below ceil(nw / 8), so that no mma runs on frequencies
//      all past nw, then x2, h20 and the next t of its elements.  With the
//      k8 step's frequencies taken in the order 0, 2, 4, 6, 1, 3, 5, 7, the
//      C fragment of t^T that a thread holds is its own A fragment of step
//      C: one float4 store a tile.
// Shared memory: P as TF32 head and rest, rows padded to 36 floats so that
// the B fragments of both products hit 32 banks; t and h20 in fragment
// order; x0; hk0 and u; b2 and h10 of step D; five scalars a lane (38 KB at
// nw = 61).  Where two blocks of that do not fit a multiprocessor (nw > 248
// on an H100), P is kept once and split at each use.
//
// What bounds it: at nl = 30, nw = 61, B = 4096 a 100-iteration chunk
// takes 0.167-0.173 ms on an H100 (80GB HBM3, 700 W) against 0.38-0.39 ms
// for the design it replaced (32 lanes and 8 warps a block, M in shared
// memory, P^T t split over the 8 warps); one block alone a multiprocessor
// (B = 2112) takes 0.114 ms.  The split products are 384 mma a
// multiprocessor and iteration (~580 cycles at the measured 1.52 cycles an
// mma), the shared-memory traffic ~1,600 wavefronts, the issue ~1,650
// cycles a scheduler, against ~3,200 cycles an iteration: the barriers'
// chains of loads, mma and elementwise work are what is left, half-hidden
// by the second block.
// ---------------------------------------------------------------------

__device__ __forceinline__ unsigned tf32_big(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;  // round to TF32, ties away
}

__device__ __forceinline__ void mma_tf32(float (&d)[4], const unsigned (&a)[4],
                                         const unsigned (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

constexpr int LR_LANES = 16;               // lanes per block: the 16 rows of every mma tile
constexpr int LR_WARPS = 8;
constexpr int LR_THREADS = LR_WARPS * WARP;
constexpr int LR_NL = 32;                  // most coefficients
constexpr int LR_LDP = LR_NL + 4;          // floats between rows of P: 4 mod 32
constexpr int LR_LDH = 40;                 // floats between lanes of hk0 and u
constexpr int LR_HK = LR_LANES * LR_LDH + 16;

// Index of (lane c, coefficient j) in hk0 and u: lanes 8-15 sit 16 floats
// further, so that lanes c and c + 8 fall on other banks.
__device__ __forceinline__ int lr_hk(int c, int j) { return c * LR_LDH + (c >> 3) * 16 + j; }

// Bytes of shared memory: P's TF32 head and rest (LDP floats per frequency
// of 8 nt; P alone where not split), t and h20 as A fragments (128 floats
// per tile of frequencies each), x0 as A fragments (4 x 128), hk0 and u, b2
// and h10 by thread (4 x 256), and five scalars of each lane.
size_t smem_bytes_lr(int nw, bool split) {
  const size_t nt = (nw + 7) / 8;
  return sizeof(float) * ((1 + split) * nt * 8 * LR_LDP + 2 * nt * 128 + 4 * 128 + 2 * LR_HK +
                          4 * LR_THREADS + 5 * LR_LANES);
}

__device__ __forceinline__ void tf32_split(const float4 v, unsigned (&big)[4],
                                           unsigned (&small)[4]) {
  const float x[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    big[i] = tf32_big(x[i]);
    small[i] = __float_as_uint(x[i] - __uint_as_float(big[i]));
  }
}

// WT: the most tiles of frequencies a warp takes in step A (nw <= 64 WT);
// SPLIT: P kept as TF32 head and rest, else once and split at each use.
template <int WT, bool SPLIT>
__global__ void __launch_bounds__(LR_THREADS, 2) fused_spm_lane_mma_kernel(
    const float* __restrict__ P, const float* __restrict__ M,
    const float* __restrict__ b2, const float* __restrict__ mu,
    const float* __restrict__ thr, const float* __restrict__ x0,
    const float* __restrict__ x1, const float* __restrict__ x2,
    const float* __restrict__ h10, const float* __restrict__ h20,
    float* __restrict__ x0o, float* __restrict__ x1o, float* __restrict__ x2o,
    float* __restrict__ h10o, float* __restrict__ h20o, float* __restrict__ x0p,
    int B, int nl, int nw, int n_iters) {
  extern __shared__ __align__(16) float smem[];
  const int nt = (nw + 7) / 8, nk = (nl + 7) / 8;   // tiles of eight frequencies, coefficients
  float* const Pb = smem;                           // [8 nt][LDP]: P's TF32 head (or P)
  float* const Ps = Pb + nt * 8 * LR_LDP;           // and the rest
  float* const TF = Ps + SPLIT * nt * 8 * LR_LDP;   // [nt][32 threads][4]: t as A fragments
  float* const HF = TF + nt * 128;                  // [nt][32][4]: h20 in the same places
  float* const XF = HF + nt * 128;                  // [4][32][4]: x0 as A fragments
  float* const HK = XF + 4 * 128;                   // hk0 by lr_hk
  float* const U = HK + LR_HK;                      // -h10 - mu1 x1 by lr_hk
  float* const DS = U + LR_HK;                      // [4][256]: b2, h10 of step D's elements
  float* const LS = DS + 4 * LR_THREADS;            // [5][16]: mu1, 1/mu1, thr, mu2, 1/mu2

  const int tid = threadIdx.x, wp = tid / WARP, q = tid % WARP;
  const int g = q >> 2, t = q & 3;
  const int b0 = blockIdx.x * LR_LANES;

  for (int idx = tid; idx < nt * 8 * LR_LDP; idx += LR_THREADS) {
    const int w = idx / LR_LDP, j = idx % LR_LDP;
    const float p = (w < nw && j < nl) ? __ldg(P + (size_t)w * nl + j) : 0.f;
    const float big = __uint_as_float(tf32_big(p));
    if (SPLIT) {
      Pb[idx] = big;
      Ps[idx] = p - big;
    } else {
      Pb[idx] = p;
    }
  }
  for (int idx = tid; idx < 2 * LR_HK; idx += LR_THREADS) HK[idx] = 0.f;
  if (tid < LR_LANES) {
    const int b = b0 + tid;
    const float m1 = b < B ? mu[2 * (size_t)b] : 1.f, m2 = b < B ? mu[2 * (size_t)b + 1] : 1.f;
    LS[tid] = m1;
    LS[LR_LANES + tid] = 1.f / m1;
    LS[2 * LR_LANES + tid] = b < B ? thr[b] : 0.f;
    LS[3 * LR_LANES + tid] = m2;
    LS[4 * LR_LANES + tid] = 1.f / m2;
  }
  __syncthreads();

  // Step D's elements: lane dl, rows drow0 and drow0 + 16, with the lane's
  // rows of M in registers.
  const int dl = 2 * (wp & 3) + (q & 1) + 8 * ((q >> 1) & 1);
  const int ds = ((q >> 2) & 3) + 4 * (q >> 4);
  const int drow0 = 8 * (wp >> 2) + ds;
  const int xslot = (4 * (dl & 7) + (ds & 3)) * 4 + (dl >> 3) + 2 * (ds >> 2);
  const int bd = b0 + dl;
  const bool dok = bd < B;
  float Mr[2][LR_NL];
  {
    const float mu1 = LS[dl];
#pragma unroll
    for (int p = 0; p < 2; ++p) {
      const int i = drow0 + 16 * p;
      const bool in = dok && i < nl;
      const size_t gi = (size_t)bd * nl + i;
#pragma unroll
      for (int j = 0; j < LR_NL; ++j) Mr[p][j] = (in && j < nl) ? M[gi * nl + j] : 0.f;
      const float x0v = in ? x0[gi] : 0.f, x1v = in ? x1[gi] : 0.f, h = in ? h10[gi] : 0.f;
      DS[p * LR_THREADS + tid] = in ? b2[gi] : 0.f;
      DS[(2 + p) * LR_THREADS + tid] = h;
      XF[128 * (i >> 3) + xslot] = x0v;
      U[lr_hk(dl, i)] = -h - mu1 * x1v;
      if (in && n_iters == 0) {
        x0o[gi] = x0v;
        x1o[gi] = x1v;
        h10o[gi] = h;
        x0p[gi] = x0v;
      }
    }
  }

  // Step A's elements: lanes g, g + 8 and frequencies 8 n + 2 t, + 1 of the
  // tiles n = wp + 8 r; t and h20 as the A fragments of step C.
  const int la = b0 + g, lb = la + 8;
#pragma unroll
  for (int r = 0; r < WT; ++r) {
    const int n = wp + LR_WARPS * r;
    if (n >= nt) break;
    float tv[4], hv[4];
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int b = c < 2 ? la : lb, w = 8 * n + 2 * t + (c & 1);
      const bool in = b < B && w < nw;
      const size_t gi = (size_t)b * nw + w;
      const float h = in ? h20[gi] : 0.f, x = in ? x2[gi] : 0.f;
      hv[c] = h;
      tv[c] = h + LS[3 * LR_LANES + g + 8 * (c >> 1)] * x;
      if (in && n_iters == 0) x2o[gi] = x;
    }
    *reinterpret_cast<float4*>(TF + n * 128 + q * 4) = make_float4(tv[0], tv[2], tv[1], tv[3]);
    *reinterpret_cast<float4*>(HF + n * 128 + q * 4) = make_float4(hv[0], hv[2], hv[1], hv[3]);
  }
  __syncthreads();

  // The B fragment (b0 at p[o0], b1 at p[o1]), head and rest.
  auto get_b = [&](const float* p, int o0, int o1, unsigned (&big)[2], unsigned (&sml)[2]) {
    if (SPLIT) {
      const float* const ps = p + nt * 8 * LR_LDP;
      big[0] = __float_as_uint(p[o0]);
      big[1] = __float_as_uint(p[o1]);
      sml[0] = __float_as_uint(ps[o0]);
      sml[1] = __float_as_uint(ps[o1]);
    } else {
      const float v0 = p[o0], v1 = p[o1];
      big[0] = tf32_big(v0);
      big[1] = tf32_big(v1);
      sml[0] = __float_as_uint(v0 - __uint_as_float(big[0]));
      sml[1] = __float_as_uint(v1 - __uint_as_float(big[1]));
    }
  };
  // One k8 step of P^T t at tile kk: acc += T^T P over the eight
  // frequencies of tile kk, for this warp's eight coefficients.
  const float* const pc = Pb + 2 * t * LR_LDP + 8 * wp + g;   // + 8 LDP kk
  auto step_c = [&](float (&sb)[4], float (&bs)[4], float (&bb)[4], int kk) {
    unsigned ab[4], as[4];
    tf32_split(*reinterpret_cast<const float4*>(TF + kk * 128 + q * 4), ab, as);
    const int o = kk * 8 * LR_LDP;
    unsigned bbig[2], bsml[2];
    get_b(pc, o, o + LR_LDP, bbig, bsml);
    mma_tf32(sb, as, bbig);
    mma_tf32(bs, ab, bsml);
    mma_tf32(bb, ab, bbig);
  };
  // One chain of P^T t: k8 steps kk0 .. kk0 + 3 (those below nt where the
  // chain is the last, partial one), into fresh accumulators, then added
  // to tot.
  auto chain = [&](float (&tot)[4], int kk0, auto full_c) {
    constexpr bool full = decltype(full_c)::value;
    float sb[4] = {0.f, 0.f, 0.f, 0.f}, bs[4] = {0.f, 0.f, 0.f, 0.f},
          bb[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      if (!full && kk0 + k >= nt) break;
      step_c(sb, bs, bb, kk0 + k);
    }
#pragma unroll
    for (int c = 0; c < 4; ++c) tot[c] += (sb[c] + bs[c]) + bb[c];
  };
  auto iteration = [&](auto last_c) {
    constexpr bool last = decltype(last_c)::value;

    // C. hk0 = u - P^T t.  Warp wp < nk owns coefficients 8 wp .. 8 wp + 7 of
    //    the 16 lanes, over all frequencies in chains of four k8 steps.
    if (wp < nk) {
      float tot[4] = {0.f, 0.f, 0.f, 0.f};
      int kk = 0;
#pragma unroll
      for (int ch = 0; ch < 2 * WT; ++ch) {
        if (kk + 4 > nt) break;
        chain(tot, kk, std::true_type{});
        kk += 4;
      }
      if (kk < nt) chain(tot, kk, std::false_type{});
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int o = lr_hk(g + 8 * h, 8 * wp + 2 * t);
        const float2 u = *reinterpret_cast<const float2*>(U + o);
        *reinterpret_cast<float2*>(HK + o) = make_float2(u.x - tot[2 * h], u.y - tot[2 * h + 1]);
      }
    }
    __syncthreads();

    // D. x0 = b2 - M hk0, then x1, h10 and the next u.
    {
      float acc[2][4];
#pragma unroll
      for (int p = 0; p < 2; ++p)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[p][e] = 0.f;
      const float* const hk = HK + lr_hk(dl, 0);
#pragma unroll
      for (int j4 = 0; j4 < LR_NL / 4; ++j4) {
        const float4 v = *reinterpret_cast<const float4*>(hk + 4 * j4);
#pragma unroll
        for (int p = 0; p < 2; ++p) {
          acc[p][0] = fmaf(Mr[p][4 * j4], v.x, acc[p][0]);
          acc[p][1] = fmaf(Mr[p][4 * j4 + 1], v.y, acc[p][1]);
          acc[p][2] = fmaf(Mr[p][4 * j4 + 2], v.z, acc[p][2]);
          acc[p][3] = fmaf(Mr[p][4 * j4 + 3], v.w, acc[p][3]);
        }
      }
      const float mu1 = LS[dl], rmu1 = LS[LR_LANES + dl], th = LS[2 * LR_LANES + dl];
#pragma unroll
      for (int p = 0; p < 2; ++p) {
        const int i = drow0 + 16 * p;
        const float mx = (acc[p][0] + acc[p][1]) + (acc[p][2] + acc[p][3]);
        const float x0n = DS[p * LR_THREADS + tid] - mx;
        const float h = DS[(2 + p) * LR_THREADS + tid];
        const float z = -div_by(h - mu1 * x0n, mu1, rmu1);
        const float a = fmaxf(fabsf(z) - th, 0.f);
        const float x1n = z > 0.f ? a : (z < 0.f ? -a : z * 0.f);
        const float hn = h + mu1 * (x1n - x0n);
        DS[(2 + p) * LR_THREADS + tid] = hn;
        float* const xs = XF + 128 * (i >> 3) + xslot;
        if (last && dok && i < nl) {
          const size_t gi = (size_t)bd * nl + i;
          x0p[gi] = *xs;
          x0o[gi] = x0n;
          x1o[gi] = x1n;
          h10o[gi] = hn;
        }
        *xs = x0n;
        U[lr_hk(dl, i)] = -hn - mu1 * x1n;
      }
    }
    __syncthreads();

    // A. P x0 for this warp's tiles of frequencies, then x2, h20 and the
    //    next t, written as the A fragments of step C.
    {
      const float mua = LS[3 * LR_LANES + g], mub = LS[3 * LR_LANES + g + 8];
      const float rmua = LS[4 * LR_LANES + g], rmub = LS[4 * LR_LANES + g + 8];
#pragma unroll
      for (int r = 0; r < WT; ++r) {
        const int n = wp + LR_WARPS * r;
        if (n >= nt) break;
        float sb[4] = {0.f, 0.f, 0.f, 0.f}, bs[4] = {0.f, 0.f, 0.f, 0.f},
              bb[4] = {0.f, 0.f, 0.f, 0.f};
        const float* const pa = Pb + (8 * n + g) * LR_LDP + t;
#pragma unroll
        for (int kk = 0; kk < LR_NL / 8; ++kk) {
          unsigned ab[4], as[4];
          tf32_split(*reinterpret_cast<const float4*>(XF + kk * 128 + q * 4), ab, as);
          unsigned bbig[2], bsml[2];
          get_b(pa, 8 * kk, 8 * kk + 4, bbig, bsml);
          mma_tf32(sb, as, bbig);
          mma_tf32(bs, ab, bsml);
          mma_tf32(bb, ab, bbig);
        }
        const float4 hf = *reinterpret_cast<const float4*>(HF + n * 128 + q * 4);
        const float hv[4] = {hf.x, hf.z, hf.y, hf.w};
        float tv[4], hn[4];
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const float m = c < 2 ? mua : mub, rm = c < 2 ? rmua : rmub;
          const float px = (sb[c] + bs[c]) + bb[c];
          const float z = -div_by(hv[c] - m * px, m, rm);
          const float x2n = z < 0.f ? 0.f : z;
          hn[c] = hv[c] + m * (x2n - px);
          tv[c] = hn[c] + m * x2n;
          const int b = c < 2 ? la : lb, w = 8 * n + 2 * t + (c & 1);
          if (last && b < B && w < nw) x2o[(size_t)b * nw + w] = x2n;
        }
        *reinterpret_cast<float4*>(HF + n * 128 + q * 4) = make_float4(hn[0], hn[2], hn[1], hn[3]);
        if (!last)
          *reinterpret_cast<float4*>(TF + n * 128 + q * 4) =
              make_float4(tv[0], tv[2], tv[1], tv[3]);
      }
    }
    __syncthreads();
  };

  for (int it = 0; it + 1 < n_iters; ++it) iteration(std::false_type{});
  if (n_iters > 0) iteration(std::true_type{});

#pragma unroll
  for (int r = 0; r < WT; ++r) {
    const int n = wp + LR_WARPS * r;
    if (n >= nt) break;
    const float4 hf = *reinterpret_cast<const float4*>(HF + n * 128 + q * 4);
    const float hv[4] = {hf.x, hf.z, hf.y, hf.w};
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int b = c < 2 ? la : lb, w = 8 * n + 2 * t + (c & 1);
      if (b < B && w < nw) h20o[(size_t)b * nw + w] = hv[c];
    }
  }
}

template <int WT, bool SPLIT>
int launch_lr(const float* P, const float* M, const float* b2, const float* mu,
              const float* thr, const float* x0, const float* x1, const float* x2,
              const float* h10, const float* h20, float* x0o, float* x1o, float* x2o,
              float* h10o, float* h20o, float* x0p, int B, int nl, int nw, int n_iters,
              cudaStream_t stream) {
  const size_t smem = smem_bytes_lr(nw, SPLIT);
  cudaError_t err = cudaFuncSetAttribute(fused_spm_lane_mma_kernel<WT, SPLIT>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  fused_spm_lane_mma_kernel<WT, SPLIT><<<(B + LR_LANES - 1) / LR_LANES, LR_THREADS, smem, stream>>>(
      P, M, b2, mu, thr, x0, x1, x2, h10, h20, x0o, x1o, x2o, h10o, h20o, x0p, B, nl, nw,
      n_iters);
  return cudaGetLastError();
}

// The tensor-core kernel with at most `tiles` tiles of frequencies a warp
// (1, 2 or 4); P split in shared memory where two such blocks fit one
// multiprocessor of `device`.
int launch_tensor_cores(int device, const float* P, const float* M, const float* b2,
                        const float* mu, const float* thr, const float* x0, const float* x1,
                        const float* x2, const float* h10, const float* h20, float* x0o,
                        float* x1o, float* x2o, float* h10o, float* h20o, float* x0p, int B,
                        int nl, int nw, int n_iters, int tiles, cudaStream_t s) {
  if (nl > LR_NL || (nw + 7) / 8 > LR_WARPS * tiles) return cudaErrorInvalidValue;
  int per_sm = 0, reserved = 0;
  cudaError_t err =
      cudaDeviceGetAttribute(&per_sm, cudaDevAttrMaxSharedMemoryPerMultiprocessor, device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&reserved, cudaDevAttrReservedSharedMemoryPerBlock, device);
  if (err != cudaSuccess) return err;
  const bool split = 2 * (smem_bytes_lr(nw, true) + reserved) <= (size_t)per_sm;
#define FSPM_LAUNCH_TC(W, S)                                                              \
  return launch_lr<W, S>(P, M, b2, mu, thr, x0, x1, x2, h10, h20, x0o, x1o, x2o, h10o, h20o, \
                         x0p, B, nl, nw, n_iters, s)
  switch (tiles) {
    case 1:
      FSPM_LAUNCH_TC(1, true);
    case 2:
      FSPM_LAUNCH_TC(2, true);
    case 4:
      if (split) FSPM_LAUNCH_TC(4, true);
      FSPM_LAUNCH_TC(4, false);
    default:
      return cudaErrorInvalidValue;
  }
#undef FSPM_LAUNCH_TC
}

template <int L>
int launch(const float* P, const float* M, const float* b2, const float* mu,
           const float* thr, const float* x0, const float* x1, const float* x2,
           const float* h10, const float* h20, float* x0o, float* x1o, float* x2o,
           float* h10o, float* h20o, float* x0p, int B, int nl, int nw, int n_iters,
           int warps, cudaStream_t stream) {
  const size_t smem = smem_bytes(warps * L, nl, nw);
  cudaError_t err = cudaFuncSetAttribute(
      fused_spm_kernel<L>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const int lanes = warps * L;
  fused_spm_kernel<L><<<(B + lanes - 1) / lanes, WARP * warps, smem, stream>>>(
      P, M, b2, mu, thr, x0, x1, x2, h10, h20, x0o, x1o, x2o, h10o, h20o, x0p, B, nl,
      nw, n_iters);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Dynamic shared memory, in bytes, of a block that holds `lanes` lanes;
// `lanes` = 0: of a block of the tensor-core kernel (P split, its most).
size_t fused_spm_smem_bytes(int lanes, int nl, int nw) {
  return lanes ? smem_bytes(lanes, nl, nw) : smem_bytes_lr(nw, true);
}

// The device's opt-in shared-memory limit per block, in bytes.
int fused_spm_max_smem(int device, int* bytes) {
  return cudaDeviceGetAttribute(bytes, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
}

const char* fused_spm_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

// Launch on `stream` without synchronising; returns cudaGetLastError() after
// the launch (0 on success).  A block has `warps` warps (1..16) of
// `lanes_per_warp` lanes (1, 2 or 4) each; `lanes_per_warp` = 0 launches the
// tensor-core kernel (nl <= 32, nw <= 256; 16 lanes and 8 warps a block),
// `warps` then the most tiles of eight frequencies a warp takes (1, 2 or 4,
// at least ceil(nw / 64)).
int fused_spm_launch(int device, const float* P, const float* M, const float* b2,
                     const float* mu, const float* thr, const float* x0, const float* x1,
                     const float* x2, const float* h10, const float* h20, float* x0o,
                     float* x1o, float* x2o, float* h10o, float* h20o, float* x0p, int B,
                     int nl, int nw, int n_iters, int lanes_per_warp, int warps,
                     void* stream) {
  if (warps < 1 || warps > MAX_WARPS || B < 1 || nl < 1 || nw < 1 || n_iters < 0)
    return cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  cudaStream_t s = (cudaStream_t)stream;
  if (lanes_per_warp == 0)
    return launch_tensor_cores(device, P, M, b2, mu, thr, x0, x1, x2, h10, h20, x0o, x1o, x2o,
                               h10o, h20o, x0p, B, nl, nw, n_iters, warps, s);
#define FSPM_LAUNCH(L)                                                                 \
  case L:                                                                              \
    return launch<L>(P, M, b2, mu, thr, x0, x1, x2, h10, h20, x0o, x1o, x2o, h10o, h20o, \
                     x0p, B, nl, nw, n_iters, warps, s);
  switch (lanes_per_warp) {
    FSPM_LAUNCH(1)
    FSPM_LAUNCH(2)
    FSPM_LAUNCH(4)
    default:
      return cudaErrorInvalidValue;
  }
#undef FSPM_LAUNCH
}

}  // extern "C"
