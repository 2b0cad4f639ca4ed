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
// takes 0.48 ms (`chip_smoke.py --variants`).
//
// Plain C interface, loaded with ctypes (admmsolver_tpu_torch/ops/_build.py).

#include <cuda_runtime.h>
#include <stddef.h>

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
// nl <= 32 and nw <= 256 (the SpM problem's own width, nl = 30, nw = 201).
//
// A block's 32 lanes are the columns of two small GEMMs per iteration,
// P^T (nl x nw) * T (nw x 32) and P (nw x nl) * X0 (nl x 32), computed in
// split TF32: every f32 operand x is big + small, big = x rounded to TF32
// and small = x - big, and a product is a_small*b_big + a_big*b_small +
// a_big*b_big, three `mma.sync.m16n8k8` with f32 accumulation; the dropped
// term is below 2^-21 of the product.  The tensor core adds into its
// accumulator by truncation, so no chain of mma is longer than 32 steps of
// k: P x0 has nl <= 32 steps, and P^T t is split over the 8 warps by ranges
// of at most 32 frequencies, whose partial sums a rounded f32 add joins.
//
// What that does about the first kernel's limit (an element of P loaded
// from shared memory served 2 FMAs): P is not in shared memory at all.
// Each warp keeps its fragments of P and of P^T in registers for the whole
// chunk, and per iteration loads 64 words of the lanes' vectors for 192
// mma.  h20, x1, h10, b2 and x0 live in the registers of the threads that
// own their elements; shared memory holds T = h20 + mu2*x2 and x0 in
// [feature][lane] layout (the mma's B operand as it lies), the eight
// partial sums of P^T t, hk0 and the per-lane M.  M's matvec stays f32
// FMA, one thread per lane and four rows.  An iteration has four
// block-wide barriers.
// ---------------------------------------------------------------------

constexpr int TC_LANES = 32;     // lanes per block
constexpr int TC_WARPS = 8;
constexpr int TC_THREADS = TC_WARPS * WARP;
constexpr int TC_LS = 40;        // floats between rows of the [feature][lane] arrays
constexpr int TC_NL = 32;        // most coefficients: two m16 tiles, four k8 steps
constexpr int TC_NW = 256;       // most frequencies: four k8 steps for each of 8 warps

// k8 steps of P^T t per warp.
__host__ __device__ inline int tc_k8w(int nw) { return (((nw + 7) / 8) + TC_WARPS - 1) / TC_WARPS; }
// Floats between two lanes' M: odd, so that lanes hit different banks.
__host__ __device__ inline int tc_mst(int nl) { return (nl * nl) | 1; }

size_t smem_bytes_tc(int nl, int nw) {
  return sizeof(float) * ((size_t)(TC_WARPS * tc_k8w(nw) * 8 + 2 * TC_NL + TC_WARPS * TC_NL) * TC_LS +
                          (size_t)TC_LANES * tc_mst(nl));
}

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

// acc[mt][nt] += A[mt] * B[nt] over one k8 step in split TF32; `a` holds the
// raw A fragments of the two m16 tiles, `Bk` points at this thread's (t, g)
// element of the step's 8 rows of a [feature][lane] array.
__device__ __forceinline__ void tc_step(float (&acc)[2][4][4], const float (&a)[2][4],
                                        const float* __restrict__ Bk, bool two_tiles) {
  unsigned abig[2][4], asmall[2][4], bbig[4][2], bsmall[4][2];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      abig[mt][i] = tf32_big(a[mt][i]);
      asmall[mt][i] = __float_as_uint(a[mt][i] - __uint_as_float(abig[mt][i]));
    }
#pragma unroll
  for (int nt = 0; nt < 4; ++nt)
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const float y = Bk[i * 4 * TC_LS + nt * 8];
      bbig[nt][i] = tf32_big(y);
      bsmall[nt][i] = __float_as_uint(y - __uint_as_float(bbig[nt][i]));
    }
  // Up to eight independent accumulators per round, so that no mma waits
  // for the one before it.
  const int tiles = two_tiles ? 2 : 1;
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
      if (mt < tiles) mma_tf32(acc[mt][nt], asmall[mt], bbig[nt]);
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
      if (mt < tiles) mma_tf32(acc[mt][nt], abig[mt], bsmall[nt]);
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
      if (mt < tiles) mma_tf32(acc[mt][nt], abig[mt], bbig[nt]);
}

__global__ void __launch_bounds__(TC_THREADS, 1) fused_spm_tc_kernel(
    const float* __restrict__ P, const float* __restrict__ M,
    const float* __restrict__ b2, const float* __restrict__ mu,
    const float* __restrict__ thr, const float* __restrict__ x0,
    const float* __restrict__ x1, const float* __restrict__ x2,
    const float* __restrict__ h10, const float* __restrict__ h20,
    float* __restrict__ x0o, float* __restrict__ x1o, float* __restrict__ x2o,
    float* __restrict__ h10o, float* __restrict__ h20o, float* __restrict__ x0p,
    int B, int nl, int nw, int n_iters) {
  extern __shared__ __align__(16) float smem[];
  const int k8w = tc_k8w(nw), mst = tc_mst(nl);
  float* const T_s = smem;                                  // [64 k8w][LS]: h20 + mu2*x2
  float* const X0_s = T_s + TC_WARPS * k8w * 8 * TC_LS;     // [32][LS]
  float* const hk_s = X0_s + TC_NL * TC_LS;                 // [32][LS]: hk0
  float* const part_s = hk_s + TC_NL * TC_LS;               // [8 warps][32][LS]: P^T t by k range
  float* const M_s = part_s + TC_WARPS * TC_NL * TC_LS;     // [32 lanes][mst]

  const int tid = threadIdx.x, wp = tid / WARP;
  const int g = (tid % WARP) >> 2, t = tid & 3;   // the mma's group and thread in group
  const int b0 = blockIdx.x * TC_LANES;
  auto Pat = [&](int w, int l) { return (w < nw && l < nl) ? __ldg(P + (size_t)w * nl + l) : 0.f; };

  // This warp's fragments of P (rows 16 (wp + 8 mi) ..., for P x0) and of
  // P^T (frequencies 8 (wp k8w + ks) ..., for its part of P^T t).
  float pa3[2][4][4], pa1[4][2][4];
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int k8 = 0; k8 < 4; ++k8) {
      const int r = (wp + TC_WARPS * mi) * 16 + g, c = k8 * 8 + t;
      pa3[mi][k8][0] = Pat(r, c);
      pa3[mi][k8][1] = Pat(r + 8, c);
      pa3[mi][k8][2] = Pat(r, c + 4);
      pa3[mi][k8][3] = Pat(r + 8, c + 4);
    }
#pragma unroll
  for (int ks = 0; ks < 4; ++ks)
#pragma unroll
    for (int mt = 0; mt < 2; ++mt) {
      const int w = ks < k8w ? (wp * k8w + ks) * 8 + t : nw, l = mt * 16 + g;
      pa1[ks][mt][0] = Pat(w, l);
      pa1[ks][mt][1] = Pat(w, l + 8);
      pa1[ks][mt][2] = Pat(w + 4, l);
      pa1[ks][mt][3] = Pat(w + 4, l + 8);
    }
  const bool two3 = (wp + TC_WARPS) * 16 < nw;  // a second m16 tile of P x0 for this warp

  // Zero what is read beyond nl, nw and B.
  for (int idx = tid; idx < (TC_WARPS * k8w * 8 + 2 * TC_NL) * TC_LS; idx += TC_THREADS)
    T_s[idx] = 0.f;
  __syncthreads();

  // Elements of the P x0 mapping: frequency 16 (wp + 8 mi) + g + 8 (c / 2),
  // lane 8 nt + 2 t + (c & 1).  Each keeps its h20 here; mu2 by lane.
  float h20r[2][4][4], mu2r[8], rmu2r[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int b = b0 + (j / 2) * 8 + 2 * t + (j & 1);
    mu2r[j] = b < B ? mu[2 * (size_t)b + 1] : 1.f;
    rmu2r[j] = 1.f / mu2r[j];
  }
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int w = (wp + TC_WARPS * mi) * 16 + g + 8 * (c / 2);
        const int lane = nt * 8 + 2 * t + (c & 1), b = b0 + lane;
        const bool in = b < B && w < nw;
        const size_t gi = (size_t)b * nw + w;
        const float h = in ? h20[gi] : 0.f, x = in ? x2[gi] : 0.f;
        h20r[mi][nt][c] = h;
        if (w < nw) T_s[w * TC_LS + lane] = h + mu2r[2 * nt + (c & 1)] * x;
        if (in && n_iters == 0) x2o[gi] = x;
      }
  for (int idx = tid; idx < TC_LANES * nl * nl; idx += TC_THREADS) {
    const int lane = idx / (nl * nl), e = idx % (nl * nl);
    M_s[lane * mst + e] = b0 + lane < B ? M[(size_t)(b0 + lane) * nl * nl + e] : 0.f;
  }
  // Elements of the lane-owner mapping: lane tid % 32, coefficients
  // tid / 32 + 8 r.  Each keeps its x0, x1, h10 and b2 here.
  const int ln = tid % WARP, bl = b0 + ln;
  const float mu1 = bl < B ? mu[2 * (size_t)bl] : 1.f, rmu1 = 1.f / mu1;
  const float th = bl < B ? thr[bl] : 0.f;
  float x0r[4], x0old[4], x1r[4], h10r[4], b2r[4];
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int i = wp + 8 * r;
    const bool in = bl < B && i < nl;
    const size_t gi = (size_t)bl * nl + i;
    x0r[r] = x0old[r] = in ? x0[gi] : 0.f;
    x1r[r] = in ? x1[gi] : 0.f;
    h10r[r] = in ? h10[gi] : 0.f;
    b2r[r] = in ? b2[gi] : 0.f;
  }
  __syncthreads();

  const float* const Bt = T_s + (wp * k8w * 8 + t) * TC_LS + g;   // B fragments of P^T t
  const float* const Bx = X0_s + t * TC_LS + g;                   // and of P x0
  for (int it = 0; it <= n_iters; ++it) {
    // 1. This warp's part of P^T t, from T as the iteration before (or the
    //    input state) left it.
    if (it < n_iters) {
      float acc[2][4][4];
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int nt = 0; nt < 4; ++nt)
#pragma unroll
          for (int c = 0; c < 4; ++c) acc[mt][nt][c] = 0.f;
#pragma unroll
      for (int ks = 0; ks < 4; ++ks)
        if (ks < k8w) tc_step(acc, pa1[ks], Bt + ks * 8 * TC_LS, nl > 16);
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int nt = 0; nt < 4; ++nt)
#pragma unroll
          for (int c = 0; c < 4; c += 2) {
            const int l = mt * 16 + g + 8 * (c / 2);
            *reinterpret_cast<float2*>(part_s + (wp * TC_NL + l) * TC_LS + nt * 8 + 2 * t) =
                make_float2(acc[mt][nt][c], acc[mt][nt][c + 1]);
          }
    }
    __syncthreads();
    if (it == n_iters) break;
    const bool last = it == n_iters - 1;

    // 2a. hk0 = -h10 - mu1*x1 - P^T t, the eight parts added in order.
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int i = wp + 8 * r;
      if (i >= nl) continue;
      float s = 0.f;
#pragma unroll
      for (int w = 0; w < TC_WARPS; ++w) s += part_s[(w * TC_NL + i) * TC_LS + ln];
      hk_s[i * TC_LS + ln] = -h10r[r] - mu1 * x1r[r] - s;
    }
    __syncthreads();

    // 2b. x0 = b2 - M hk0, then x1 and h10.
    {
      float acc[4] = {0.f, 0.f, 0.f, 0.f};
      const float* const Ml = M_s + ln * mst;
#pragma unroll 6
      for (int j = 0; j < nl; ++j) {
        const float v = hk_s[j * TC_LS + ln];
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int i = wp + 8 * r;
          acc[r] = fmaf(Ml[(i < nl ? i : nl - 1) * nl + j], v, acc[r]);
        }
      }
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int i = wp + 8 * r;
        if (i >= nl) continue;
        const float x0n = b2r[r] - acc[r];
        const float z = -div_by(h10r[r] - mu1 * x0n, mu1, rmu1);
        const float a = fmaxf(fabsf(z) - th, 0.f);
        const float x1n = z > 0.f ? a : (z < 0.f ? -a : z * 0.f);
        h10r[r] += mu1 * (x1n - x0n);
        x0old[r] = x0r[r];
        x0r[r] = x0n;
        x1r[r] = x1n;
        X0_s[i * TC_LS + ln] = x0n;
      }
    }
    __syncthreads();

    // 3. Px0 = P x0, then x2, h20 and the next iteration's T.
    {
      float acc[2][4][4];
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int nt = 0; nt < 4; ++nt)
#pragma unroll
          for (int c = 0; c < 4; ++c) acc[mt][nt][c] = 0.f;
#pragma unroll
      for (int k8 = 0; k8 < 4; ++k8) {
        if (k8 * 8 >= nl) continue;
        const float a[2][4] = {{pa3[0][k8][0], pa3[0][k8][1], pa3[0][k8][2], pa3[0][k8][3]},
                               {pa3[1][k8][0], pa3[1][k8][1], pa3[1][k8][2], pa3[1][k8][3]}};
        tc_step(acc, a, Bx + k8 * 8 * TC_LS, two3);
      }
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
#pragma unroll
        for (int nt = 0; nt < 4; ++nt)
#pragma unroll
          for (int c = 0; c < 4; c += 2) {
            const int w = (wp + TC_WARPS * mi) * 16 + g + 8 * (c / 2);
            float tt[2];
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const float m = mu2r[2 * nt + e], h = h20r[mi][nt][c + e], px = acc[mi][nt][c + e];
              const float z = -div_by(h - m * px, m, rmu2r[2 * nt + e]);
              const float x2n = z < 0.f ? 0.f : z;
              const float hn = h + m * (x2n - px);
              h20r[mi][nt][c + e] = hn;
              tt[e] = hn + m * x2n;
              const int b = b0 + nt * 8 + 2 * t + e;
              if (last && b < B && w < nw) x2o[(size_t)b * nw + w] = x2n;
            }
            if (w < nw)
              *reinterpret_cast<float2*>(T_s + w * TC_LS + nt * 8 + 2 * t) =
                  make_float2(tt[0], tt[1]);
          }
    }
    __syncthreads();
  }

#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int i = wp + 8 * r;
    if (bl >= B || i >= nl) continue;
    const size_t gi = (size_t)bl * nl + i;
    x0o[gi] = x0r[r];
    x1o[gi] = x1r[r];
    h10o[gi] = h10r[r];
    x0p[gi] = x0old[r];
  }
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int w = (wp + TC_WARPS * mi) * 16 + g + 8 * (c / 2);
        const int b = b0 + nt * 8 + 2 * t + (c & 1);
        if (b < B && w < nw) h20o[(size_t)b * nw + w] = h20r[mi][nt][c];
      }
}

int launch_tc(const float* P, const float* M, const float* b2, const float* mu,
              const float* thr, const float* x0, const float* x1, const float* x2,
              const float* h10, const float* h20, float* x0o, float* x1o, float* x2o,
              float* h10o, float* h20o, float* x0p, int B, int nl, int nw, int n_iters,
              cudaStream_t stream) {
  if (nl > TC_NL || nw > TC_NW) return cudaErrorInvalidValue;
  const size_t smem = smem_bytes_tc(nl, nw);
  cudaError_t err = cudaFuncSetAttribute(
      fused_spm_tc_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  fused_spm_tc_kernel<<<(B + TC_LANES - 1) / TC_LANES, TC_THREADS, smem, stream>>>(
      P, M, b2, mu, thr, x0, x1, x2, h10, h20, x0o, x1o, x2o, h10o, h20o, x0p, B, nl, nw,
      n_iters);
  return cudaGetLastError();
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
// `lanes` = 0: of a block of the tensor-core kernel.
size_t fused_spm_smem_bytes(int lanes, int nl, int nw) {
  return lanes ? smem_bytes(lanes, nl, nw) : smem_bytes_tc(nl, nw);
}

// The device's opt-in shared-memory limit per block, in bytes.
int fused_spm_max_smem(int device, int* bytes) {
  return cudaDeviceGetAttribute(bytes, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
}

const char* fused_spm_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

// Launch on `stream` without synchronising; returns cudaGetLastError() after
// the launch (0 on success).  A block has `warps` warps (1..16) of
// `lanes_per_warp` lanes (1, 2 or 4) each; `lanes_per_warp` = 0 launches the
// tensor-core kernel (nl <= 32, nw <= 256; 32 lanes and 8 warps a block).
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
    return launch_tc(P, M, b2, mu, thr, x0, x1, x2, h10, h20, x0o, x1o, x2o, h10o, h20o, x0p,
                     B, nl, nw, n_iters, s);
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
