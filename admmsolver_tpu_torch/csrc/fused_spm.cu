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
// What bounds it on this card: operations.  One lane-iteration is
// 4*nl*nw + 2*nl*nl FMA-flops plus about 10*(nl+nw) elementwise ones
// (28.2 kflop at nl=30, nw=201), all full f32 on the CUDA cores (TF32 would
// corrupt the solve), against 4*(nl*nl + 4*nl + 2*nw) bytes of device memory
// per lane once per chunk.  What stands between the kernel and the FMA peak
// is shared-memory load traffic: every FMA needs an element of P and an
// element of a lane's vector.
//
// What the design does about it: a warp owns L lanes (L = 1, 2 or 4) for the
// whole chunk and needs no block-wide barrier inside the iteration loop.
// Each element of P a thread loads from shared memory is used for L lanes
// (and each 16-byte broadcast load of a lane's vector for 4 FMAs per row of
// P), so a group of 4 lanes needs about 0.3-0.5 shared loads per FMA where
// one lane alone needs 2.  All per-lane state stays in shared memory across
// the chunk, M included (nl*(nl_pad+1) floats per lane: reading it from L2
// every iteration would be 1.5 GB per chunk at B=4096).  x2 itself is not
// kept: an iteration reads it only through t = h20 + mu2*x2, so the kernel
// keeps t and h20 and stores x2 from registers in the last iteration.  That
// brings a lane to 6240 bytes at nl=30, nw=201, so that 32 lanes and P fit
// the 227 KB of one SM and B=4096 runs as one wave of 128 blocks on 132 SMs.
// Rows of P and of M are padded to an odd stride so that threads walking
// down a column hit different banks.  The wrapper chooses L and the warps
// per block (ops/kernels.py, _spm_tiling): one wave first, then the most
// warps.  On an H100 (80GB HBM3, 700 W) at that shape, 100 iterations take
// 1.06 ms with 16 warps of 2 lanes, 1.25 ms with 8 warps of 4 (fewer shared
// loads per FMA, but too few warps to hide their latency) and 1.35 ms with
// 16 warps of 1 lane (two waves); the bound is 0.17 ms.
//
// Plain C interface, loaded with ctypes (admmsolver_tpu_torch/ops/_build.py).

#include <cuda_runtime.h>
#include <stddef.h>

namespace {

constexpr int WARP = 32;
constexpr int MAX_WARPS = 16;  // warps per block
constexpr int KR = 4;          // rows of P per thread and pass in P x0

__host__ __device__ inline int round_up(int a, int b) { return (a + b - 1) / b * b; }

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

// Dynamic shared memory, in bytes, of a block that holds `lanes` lanes.
size_t fused_spm_smem_bytes(int lanes, int nl, int nw) { return smem_bytes(lanes, nl, nw); }

// The device's opt-in shared-memory limit per block, in bytes.
int fused_spm_max_smem(int device, int* bytes) {
  return cudaDeviceGetAttribute(bytes, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
}

const char* fused_spm_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

// Launch on `stream` without synchronising; returns cudaGetLastError() after
// the launch (0 on success).  A block has `warps` warps (1..16) of
// `lanes_per_warp` lanes (1, 2 or 4) each.
int fused_spm_chunk(int device, const float* P, const float* M, const float* b2,
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
