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
// Three kernels compute it; the wrapper (ops/kernels.py, _two_block_tiling)
// takes the wgmma kernel for a thin basis (R <= 128, the last section of
// this file), the mma.sync tensor-core kernel wherever else a block can
// hold 32 lanes and the FMA kernel otherwise.  All are full f32 in meaning:
// plain TF32 keeps ~1e-3 relative accuracy, which corrupts the
// shifted-quadratic solve.
//
// What bounds them on this card (NVIDIA H100 80GB HBM3, 700 W; times per
// 100 iterations at B=4096, N=512, R=256 from `chip_smoke.py --variants`):
// the two products, 4*B*N*R FLOPs per iteration.
//  * As f32 FMA they cannot take less than 3.24 ms, and not less than the
//    shared-memory loads that feed them: a 16-byte load hands 512 bytes to
//    a warp's registers whether or not its threads share addresses, an SM
//    moves 128 bytes a clock, and the FMA kernel's 4 x 8 register tile
//    needs 3 such loads per 32 FMA instructions (12 clocks of loads beside
//    8 of FMA issue).  The FMA kernel takes 6.6 ms.
//  * On the tensor cores in split TF32 each product is three mma, 1.30 ms
//    at the dense TF32 rate, and a warp loads 16 words per 24 mma.  Then U
//    and Ut come to the fore: no block can hold them (512 KiB each), every
//    block streams both from L2 once per iteration, and all blocks want the
//    same rows at the same time.  L2 itself gives 132 such readers 11.6
//    TB/s; what the copies cost is their latency against a ring of two or
//    three k-tiles.  The tensor-core kernel takes 5.5 ms.
//
// What the design does about it (both kernels):
//  * A block owns TB = 32 lanes for the whole chunk (B = 4096 is one wave of
//    128 blocks), so U and Ut cross L2 -> SM 128 times per iteration (64
//    times with pairs of blocks, below).  Only what an iteration reads stays
//    in shared memory: v, h (the tensor-core kernel keeps h in device memory
//    instead) and the (TB, R) intermediate w, stored k-major ([k][lane],
//    XOR-swizzled against bank conflicts) so that they are the products'
//    left operands as they lie.
//    acy and dinv are re-read from L2 while a product runs; x0 and x1 live
//    in registers and reach device memory in the last iteration only
//    (x0_prev in the one before it).
//  * k-tiles of U and Ut (KT rows x 256 columns) arrive in a ring of
//    shared-memory stages filled by a producer warp with bulk asynchronous
//    copies (cp.async.bulk) that complete on an mbarrier per stage; a
//    consumer warp waits on the stage's "full" barrier and releases it on
//    its "empty" barrier.  There is no block-wide barrier per k-tile and no
//    register bounce; the consumers meet twice per iteration (after w and
//    after v are written).  The producer runs ahead across products and
//    iterations, and the consumers load the next step's operands before
//    the current step's arithmetic, across k-tiles too.
//  * With a thread-block cluster of CL blocks each producer fetches 1/CL of
//    every k-tile and multicasts it into the shared memory of all CL
//    blocks, cutting the L2 reads by CL.  Pairs gain 10%; clusters of 4 lose
//    (every stage then waits for four blocks).
//  * The epilogues are straight-line code over 16 elements at a time, with
//    the divisions by mu written as a corrected multiplication by 1/mu, so
//    that independent elements overlap instead of queueing behind one
//    another's branches.
//  * FMA kernel: a thread accumulates 4 lanes x 8 columns (two groups of 4
//    adjacent columns, so a warp's 16-byte loads of a k-tile row are
//    contiguous); a warp covers 16 lanes x 64 columns, 8 warps a pass of
//    256 columns.  Sums run over k in ascending order.
//  * Tensor-core kernel: see its own comment further down.
//  * Ragged B, N and R are masked here; when N or R is not a multiple of 4
//    (or a base pointer is not 16-byte aligned) the producer fills the
//    stages with plain loads instead of bulk copies, and there is no
//    cluster.
//
// The wgmma kernel (thin basis, R <= 128; the last section of this file)
// replaces, for that shape, the same TPU kernel (admmsolver_tpu/ops/
// kernels.py `fused_two_block_chunk`), which the mma.sync kernel above
// served at every R.  At the benchmark's shape (B = 4096, N = 1000,
// R = 100) what bounds it on this card, per 100-iteration chunk:
//  * The tensor rate of the three products: 3 x 4 B N R multiply-adds with
//    R padded to 128 rows in product 1 and K = R padded to 104 in product
//    2, at the dense TF32 rate, ~1.2 ms (`wgmma.m64n32k8` with A from
//    registers runs at 17 clocks an instruction, ~90% of that rate, in a
//    kernel that does nothing else).  The design puts the basis on the
//    64-row side of each product, so that R = 100 fills 78% of the rows
//    where the mma.sync kernel left over half its warps without columns,
//    and splits the basis into head and tail in registers.
//  * The L2 stream of the basis: every block reads U and Ut once an
//    iteration, 1 MB with the padding, ~1.1 ms at the 11.6 TB/s measured
//    below.  The design moves each 8 KB tile with one TMA copy from a
//    producer warp, 3 tiles ahead (a pair multicast, or starting each
//    block's walk over the tiles at another place, measured no gain here).
//  * Neither is what it meets: it takes 6.0-6.2 ms against the mma.sync
//    kernel's 10.7 in the same calls (H100 80GB HBM3, 700 W).  Its two
//    consumer warpgroups (two warps to a scheduler, 240 registers a
//    thread) spend most of a chunk on each atom's own latency (wait for
//    the tile, load and split its operands, the products, the rounded add
//    that restarts the head chain every 32 steps of k) and on the
//    epilogues (removing the prox arithmetic alone saves 0.8 ms); the
//    products add 2.3 ms to the 3.7 ms the kernel takes without them.
//    Taking turns at the epilogues gains 4%, a tile's h and acy fetched a
//    tile ahead and moved as float4s a few %; deeper pipelining (two atoms
//    in flight) needs registers the warpgroups do not have and spills.
//
// Within a kernel the order of every sum is fixed, whatever TB, KT, the
// stage count and the cluster size: all tilings of one kernel give the
// same bits, and the kernels differ by rounding only.  Nor does a lane's
// place in the batch change a bit: every block walks its tiles in one order.
//
// Plain C interface, loaded with ctypes (admmsolver_tpu_torch/ops/_build.py).

#include <cuda.h>           // CUtensorMap and its enums (types only)
#include <cudaTypedefs.h>   // PFN_cuTensorMapEncodeTiled, taken from the driver at run time
#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

namespace {

constexpr int CW = 256;  // columns of a k-tile and of one pass over the outputs

__host__ __device__ inline int round_up(int a, int b) { return (a + b - 1) / b * b; }

template <int TB>
struct Layout {
  static constexpr int TM = TB < 4 ? TB : 4;       // lanes per thread
  static constexpr int RG = TB / TM;               // row groups in the block
  static constexpr int RTW = RG < 4 ? RG : 4;      // row groups in a warp
  static constexpr int CTW = 32 / RTW;             // column threads in a warp
  static constexpr int WCOLS = CTW * 8;            // columns a warp covers
  static constexpr int WR = RG / RTW;              // warps along the lanes
  static constexpr int WC = CW / WCOLS;            // warps along the columns
  static constexpr int WARPS = WR * WC;            // consumer warps
  static constexpr int CONSUMERS = WARPS * 32;
  static constexpr int THREADS = CONSUMERS + 32;   // and one producer warp
  static constexpr int SC = TB < 4 ? 4 : TB;       // floats kept for mu and for thr
  // Lane state is k-major: row k holds the block's TB lanes.  Its 16-byte
  // chunks (4 lanes) are XOR-swizzled with k/4, so that the threads of a
  // warp, whose columns lie 4 apart, hit different banks in the epilogues.
  static constexpr int SWZ = TB >= 8 ? TB / 4 - 1 : 0;
  __host__ __device__ static constexpr int swz(int k) { return (k >> 2) & SWZ; }
  // Offset of lane r of row k.
  __host__ __device__ static constexpr int at(int k, int r) {
    return k * TB + ((((r >> 2) ^ swz(k)) << 2) | (r & 3));
  }
};

size_t smem_bytes(int tb, int n, int r, int kt, int stages) {
  const int sc = tb < 4 ? 4 : tb;
  return sizeof(float) * ((size_t)stages * kt * CW +
                          (size_t)(2 * round_up(n, kt) + round_up(r, kt)) * tb + 2 * sc) +
         (size_t)16 * stages;
}

// ---- mbarriers, bulk copies, clusters (PTX) ----

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(bar) : "memory");
}

// Arrive on the barrier at the same offset in block `rank` of the cluster.
__device__ __forceinline__ void mbar_arrive_cluster(uint32_t bar, uint32_t rank) {
  uint32_t remote;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;" : "=r"(remote) : "r"(bar), "r"(rank));
  asm volatile("mbarrier.arrive.shared::cluster.b64 _, [%0];" ::"r"(remote) : "memory");
}

__device__ __forceinline__ void mbar_arrive_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(bar), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void bulk_copy(uint32_t dst, const void* src, uint32_t bytes,
                                          uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];"
      ::"r"(dst), "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

// The copy lands at the same offset in every block of `mask` and completes
// on the barrier at the same offset in each of them.
__device__ __forceinline__ void bulk_copy_multicast(uint32_t dst, const void* src,
                                                    uint32_t bytes, uint32_t bar,
                                                    uint16_t mask) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes.multicast::cluster "
      "[%0], [%1], %2, [%3], %4;"
      ::"r"(dst), "l"(src), "r"(bytes), "r"(bar), "h"(mask)
      : "memory");
}

__device__ __forceinline__ uint32_t cluster_rank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;" : "=r"(r));
  return r;
}

__device__ __forceinline__ void cluster_sync() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n"
               "barrier.cluster.wait.acquire.aligned;" ::: "memory");
}

template <int COUNT>
__device__ __forceinline__ void consumer_sync() {
  asm volatile("bar.sync 1, %0;" ::"n"(COUNT) : "memory");
}

// The ring of k-tile stages as both sides see it: `full[s]` at bars + 8 s,
// `empty[s]` at bars + 8 (stages + s); the same walk over stages and phases
// on the producer's and the consumers' side.
struct Ring {
  uint32_t bars;
  int stages, stage = 0;
  uint32_t phase = 0;
  __device__ Ring(uint32_t bars_, int stages_) : bars(bars_), stages(stages_) {}
  __device__ __forceinline__ uint32_t full() const { return bars + 8 * stage; }
  __device__ __forceinline__ uint32_t empty() const { return bars + 8 * (stages + stage); }
  __device__ __forceinline__ void advance() {
    if (++stage == stages) {
      stage = 0;
      phase ^= 1;
    }
  }
};

// TM lanes of row `row` (an offset in floats) of the k-major lane state,
// starting at 16-byte chunk `chunk` before the row's swizzle `s`.
template <int TM>
__device__ __forceinline__ void load_lanes(float (&d)[TM], const float* row, int chunk, int s) {
  if constexpr (TM == 4) {
    const float* p = row + ((chunk ^ s) << 2);
    const float4 t = *reinterpret_cast<const float4*>(p);
    d[0] = t.x, d[1] = t.y, d[2] = t.z, d[3] = t.w;
  } else if constexpr (TM == 2) {
    const float2 t = *reinterpret_cast<const float2*>(row);
    d[0] = t.x, d[1] = t.y;
  } else {
    d[0] = *row;
  }
}

template <int TM>
__device__ __forceinline__ void store_lanes(float* row, int chunk, int s, const float (&d)[TM]) {
  if constexpr (TM == 4) {
    *reinterpret_cast<float4*>(row + ((chunk ^ s) << 2)) = make_float4(d[0], d[1], d[2], d[3]);
  } else if constexpr (TM == 2) {
    *reinterpret_cast<float2*>(row) = make_float2(d[0], d[1]);
  } else {
    *row = d[0];
  }
}

// Producer warp: the k-tiles of the row-major (K, ncols) matrix Bg, column
// pass by column pass, into the ring.  Rows past K are zero-filled; columns
// past ncols are left as they are (their outputs are never stored).  A
// stage holds KT rows LDB floats apart.
template <int KT, int LDB>
__device__ __forceinline__ void produce(const float* __restrict__ Bg, int K, int ncols,
                                        bool bulk, int cl, uint32_t rank, float* ring_s,
                                        Ring& ring, int lane) {
  for (int c0 = 0; c0 < ncols; c0 += CW) {
    const int seg = min(CW, ncols - c0);
    for (int k0 = 0; k0 < K; k0 += KT) {
      mbar_wait(ring.empty(), ring.phase ^ 1);
      float* dst = ring_s + ring.stage * (KT * LDB);
      const int rows = min(KT, K - k0);
      if (bulk) {
        if (rows < KT) {
          for (int idx = rows * LDB + lane; idx < KT * LDB; idx += 32) dst[idx] = 0.f;
          asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
          __syncwarp();
        }
        if (lane == 0) mbar_arrive_expect_tx(ring.full(), (uint32_t)(rows * seg) * 4u);
        for (int r = lane; r < rows; r += 32) {
          const float* src = Bg + (size_t)(k0 + r) * ncols + c0;
          if (cl == 1) {
            bulk_copy(smem_u32(dst + r * LDB), src, (uint32_t)seg * 4u, ring.full());
          } else if (r % cl == (int)rank) {
            bulk_copy_multicast(smem_u32(dst + r * LDB), src, (uint32_t)seg * 4u, ring.full(),
                                (uint16_t)((1u << cl) - 1u));
          }
        }
      } else {
#pragma unroll 8
        for (int idx = lane; idx < KT * CW; idx += 32) {
          const int r = idx / CW, c = idx % CW;
          dst[r * LDB + c] = (r < rows && c < seg) ? __ldg(Bg + (size_t)(k0 + r) * ncols + c0 + c) : 0.f;
        }
        __syncwarp();
        if (lane == 0) mbar_arrive(ring.full());
      }
      ring.advance();
    }
  }
}

// Consumer: acc[i][j] = sum over k < K, in ascending k, of
// A_s[k][lane i of this thread] * tile(k)[col_j], with col_j = j for j < 4
// and CTW*4 + j - 4 above, relative to `ring_s` (which already points at
// this thread's first column).  `chunk` is the thread's first 16-byte chunk
// of a lane row.  The operands of step k + 1 are loaded before the FMAs of
// step k, across k-tiles too, so that a warp never waits for shared memory
// right behind a stage's barrier.
template <int TB, int KT>
__device__ __forceinline__ void product(float (&acc)[Layout<TB>::TM][8],
                                        const float* __restrict__ A_s, int chunk, int K,
                                        const float* __restrict__ ring_s, Ring& ring, int cl,
                                        int lane) {
  using L = Layout<TB>;
  constexpr int TM = L::TM;
  static_assert(KT % 8 == 0, "steps alternate between two operand buffers");
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  float a[2][TM];
  float4 b[2][2];
  mbar_wait(ring.full(), ring.phase);
  const float* Bs = ring_s + ring.stage * (KT * CW);
  load_lanes<TM>(a[0], A_s, chunk, 0);
  b[0][0] = *reinterpret_cast<const float4*>(Bs);
  b[0][1] = *reinterpret_cast<const float4*>(Bs + L::CTW * 4);

  for (int k0 = 0; k0 < K; k0 += KT) {
    const float* As = A_s + k0 * TB;
    const int s0 = k0 >> 2;
    const bool more = k0 + KT < K;
    int next_stage = ring.stage + 1;
    uint32_t next_phase = ring.phase;
    if (next_stage == ring.stages) {
      next_stage = 0;
      next_phase ^= 1;
    }
    const float* Bn = ring_s + next_stage * (KT * CW);
#pragma unroll
    for (int kk = 0; kk < KT; ++kk) {
      const int cur = kk & 1, nxt = cur ^ 1;
      if (kk + 1 < KT) {
        load_lanes<TM>(a[nxt], As + (kk + 1) * TB, chunk, (s0 + ((kk + 1) >> 2)) & L::SWZ);
        b[nxt][0] = *reinterpret_cast<const float4*>(Bs + (kk + 1) * CW);
        b[nxt][1] = *reinterpret_cast<const float4*>(Bs + (kk + 1) * CW + L::CTW * 4);
      } else if (more) {
        mbar_wait(ring.bars + 8 * next_stage, next_phase);
        load_lanes<TM>(a[nxt], As + KT * TB, chunk, (s0 + (KT >> 2)) & L::SWZ);
        b[nxt][0] = *reinterpret_cast<const float4*>(Bn);
        b[nxt][1] = *reinterpret_cast<const float4*>(Bn + L::CTW * 4);
      }
      const float bb[8] = {b[cur][0].x, b[cur][0].y, b[cur][0].z, b[cur][0].w,
                           b[cur][1].x, b[cur][1].y, b[cur][1].z, b[cur][1].w};
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[cur][i], bb[j], acc[i][j]);
    }
    // This warp is done with the stage: tell the producer of every block
    // that writes into it.
    __syncwarp();
    if (cl == 1) {
      if (lane == 0) mbar_arrive(ring.empty());
    } else if (lane < cl) {
      mbar_arrive_cluster(ring.empty(), (uint32_t)lane);
    }
    ring.advance();
    Bs = Bn;
  }
}

// x / m from rm = 1 / m rounded to nearest: the quotient estimate x * rm
// corrected once by its exact remainder, which is the correctly rounded
// quotient (Markstein) up to rare last-bit cases.  Unlike `x / m` it has no
// branch to a slow path, so the epilogue's independent elements interleave.
__device__ __forceinline__ float div_by(float x, float m, float rm) {
  const float q = x * rm;
  return fmaf(fmaf(-q, m, x), rm, q);
}

// One element of the second half of an iteration: x0 from the product's
// sum `x0n` (+ v/mu when thin), the prox, the dual ascent and the next v.
__device__ __forceinline__ void update(float& x0n, float& x1n, float& hv, float& vv, float m,
                                       float rm, float th, float acyv, bool thin, bool nonneg,
                                       bool zero_x1) {
  if (thin) x0n += div_by(vv, m, rm);
  const float z = x0n - div_by(hv, m, rm);
  if (nonneg) {
    x1n = z < 0.f ? 0.f : z;
  } else {
    const float t = fmaxf(fabsf(z) - th, 0.f);
    x1n = z > 0.f ? t : (z < 0.f ? -t : z * 0.f);
  }
  if (zero_x1) x1n = 0.f;
  hv = hv + m * (x1n - x0n);
  vv = acyv + hv + m * x1n;
}

// prox: bit 1 set = nonneg (else soft-threshold), bit 0 set = `_even` mode.
template <int TB, int KT>
__global__ void __launch_bounds__(Layout<TB>::THREADS, 1) fused_two_block_kernel(
    const float* __restrict__ U, const float* __restrict__ Ut,
    const float* __restrict__ dinv, const float* __restrict__ acy,
    const float* __restrict__ mu, const float* __restrict__ thr,
    const float* __restrict__ x0, const float* __restrict__ x1,
    const float* __restrict__ h, float* __restrict__ x0o,
    float* __restrict__ x1o, float* __restrict__ ho, float* __restrict__ x0p,
    int B, int N, int R, int n_iters, int prox, int thin, int stages, int cl, int bulk) {
  using L = Layout<TB>;
  constexpr int TM = L::TM;
  extern __shared__ __align__(128) float smem[];
  const int Nk = round_up(N, KT), Rk = round_up(R, KT);
  float* ring_s = smem;
  float* v_s = ring_s + stages * (KT * CW);
  float* h_s = v_s + Nk * TB;
  float* w_s = h_s + Nk * TB;
  float* mu_s = w_s + Rk * TB;
  float* thr_s = mu_s + L::SC;
  uint64_t* bars = reinterpret_cast<uint64_t*>(thr_s + L::SC);

  const int tid = threadIdx.x;
  const int b0 = blockIdx.x * TB;

  if (tid == 0) {
    for (int s = 0; s < stages; ++s) {
      mbar_init(smem_u32(bars + s), 1);
      mbar_init(smem_u32(bars + stages + s), L::WARPS * cl);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  // Load the tile.  Lanes past B hold zeros (mu = 1), which stay zero and
  // finite through every iteration; so do the k-rows past N and R.
  for (int idx = tid; idx < (2 * Nk + Rk) * TB; idx += L::THREADS) v_s[idx] = 0.f;
  for (int r = tid; r < TB; r += L::THREADS) {
    const bool ok = b0 + r < B;
    mu_s[r] = ok ? mu[b0 + r] : 1.f;
    thr_s[r] = ok ? thr[b0 + r] : 0.f;
  }
  __syncthreads();
  for (int idx = tid; idx < TB * N; idx += L::THREADS) {
    const int r = idx / N, n = idx % N;
    if (b0 + r >= B) continue;
    const size_t g = (size_t)(b0 + r) * N + n;
    const float hv = h[g], x1v = x1[g];
    h_s[L::at(n, r)] = hv;
    v_s[L::at(n, r)] = acy[g] + hv + mu_s[r] * x1v;
    if (n_iters <= 1) x0p[g] = x0[g];
    if (n_iters == 0) {
      x0o[g] = x0[g];
      x1o[g] = x1v;
      ho[g] = hv;
    }
  }
  if (cl > 1) cluster_sync(); else __syncthreads();

  Ring ring(smem_u32(bars), stages);

  if (tid >= L::CONSUMERS) {
    // ---- producer warp ----
    const int lane = tid - L::CONSUMERS;
    const uint32_t rank = cl > 1 ? cluster_rank() : 0u;
    for (int it = 0; it < n_iters; ++it) {
      produce<KT, CW>(U, N, R, bulk, cl, rank, ring_s, ring, lane);
      produce<KT, CW>(Ut, R, N, bulk, cl, rank, ring_s, ring, lane);
    }
  } else {
    // ---- consumer warps ----
    const int warp = tid / 32, lane = tid % 32;
    const int rt = lane / L::CTW, ct = lane % L::CTW;
    const int row0 = ((warp % L::WR) * L::RTW + rt) * TM;   // first lane of this thread
    const int chunk = row0 >> 2;                            // its 16-byte chunk in a lane row
    const int col0 = (warp / L::WR) * L::WCOLS + ct * 4;    // first column, within a pass
    const bool nonneg = prox & 2;
    const bool even = prox & 1;
    float m[TM], rm[TM], th[TM];
#pragma unroll
    for (int i = 0; i < TM; ++i) {
      m[i] = mu_s[row0 + i];
      rm[i] = 1.f / m[i];
      th[i] = thr_s[row0 + i];
    }

    for (int it = 0; it < n_iters; ++it) {
      const bool last = it == n_iters - 1;
      const bool before_last = it == n_iters - 2;

      // w = (v U) * dinv
      for (int c0 = 0; c0 < R; c0 += CW) {
        float pre[TM][8];  // dinv, fetched from L2 while the product runs
#pragma unroll
        for (int i = 0; i < TM; ++i)
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            const int c = c0 + col0 + (j < 4 ? j : L::CTW * 4 + j - 4);
            const int b = b0 + row0 + i;
            pre[i][j] = (b < B && c < R) ? __ldg(dinv + (size_t)b * R + c) : 0.f;
          }
        float acc[TM][8];
        product<TB, KT>(acc, v_s, chunk, N, ring_s + col0, ring, cl, lane);
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int c = c0 + col0 + (j < 4 ? j : L::CTW * 4 + j - 4);
          if (c >= R) continue;
          float wv[TM];
#pragma unroll
          for (int i = 0; i < TM; ++i) wv[i] = acc[i][j] * pre[i][j];
          store_lanes<TM>(w_s + c * TB, chunk, L::swz(c), wv);
        }
      }
      consumer_sync<L::CONSUMERS>();

      // x0 = w Ut (+ v/mu), prox, dual ascent, and the next iteration's v.
      // Each (lane, column) belongs to one thread, which alone reads and
      // writes its h and v here.
      for (int c0 = 0; c0 < N; c0 += CW) {
        float pre[TM][8];  // acy
#pragma unroll
        for (int i = 0; i < TM; ++i)
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            const int n = c0 + col0 + (j < 4 ? j : L::CTW * 4 + j - 4);
            const int b = b0 + row0 + i;
            pre[i][j] = (b < B && n < N) ? __ldg(acy + (size_t)b * N + n) : 0.f;
          }
        float acc[TM][8];
        product<TB, KT>(acc, w_s, chunk, R, ring_s + col0, ring, cl, lane);
        // Four columns at a time: loads, then the arithmetic of all 4 TM
        // elements as one straight line, then the stores.
#pragma unroll
        for (int j0 = 0; j0 < 8; j0 += 4) {
          const int n0 = c0 + col0 + (j0 ? L::CTW * 4 : 0);
          float hv[4][TM], vv[4][TM], x0r[4][TM], x1r[4][TM];
#pragma unroll
          for (int j = 0; j < 4; ++j) {
#pragma unroll
            for (int i = 0; i < TM; ++i) hv[j][i] = vv[j][i] = 0.f;
            if (n0 + j < N) {
              load_lanes<TM>(hv[j], h_s + (n0 + j) * TB, chunk, L::swz(n0 + j));
              if (thin) load_lanes<TM>(vv[j], v_s + (n0 + j) * TB, chunk, L::swz(n0 + j));
            }
          }
#pragma unroll
          for (int j = 0; j < 4; ++j)
#pragma unroll
            for (int i = 0; i < TM; ++i) {
              x0r[j][i] = acc[i][j0 + j];
              update(x0r[j][i], x1r[j][i], hv[j][i], vv[j][i], m[i], rm[i], th[i],
                     pre[i][j0 + j], thin, nonneg, even && ((n0 + j) & 1));
            }
#pragma unroll
          for (int j = 0; j < 4; ++j)
            if (n0 + j < N) {
              store_lanes<TM>(h_s + (n0 + j) * TB, chunk, L::swz(n0 + j), hv[j]);
              store_lanes<TM>(v_s + (n0 + j) * TB, chunk, L::swz(n0 + j), vv[j]);
            }
          if (last || before_last) {
#pragma unroll
            for (int j = 0; j < 4; ++j)
#pragma unroll
              for (int i = 0; i < TM; ++i) {
                const int b = b0 + row0 + i;
                if (b >= B || n0 + j >= N) continue;
                const size_t g = (size_t)b * N + n0 + j;
                if (last) {
                  x0o[g] = x0r[j][i];
                  x1o[g] = x1r[j][i];
                  ho[g] = hv[j][i];
                } else {
                  x0p[g] = x0r[j][i];
                }
              }
          }
        }
      }
      consumer_sync<L::CONSUMERS>();
    }
  }
  // No block of a cluster may leave while another can still write into its
  // shared memory or arrive on its barriers.
  if (cl > 1) cluster_sync();
}

// ---------------------------------------------------------------------
// The same chunk with both products on the tensor cores in split TF32
// ("3xTF32"): every f32 operand x is taken as big + small, big = x rounded
// to TF32 (10 mantissa bits) and small = x - big (exact in f32, cut to TF32
// by the tensor core), and a product a*b as a_small*b_big + a_big*b_small +
// a_big*b_big, three `mma.sync.m16n8k8` with f32 accumulation.  The dropped
// term is below 2^-21 of the product; plain TF32 (one mma) would keep 2^-11.
//
// A block is 32 lanes and 8 consumer warps; a warp computes all 32 lanes
// (two m16 tiles) of 32 columns (four n8 tiles) per pass of 256 columns.
// Per 8 steps of k it loads 16 operand words from shared memory for 24 mma,
// an eighth of the FMA kernel's shared-memory traffic per product.  Lane
// state is k-major with the lane index XOR-swizzled by k so that fragment
// loads and the epilogue's scalar accesses spread over the banks; a stage's
// rows are CW + 8 floats apart for the same reason.  h is not kept in shared
// memory: its owner reads and writes it in the output array `ho` (through
// L2) once per iteration, which leaves room for a third k-tile of 32 rows
// in the ring (5.5 ms against 5.8 with h in shared memory and two k-tiles).
// ---------------------------------------------------------------------

constexpr int TC_TB = 32;
constexpr int TC_WARPS = 8;
constexpr int TC_CONSUMERS = TC_WARPS * 32;
// The producer is the first warp of a third warpgroup whose other warps
// idle: a warpgroup of its own lets it hand most of its registers to the
// consumers (setmaxnreg), which need about 200 each.
constexpr int TC_THREADS = TC_CONSUMERS + 128;
constexpr int TC_PRODUCER_REGS = 40, TC_CONSUMER_REGS = 232;
constexpr int TC_LDB = CW + 8;
constexpr int TC_FLUSH = 32;  // steps of k summed on the tensor core before a rounded add

// Offset of lane r of row k of the lane state.
__host__ __device__ constexpr int tc_at(int k, int r) {
  return k * TC_TB + (r ^ (((k & 3) ^ ((k >> 2) & 1)) << 3));
}

// x rounded to TF32 (ties away from zero, as cvt.rna does; written out
// because the instruction expands to twice as much for its special cases).
// The special cases: a finite x within 2^-12 of the largest float rounds up
// to inf, and for an inf or NaN x the tail x - big is NaN, so such a lane
// comes out as NaN where f32 arithmetic may give inf.  Non-finite stays
// non-finite and within its lane, which is all the solvers' checks read.
__device__ __forceinline__ uint32_t tf32_big(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// Raw operand words of 8 steps of k.  A for the warp's two m16 tiles:
// pa[4 mt + i] points at this thread's element of fragment register i in
// row 0 of the lane state (rows t and t + 4 of every 8 carry the same
// swizzle, so the eight pointers serve every group of 8 rows).  B for its
// four n8 tiles from the stage rows at Bs (this thread's (t, g) element).
__device__ __forceinline__ void tc_load(float (&fa)[8], float (&fb)[8],
                                        const float* const (&pa)[8], int row,
                                        const float* __restrict__ Bs) {
#pragma unroll
  for (int i = 0; i < 8; ++i) fa[i] = pa[i][row * TC_TB];
#pragma unroll
  for (int nt = 0; nt < 4; ++nt) {
    fb[nt * 2 + 0] = Bs[nt * 8];
    fb[nt * 2 + 1] = Bs[4 * TC_LDB + nt * 8];
  }
}

// acc[mt][nt][c] (the mma's own layout) = sum over k < K of
// A_s[k][lane] * tile(k)[column]; `Bt` points into stage 0 at this
// thread's (t, g) element of the warp's first n8 tile.
template <int KT>
__device__ __forceinline__ void product_tc(float (&acc)[2][4][4],
                                           const float* __restrict__ A_s, int K,
                                           const float* __restrict__ Bt, Ring& ring, int cl,
                                           int lane, int g, int t) {
  static_assert(KT % 16 == 0, "8-step groups alternate between two operand buffers");
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[mt][nt][c] = 0.f;

  // The tensor core adds into its accumulator by truncation, so a chain of
  // 3 K / 8 mma would drift by that many half-ulps.  The small terms have
  // their own chain (`small`; their error is 2^-11 of itself), the big
  // terms start from zero every TC_FLUSH steps of k (`big`) and are then
  // added to `acc` by a rounded f32 add.
  float small[2][4][4], big[2][4][4];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int c = 0; c < 4; ++c) small[mt][nt][c] = 0.f;

  float fa[2][8], fb[2][8];
  mbar_wait(ring.full(), ring.phase);
  const float* Bs = Bt + ring.stage * (KT * TC_LDB);
  const float* pa[8];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt) {
    pa[mt * 4 + 0] = A_s + tc_at(t, mt * 16 + g);
    pa[mt * 4 + 1] = A_s + tc_at(t, mt * 16 + g + 8);
    pa[mt * 4 + 2] = A_s + tc_at(t + 4, mt * 16 + g);
    pa[mt * 4 + 3] = A_s + tc_at(t + 4, mt * 16 + g + 8);
  }
  tc_load(fa[0], fb[0], pa, 0, Bs);

  for (int k0 = 0; k0 < K; k0 += KT) {
    const bool more = k0 + KT < K;
    int next_stage = ring.stage + 1;
    uint32_t next_phase = ring.phase;
    if (next_stage == ring.stages) {
      next_stage = 0;
      next_phase ^= 1;
    }
    const float* Bn = Bt + next_stage * (KT * TC_LDB);
    if (k0 % TC_FLUSH == 0) {
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int nt = 0; nt < 4; ++nt)
#pragma unroll
          for (int c = 0; c < 4; ++c) big[mt][nt][c] = 0.f;
    }
#pragma unroll
    for (int k8 = 0; k8 < KT / 8; ++k8) {
      const int cur = k8 & 1, nxt = cur ^ 1;
      if (k8 + 1 < KT / 8) {
        tc_load(fa[nxt], fb[nxt], pa, (k8 + 1) * 8, Bs + (k8 + 1) * 8 * TC_LDB);
      } else if (more) {
        mbar_wait(ring.bars + 8 * next_stage, next_phase);
        tc_load(fa[nxt], fb[nxt], pa, KT, Bn);
      }
      uint32_t abig[2][4], asmall[2][4], bbig[4][2], bsmall[4][2];
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const float x = fa[cur][i], y = fb[cur][i];
        abig[i / 4][i % 4] = tf32_big(x);
        asmall[i / 4][i % 4] = __float_as_uint(x - __uint_as_float(abig[i / 4][i % 4]));
        bbig[i / 2][i % 2] = tf32_big(y);
        bsmall[i / 2][i % 2] = __float_as_uint(y - __uint_as_float(bbig[i / 2][i % 2]));
      }
      // Eight independent accumulators per round, so that no mma waits for
      // the one before it.
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) mma_tf32(small[mt][nt], asmall[mt], bbig[nt]);
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) mma_tf32(big[mt][nt], abig[mt], bbig[nt]);
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) mma_tf32(small[mt][nt], abig[mt], bsmall[nt]);
    }
    if ((k0 + KT) % TC_FLUSH == 0 || !more) {
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int nt = 0; nt < 4; ++nt)
#pragma unroll
          for (int c = 0; c < 4; ++c) acc[mt][nt][c] += big[mt][nt][c];
    }
#pragma unroll
    for (int i = 0; i < 8; ++i) pa[i] += KT * TC_TB;
    __syncwarp();
    if (cl == 1) {
      if (lane == 0) mbar_arrive(ring.empty());
    } else if (lane < cl) {
      mbar_arrive_cluster(ring.empty(), (uint32_t)lane);
    }
    ring.advance();
    Bs = Bn;
  }
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[mt][nt][c] += small[mt][nt][c];
}

size_t smem_bytes_tc(int n, int r, int kt, int stages) {
  return sizeof(float) * ((size_t)stages * kt * TC_LDB +
                          (size_t)(round_up(n, kt) + round_up(r, kt)) * TC_TB + 2 * TC_TB) +
         (size_t)16 * stages;
}

template <int KT>
__global__ void __launch_bounds__(TC_THREADS, 1) fused_two_block_tc_kernel(
    const float* __restrict__ U, const float* __restrict__ Ut,
    const float* __restrict__ dinv, const float* __restrict__ acy,
    const float* __restrict__ mu, const float* __restrict__ thr,
    const float* __restrict__ x0, const float* __restrict__ x1,
    const float* __restrict__ h, float* __restrict__ x0o,
    float* __restrict__ x1o, float* __restrict__ ho, float* __restrict__ x0p,
    int B, int N, int R, int n_iters, int prox, int thin, int stages, int cl, int bulk) {
  constexpr int TB = TC_TB;
  extern __shared__ __align__(128) float smem[];
  const int Nk = round_up(N, KT), Rk = round_up(R, KT);
  float* ring_s = smem;
  float* v_s = ring_s + stages * (KT * TC_LDB);
  float* w_s = v_s + Nk * TB;
  float* mu_s = w_s + Rk * TB;
  float* thr_s = mu_s + TB;
  uint64_t* bars = reinterpret_cast<uint64_t*>(thr_s + TB);

  const int tid = threadIdx.x;
  const int b0 = blockIdx.x * TB;

  if (tid == 0) {
    for (int s = 0; s < stages; ++s) {
      mbar_init(smem_u32(bars + s), 1);
      mbar_init(smem_u32(bars + stages + s), TC_WARPS * cl);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  for (int idx = tid; idx < (Nk + Rk) * TB; idx += TC_THREADS) v_s[idx] = 0.f;
  for (int r = tid; r < TB; r += TC_THREADS) {
    const bool ok = b0 + r < B;
    mu_s[r] = ok ? mu[b0 + r] : 1.f;
    thr_s[r] = ok ? thr[b0 + r] : 0.f;
  }
  __syncthreads();
  for (int idx = tid; idx < TB * N; idx += TC_THREADS) {
    const int r = idx / N, n = idx % N;
    if (b0 + r >= B) continue;
    const size_t g = (size_t)(b0 + r) * N + n;
    const float hv = h[g], x1v = x1[g];
    ho[g] = hv;  // h lives in its output array, see below
    v_s[tc_at(n, r)] = acy[g] + hv + mu_s[r] * x1v;
    if (n_iters <= 1) x0p[g] = x0[g];
    if (n_iters == 0) {
      x0o[g] = x0[g];
      x1o[g] = x1v;
    }
  }
  if (cl > 1) cluster_sync(); else __syncthreads();

  Ring ring(smem_u32(bars), stages);

  // The two roles never meet again (each ends the kernel itself), which is
  // what lets the compiler give each its own register budget.
  if (tid >= TC_CONSUMERS) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;" ::"n"(TC_PRODUCER_REGS));
    const int lane = tid - TC_CONSUMERS;
    if (lane < 32) {
      const uint32_t rank = cl > 1 ? cluster_rank() : 0u;
      for (int it = 0; it < n_iters; ++it) {
        produce<KT, TC_LDB>(U, N, R, bulk, cl, rank, ring_s, ring, lane);
        produce<KT, TC_LDB>(Ut, R, N, bulk, cl, rank, ring_s, ring, lane);
      }
    }
    if (cl > 1) cluster_sync();
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;" ::"n"(TC_CONSUMER_REGS));
    const int warp = tid / 32, lane = tid % 32;
    const int g = lane >> 2, t = lane & 3;
    const int col0 = warp * 32;  // the warp's first column within a pass
    // This thread's elements of a pass: lanes g + 8 li (li < 4), columns
    // col0 + 8 nt + 2 t + (c & 1); acc[mt][nt][c] is lane li = 2 mt + c / 2.
    const float* Bt = ring_s + t * TC_LDB + col0 + g;
    const bool nonneg = prox & 2;
    const bool even = prox & 1;
    float m[4], rm[4], th[4];
#pragma unroll
    for (int li = 0; li < 4; ++li) {
      m[li] = mu_s[g + 8 * li];
      rm[li] = 1.f / m[li];
      th[li] = thr_s[g + 8 * li];
    }

    for (int it = 0; it < n_iters; ++it) {
      const bool last = it == n_iters - 1;
      const bool before_last = it == n_iters - 2;

      // w = (v U) * dinv
      for (int c0 = 0; c0 < R; c0 += CW) {
        float pre[4][8];  // dinv, fetched from L2 while the product runs
#pragma unroll
        for (int li = 0; li < 4; ++li)
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            const int c = c0 + col0 + 8 * (j / 2) + 2 * t + (j & 1);
            const int b = b0 + g + 8 * li;
            pre[li][j] = (b < B && c < R) ? __ldg(dinv + (size_t)b * R + c) : 0.f;
          }
        float acc[2][4][4];
        product_tc<KT>(acc, v_s, N, Bt, ring, cl, lane, g, t);
#pragma unroll
        for (int mt = 0; mt < 2; ++mt)
#pragma unroll
          for (int nt = 0; nt < 4; ++nt)
#pragma unroll
            for (int c = 0; c < 4; ++c) {
              const int li = 2 * mt + c / 2, j = 2 * nt + (c & 1);
              const int col = c0 + col0 + 8 * nt + 2 * t + (c & 1);
              if (col < R) w_s[tc_at(col, g + 8 * li)] = acc[mt][nt][c] * pre[li][j];
            }
      }
      consumer_sync<TC_CONSUMERS>();

      // x0 = w Ut (+ v/mu), prox, dual ascent, and the next iteration's v.
      // h is not kept in shared memory, which goes to a third k-tile in the
      // ring instead: an element's owner reads it from `ho` (through L2)
      // and writes it back there, once per iteration.
      for (int c0 = 0; c0 < N; c0 += CW) {
        float pre[4][8];  // acy
#pragma unroll
        for (int li = 0; li < 4; ++li)
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            const int n = c0 + col0 + 8 * (j / 2) + 2 * t + (j & 1);
            const int b = b0 + g + 8 * li;
            pre[li][j] = (b < B && n < N) ? __ldg(acy + (size_t)b * N + n) : 0.f;
          }
        float acc[2][4][4];
        product_tc<KT>(acc, w_s, R, Bt, ring, cl, lane, g, t);
        // One m16 tile (16 elements) at a time: loads, the arithmetic as
        // one straight line, then the stores.
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) {
          float hv[4][4], vv[4][4], x0r[4][4], x1r[4][4];
#pragma unroll
          for (int nt = 0; nt < 4; ++nt)
#pragma unroll
            for (int c = 0; c < 4; ++c) {
              const int n = c0 + col0 + 8 * nt + 2 * t + (c & 1);
              const int b = b0 + g + 8 * (2 * mt + c / 2);
              hv[nt][c] = n < N && b < B ? __ldcg(ho + (size_t)b * N + n) : 0.f;
              vv[nt][c] = thin && n < N ? v_s[tc_at(n, g + 8 * (2 * mt + c / 2))] : 0.f;
            }
#pragma unroll
          for (int nt = 0; nt < 4; ++nt)
#pragma unroll
            for (int c = 0; c < 4; ++c) {
              const int li = 2 * mt + c / 2;
              const int n = c0 + col0 + 8 * nt + 2 * t + (c & 1);
              x0r[nt][c] = acc[mt][nt][c];
              update(x0r[nt][c], x1r[nt][c], hv[nt][c], vv[nt][c], m[li], rm[li], th[li],
                     pre[li][2 * nt + (c & 1)], thin, nonneg, even && (n & 1));
            }
#pragma unroll
          for (int nt = 0; nt < 4; ++nt)
#pragma unroll
            for (int c = 0; c < 4; ++c) {
              const int n = c0 + col0 + 8 * nt + 2 * t + (c & 1);
              const int b = b0 + g + 8 * (2 * mt + c / 2);
              if (n < N) {
                v_s[tc_at(n, g + 8 * (2 * mt + c / 2))] = vv[nt][c];
                if (b < B) __stcg(ho + (size_t)b * N + n, hv[nt][c]);
              }
            }
          if (last || before_last) {
#pragma unroll
            for (int nt = 0; nt < 4; ++nt)
#pragma unroll
              for (int c = 0; c < 4; ++c) {
                const int n = c0 + col0 + 8 * nt + 2 * t + (c & 1);
                const int b = b0 + g + 8 * (2 * mt + c / 2);
                if (b >= B || n >= N) continue;
                const size_t gi = (size_t)b * N + n;
                if (last) {
                  x0o[gi] = x0r[nt][c];
                  x1o[gi] = x1r[nt][c];
                } else {
                  x0p[gi] = x0r[nt][c];
                }
              }
          }
        }
      }
      consumer_sync<TC_CONSUMERS>();
    }
    if (cl > 1) cluster_sync();
  }
}

// ---------------------------------------------------------------------
// The thin-basis kernel (R <= 128) on wgmma, with the basis streamed by
// TMA.  Both products have the shared basis on the 64-row side of
// `wgmma.m64n32k8` (TF32) and the block's 32 lanes on its N = 32 side:
//
//     product 1, (v U)ᵀ = Ut · vᵀ:  M = R (one or two 64-row tiles), K = N
//     product 2, x0ᵀ = U · wᵀ:      M = N (64-row tiles), K = R
//
// so no warp idles because R is small (R = 100 computes 128 rows, 22%
// padding).  A block is two consumer warpgroups and a producer warpgroup
// (its first two warps load, one ring each; setmaxnreg gives the consumers
// 240 registers).  Warpgroup g takes the 64-row tiles m = g, g + 2, ... of
// product 2 in ascending order, the same in every block, so that product
// 1's partial sums are added in one order and a lane's bits do not depend
// on its place in the batch (starting each block at another tile, to
// spread the blocks' copies over L2, measured no faster); each tile's
// epilogue (prox, dual ascent, the next v) writes the tile's 64 columns of
// v, and the same warpgroup then runs product 1's share of the next
// iteration over those 64 steps of k, into a partial (vU)ᵀ that the two
// warpgroups add at the iteration's end (w = (vU)·dinv).  So v is read by
// product 1 as it is produced, and the tiles of U and Ut alternate in one
// ring per warpgroup.  The two warpgroups take turns at their epilogues,
// so that one's arithmetic runs beside the other's products.
//
// Split TF32 (three products, f32 sums): the basis tile (the A operand) is
// loaded from shared memory into registers and split there into head
// (rounded to TF32) and tail, so U and Ut are streamed once, as they are.
// The lanes' operand (B, from shared memory) is v itself, which the tensor
// core cuts to TF32 by truncation, beside its tail v - trunc(v) rounded to
// TF32, which the epilogue writes into a two-atom slice that product 1
// reads right after; likewise w and its tail.  A product is then
// A_hi·B + A_hi·B_lo + A_lo·B.  The head·head chain restarts every 32 steps
// of k (an atom, a 128-byte row of fp32) and is added to the f32 sum by a
// rounded add; the tails' chain runs through the product and is added
// last, as in the kernel above.  Every A operand of an atom is made ready
// before its products are issued: left to itself the compiler computes one
// between two products in a register a product still reads, and then has
// every product wait for the one before it (3x slower).
//
// Shared memory (a 1024-byte aligned base): v, 32 lanes by N rounded up to
// 64, in 128-byte-swizzled atoms of 32 k (the wgmma B layout: lane rows
// 128 bytes apart, 16-byte chunks XOR-ed with the lane); w and its tail
// (R rounded up to 32); each warpgroup's tail slice (two atoms), which also
// takes the accumulator tile on its way into the epilogue and the partial
// (vU)ᵀ on its way to the other warpgroup; and one ring of `stages` 8 KB
// stages per warpgroup, each a 64-row, 32-column tile of U or Ut as TMA
// lays it out with 128-byte swizzle.  h stays in its output array (through
// L2), as in the kernel above; the epilogue reads and writes it, acy and
// the outputs as float4 runs of one lane, h and acy a tile ahead.
// ---------------------------------------------------------------------

constexpr int WG_TB = 32;
constexpr int WG_CONSUMERS = 256;            // two consumer warpgroups
constexpr int WG_THREADS = WG_CONSUMERS + 128;  // and a producer warpgroup (one warp loads)
constexpr int WG_PRODUCER_REGS = 24, WG_CONSUMER_REGS = 240;
constexpr int WG_ATOM = WG_TB * 32;          // floats of a lane-operand atom: 32 lanes x 32 k
constexpr int WG_TILE = 64 * 32;             // floats of a ring stage: 64 rows x 32 k
constexpr int WG_MAX_R = 128;

size_t smem_bytes_wg(int n, int r, int stages) {
  const size_t atoms = 2 * (size_t)((n + 63) / 64) + 2 * (size_t)((r + 31) / 32) + 4;
  return 1024 + sizeof(float) * (atoms * WG_ATOM + 2 * (size_t)stages * WG_TILE + 3 * WG_TB) +
         (size_t)32 * stages;
}

// Offset in floats of (row, k) in a 128-byte-swizzled tile of 32-float rows.
__host__ __device__ constexpr int sw128(int row, int k) {
  return row * 32 + ((((k >> 2) ^ row) & 7) << 2) + (k & 3);
}

// Lane `b`, step `k` of a lane operand held in atoms of 32 k.
__host__ __device__ constexpr int wg_at(int b, int k) { return (k >> 5) * WG_ATOM + sw128(b, k & 31); }

// v - trunc(v), rounded to TF32: the tail the tensor core adds to v cut to TF32.
__device__ __forceinline__ float tf32_tail(float x) {
  const float head = __uint_as_float(__float_as_uint(x) & 0xffffe000u);
  return __uint_as_float(tf32_big(x - head));
}

// wgmma descriptor of a K-major operand at `p` in the 128-byte-swizzled
// layout: 8-row groups 1024 bytes apart (leading offset unused, 1).
__device__ __forceinline__ uint64_t wg_desc(const float* p) {
  return (uint64_t)((smem_u32(p) & 0x3FFFFu) >> 4) | (1ull << 16) | (64ull << 32) | (1ull << 62);
}

__device__ __forceinline__ void wg_fence() { asm volatile("wgmma.fence.sync.aligned;" ::: "memory"); }
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wg_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
}
// Pins the order of register reads and writes against the asynchronous wgmma.
__device__ __forceinline__ void wg_pin(float (&d)[16]) {
#pragma unroll
  for (int i = 0; i < 16; ++i) asm volatile("" : "+f"(d[i])::"memory");
}


// d = a·B (ACC = 0) or d += a·B, a 64 x 8 TF32 from registers, B 8 x 32 at `desc`.
template <int ACC>
__device__ __forceinline__ void wgmma_tf32(float (&d)[16], const uint32_t (&a)[4], uint64_t desc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "{%16, %17, %18, %19}, %20, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),
        "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(ACC));
}

__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map, int x, int y,
                                         uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3}], [%4];"
      ::"r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(x), "r"(y), "r"(bar)
      : "memory");
}

// mbar_wait that traps after ~2^34 clocks (seconds): a pipeline that can
// never complete fails its launch instead of holding the card.
__device__ __forceinline__ void wg_mbar_wait(uint32_t bar, uint32_t parity) {
  long long t0 = 0;
  for (;;) {
    uint32_t done;
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (done) return;
    if (t0 == 0) t0 = clock64();
    else if (clock64() - t0 > (1ll << 34)) __trap();
  }
}

__device__ __forceinline__ void fence_async_shared() {
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}

template <int ID, int COUNT>
__device__ __forceinline__ void named_sync() {
  asm volatile("bar.sync %0, %1;" ::"n"(ID), "n"(COUNT) : "memory");
}

// A warpgroup's tiles m = wg, wg + 2, ... of product 2, in the order it
// takes them (ascending, in every block): T of them, k = T being the first
// again (the next iteration's, whose h and acy are fetched a tile ahead).
struct WgOrder {
  int wg, T;
  __device__ WgOrder(int wg_, int MT) : wg(wg_), T((MT - wg_ + 1) / 2) {}
  __device__ __forceinline__ int tile(int k) const { return wg + 2 * (k % T); }
};

// Producer warp of a ring: the ring's next tile (at column x, row y of Ut
// or U) into its next stage once the consumers are done with it.  With
// bulk copies one TMA copy by lane 0 (128-byte swizzle, zeros past the
// edges); otherwise the warp loads the tile into the same layout.
__device__ __forceinline__ void wg_put(const CUtensorMap* map, const float* __restrict__ src,
                                       int rows, int cols, int x, int y, bool bulk,
                                       float* ring_s, Ring& ring, int lane) {
  wg_mbar_wait(ring.empty(), ring.phase ^ 1);
  float* dst = ring_s + ring.stage * WG_TILE;
  if (bulk) {
    if (lane == 0) {
      mbar_arrive_expect_tx(ring.full(), (uint32_t)(WG_TILE * 4));
      tma_load(smem_u32(dst), map, x, y, ring.full());
    }
  } else {
#pragma unroll 4
    for (int row = 0; row < 64; ++row) {
      const int r = y + row;
      dst[sw128(row, lane)] =
          (r < rows && x + lane < cols) ? __ldg(src + (size_t)r * cols + x + lane) : 0.f;
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(ring.full());
  }
  ring.advance();
}

// Consumer warpgroup: one atom (NS <= 4 steps of 8 k) of the tile in the
// ring's next stage times the lane operand B (v or w, cut to TF32 by the
// tensor core) at `bhi` and its tail at `blo`.  This thread loads its
// fragments of the tile (rows 16 warp + g and + 8, columns t and t + 4 of
// each step; `arow` = its offset of row 16 warp + g, column t) and splits
// them into head (rounded to TF32) and tail, the last two steps' while the
// first two steps' products run; each warp hands the stage back once its
// products are issued.  The chain A_hi·B starts at the atom and is added to
// `acc` by rounded f32 adds; A_hi·B_lo + A_lo·B goes on in `small` (started
// where FIRST).  Every operand is made ready before its products are
// issued: left to itself the compiler computes one between two products,
// in a register a product still reads, and then has every product wait for
// the one before it (3x slower).
template <int NS, int FIRST>
__device__ __forceinline__ void wg_atom(float (&acc)[16], float (&small)[16],
                                        const float* __restrict__ ring_s, Ring& ring, int arow,
                                        int g, uint64_t bhi, uint64_t blo, int lane) {
  constexpr int H = NS < 2 ? NS : 2;
  wg_mbar_wait(ring.full(), ring.phase);
  const float* A = ring_s + ring.stage * WG_TILE;
  uint32_t hi[NS][4], lo[NS][4];
  float big[16];
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int s0 = half ? H : 0, s1 = half ? NS : H;
    if (s0 == s1) break;
    float x[NS][4];
#pragma unroll
    for (int s = s0; s < s1; ++s) {
      const int c0 = ((2 * s) ^ g) << 2, c1 = ((2 * s + 1) ^ g) << 2;
      x[s][0] = A[arow + c0];
      x[s][1] = A[arow + 256 + c0];
      x[s][2] = A[arow + c1];
      x[s][3] = A[arow + 256 + c1];
    }
#pragma unroll
    for (int s = s0; s < s1; ++s)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        hi[s][i] = tf32_big(x[s][i]);
        lo[s][i] = __float_as_uint(x[s][i] - __uint_as_float(hi[s][i]));
        asm volatile("" : "+r"(hi[s][i]), "+r"(lo[s][i])::"memory");
      }
    if (half == 0) wg_pin(small);
    wg_fence();
#pragma unroll
    for (int s = s0; s < s1; ++s) {
      if (s == 0) {
        wgmma_tf32<0>(big, hi[0], bhi);
        wgmma_tf32<1 - FIRST>(small, hi[0], blo);
      } else {
        wgmma_tf32<1>(big, hi[s], bhi + 2 * s);
        wgmma_tf32<1>(small, hi[s], blo + 2 * s);
      }
      wgmma_tf32<1>(small, lo[s], bhi + 2 * s);
    }
    wg_commit();
  }
  __syncwarp();
  if (lane == 0) mbar_arrive(ring.empty());
  ring.advance();
  wg_wait_all();
  wg_pin(big);
  wg_pin(small);
#pragma unroll
  for (int i = 0; i < 16; ++i) acc[i] += big[i];
}

// An atom of `ns` steps (1..4).
template <int FIRST>
__device__ __forceinline__ void wg_atom_n(int ns, float (&acc)[16], float (&small)[16],
                                          const float* ring_s, Ring& ring, int arow, int g,
                                          uint64_t bhi, uint64_t blo, int lane) {
  if (ns >= 4) wg_atom<4, FIRST>(acc, small, ring_s, ring, arow, g, bhi, blo, lane);
  else if (ns == 3) wg_atom<3, FIRST>(acc, small, ring_s, ring, arow, g, bhi, blo, lane);
  else if (ns == 2) wg_atom<2, FIRST>(acc, small, ring_s, ring, arow, g, bhi, blo, lane);
  else wg_atom<1, FIRST>(acc, small, ring_s, ring, arow, g, bhi, blo, lane);
}

// The atoms a < na of one accumulator tile's sum over K (the lane operand
// of atom a at `desc(a, bhi, blo)`), the tail chain added last.
template <class Desc>
__device__ __forceinline__ void wg_sum(float (&acc)[16], int na, int K, const float* ring_s,
                                       Ring& ring, int arow, int g, int lane, Desc desc) {
  float small[16];
  for (int a = 0; a < na; ++a) {
    uint64_t bhi, blo;
    desc(a, bhi, blo);
    const int ns = min(4, (K - 32 * a + 7) / 8);
    if (a == 0) wg_atom_n<1>(ns, acc, small, ring_s, ring, arow, g, bhi, blo, lane);
    else wg_atom_n<0>(ns, acc, small, ring_s, ring, arow, g, bhi, blo, lane);
  }
#pragma unroll
  for (int i = 0; i < 16; ++i) acc[i] += small[i];
}

// Product 1's share of tile m's 64 columns of v (written just before, its
// tail in `lo`): p1[rt] += Ut[64 rt.., 64 m..] · v[.., 64 m..]ᵀ.
__device__ __forceinline__ void wg_product1(float (&p1)[2][16], int m, int N, int RT,
                                            const float* v_s, const float* lo,
                                            const float* ring_s, Ring& ring, int arow, int g,
                                            int lane) {
  const int nk = min(2, (N - 64 * m + 31) / 32);
  auto desc = [&](int j, uint64_t& bhi, uint64_t& blo) {
    bhi = wg_desc(v_s + (2 * m + j) * WG_ATOM);
    blo = wg_desc(lo + j * WG_ATOM);
  };
  wg_sum(p1[0], nk, N - 64 * m, ring_s, ring, arow, g, lane, desc);
  if (RT > 1) wg_sum(p1[1], nk, N - 64 * m, ring_s, ring, arow, g, lane, desc);
}

// h and acy of tile m's elements of this thread, lane `L` and the four
// columns 64 m + 4 q + 16 i + (0..3) for i < 4, from L2: as float4 where
// `vec` (rows 16-byte aligned), else one by one.
__device__ __forceinline__ void wg_fetch(float4 (&hv)[4], float4 (&av)[4], const float* ho,
                                         const float* __restrict__ acy, int m, int q, int b,
                                         int B, int N, bool vec) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int n = 64 * m + 4 * q + 16 * i;
    const size_t gi = (size_t)b * N + n;
    if (b < B && n < N && vec) {
      hv[i] = __ldcs(reinterpret_cast<const float4*>(ho + gi));
      av[i] = __ldcs(reinterpret_cast<const float4*>(acy + gi));
    } else {
      float h4[4], a4[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const bool ok = b < B && n + j < N;
        h4[j] = ok ? __ldcg(ho + gi + j) : 0.f;
        a4[j] = ok ? __ldg(acy + gi + j) : 0.f;
      }
      hv[i] = make_float4(h4[0], h4[1], h4[2], h4[3]);
      av[i] = make_float4(a4[0], a4[1], a4[2], a4[3]);
    }
  }
}

// Stores four consecutive columns from n of row `p` (n and the row start
// 16-byte aligned where `vec`), none at or past `N`.
__device__ __forceinline__ void wg_store4(float* p, int n, int N, bool vec, const float (&x)[4],
                                          bool cg) {
  if (vec && n + 3 < N) {
    const float4 v = make_float4(x[0], x[1], x[2], x[3]);
    if (cg) __stcg(reinterpret_cast<float4*>(p + n), v);
    else *reinterpret_cast<float4*>(p + n) = v;
  } else {
#pragma unroll
    for (int j = 0; j < 4; ++j)
      if (n + j < N) {
        if (cg) __stcg(p + n + j, x[j]);
        else p[n + j] = x[j];
      }
  }
}

// w = (p1 of both warpgroups) * dinv (this thread's elements of it in
// `dv`), and its tail.  Warpgroup wg finishes
// the row tile rt = wg with the other's partial, passed through the tail
// slices (free here: every product is done).
__device__ __forceinline__ void wg_finish_w(float (&p1)[2][16], float* w_s, float* wlo_s,
                                            float* lo_s, const float (&dv)[16], int wg, int wl,
                                            int row0, int lane0, int R, int RA, int RT) {
  const int other = 1 - wg;
  if (other < RT) {
    float* mine = lo_s + 2 * wg * WG_ATOM;
#pragma unroll
    for (int e = 0; e < 16; ++e) mine[e * 128 + wl] = other == 0 ? p1[0][e] : p1[1][e];
  }
  named_sync<3, WG_CONSUMERS>();
  if (wg < RT) {
    const float* theirs = lo_s + 2 * other * WG_ATOM;
#pragma unroll
    for (int e = 0; e < 16; ++e) {
      const int r = 64 * wg + row0 + 8 * ((e >> 1) & 1), ln = lane0 + 8 * (e >> 2) + (e & 1);
      const float sum = (wg == 0 ? p1[0][e] : p1[1][e]) + theirs[e * 128 + wl];
      const float wv = r < R ? sum * dv[e] : 0.f;
      if (r < RA * 32) {
        w_s[wg_at(ln, r)] = wv;
        wlo_s[wg_at(ln, r)] = tf32_tail(wv);
      }
    }
  }
  fence_async_shared();
  named_sync<3, WG_CONSUMERS>();
#pragma unroll
  for (int rt = 0; rt < 2; ++rt)
#pragma unroll
    for (int e = 0; e < 16; ++e) p1[rt][e] = 0.f;
}

template <int WG>
__device__ __forceinline__ void wg_sync() {
  named_sync<1 + WG, 128>();
}

// The epilogue turn: warpgroup WG waits for it on barrier 4 + WG, which the
// other warpgroup arrives at once its own epilogue is done.
template <int WG>
__device__ __forceinline__ void wg_turn_wait() {
  asm volatile("bar.sync %0, %1;" ::"n"(4 + WG), "n"(WG_CONSUMERS) : "memory");
}

template <int WG>
__device__ __forceinline__ void wg_turn_pass() {
  asm volatile("bar.arrive %0, %1;" ::"n"(5 - WG), "n"(WG_CONSUMERS) : "memory");
}

// prox: bit 1 set = nonneg (else soft-threshold), bit 0 set = `_even` mode.
__global__ void __launch_bounds__(WG_THREADS, 1) fused_two_block_wgmma_kernel(
    const __grid_constant__ CUtensorMap tmU, const __grid_constant__ CUtensorMap tmUt,
    const float* __restrict__ U, const float* __restrict__ Ut,
    const float* __restrict__ dinv, const float* __restrict__ acy,
    const float* __restrict__ mu, const float* __restrict__ thr,
    const float* __restrict__ x0, const float* __restrict__ x1,
    const float* __restrict__ h, float* __restrict__ x0o,
    float* __restrict__ x1o, float* __restrict__ ho, float* __restrict__ x0p,
    int B, int N, int R, int n_iters, int prox, int thin, int stages, int bulk, int vec) {
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  float* base = reinterpret_cast<float*>(smem_raw + ((1024u - (smem_u32(smem_raw) & 1023u)) & 1023u));
  const int MT = (N + 63) / 64;    // 64-row tiles of product 2
  const int RA = (R + 31) / 32;    // atoms of w
  const int RT = (R + 63) / 64;    // 64-row tiles of product 1
  float* v_s = base;
  float* w_s = v_s + 2 * MT * WG_ATOM;
  float* wlo_s = w_s + RA * WG_ATOM;
  float* lo_s = wlo_s + RA * WG_ATOM;          // two atoms per warpgroup
  float* ring_s = lo_s + 4 * WG_ATOM;          // `stages` stages per warpgroup
  float* mu_s = ring_s + 2 * stages * WG_TILE;
  float* rmu_s = mu_s + WG_TB;
  float* thr_s = rmu_s + WG_TB;
  uint64_t* bars = reinterpret_cast<uint64_t*>(thr_s + WG_TB);  // per ring: full, empty

  const int tid = threadIdx.x;
  const int b0 = blockIdx.x * WG_TB;

  if (tid == 0) {
    for (int s = 0; s < 2 * stages; ++s) {
      mbar_init(smem_u32(bars + s + (s / stages) * stages), 1);             // full
      mbar_init(smem_u32(bars + s + (s / stages + 1) * stages), 4);         // empty
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  if (bulk && tid % 128 == 0) {
    asm volatile("prefetch.tensormap [%0];" ::"l"(reinterpret_cast<uint64_t>(&tmU)) : "memory");
    asm volatile("prefetch.tensormap [%0];" ::"l"(reinterpret_cast<uint64_t>(&tmUt)) : "memory");
  }
  for (int idx = tid; idx < (2 * MT + 2 * RA + 4) * WG_ATOM; idx += WG_THREADS) v_s[idx] = 0.f;
  for (int r = tid; r < WG_TB; r += WG_THREADS) {
    const bool ok = b0 + r < B;
    mu_s[r] = ok ? mu[b0 + r] : 1.f;
    rmu_s[r] = 1.f / mu_s[r];
    thr_s[r] = ok ? thr[b0 + r] : 0.f;
  }
  __syncthreads();
  for (int idx = tid; idx < WG_TB * N; idx += WG_THREADS) {
    const int r = idx / N, n = idx % N;
    if (b0 + r >= B) continue;
    const size_t gi = (size_t)(b0 + r) * N + n;
    const float hv = h[gi], x1v = x1[gi];
    ho[gi] = hv;  // h lives in its output array
    v_s[wg_at(r, n)] = acy[gi] + hv + mu_s[r] * x1v;
    if (n_iters <= 1) x0p[gi] = x0[gi];
    if (n_iters == 0) {
      x0o[gi] = x0[gi];
      x1o[gi] = x1v;
    }
  }
  fence_async_shared();
  __syncthreads();
  if (n_iters == 0) return;

  // The two roles never meet again (each ends the kernel itself), which is
  // what lets the compiler give each its own register budget.
  if (tid >= WG_CONSUMERS) {
    // ---- producer: warp 0 fills ring 0, warp 1 ring 1 ----
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;" ::"n"(WG_PRODUCER_REGS));
    const int pw = (tid - WG_CONSUMERS) / 32, lane = tid % 32;
    if (pw < 2) {
      // The tiles in the order the warpgroup's atoms use them: product 1 of
      // its tiles (it = -1), then per iteration and tile product 2's atoms
      // of U and, but in the last iteration, product 1's of Ut.
      Ring ring(smem_u32(bars + 2 * stages * pw), stages);
      float* rs = ring_s + pw * stages * WG_TILE;
      const WgOrder order(pw, MT);
      for (int it = -1; it < n_iters; ++it) {
        for (int k = 0; k < order.T; ++k) {
          const int m = order.tile(k);
          if (it >= 0)
            for (int a = 0; a < RA; ++a)
              wg_put(&tmU, U, N, R, 32 * a, 64 * m, bulk, rs, ring, lane);
          if (it < n_iters - 1) {
            const int nk = min(2, (N - 64 * m + 31) / 32);
            for (int rt = 0; rt < RT; ++rt)
              for (int j = 0; j < nk; ++j)
                wg_put(&tmUt, Ut, R, N, 32 * (2 * m + j), 64 * rt, bulk, rs, ring, lane);
          }
        }
      }
    }
    return;
  }
  // ---- consumer warpgroups ----
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;" ::"n"(WG_CONSUMER_REGS));
  const int wg = tid / 128, wl = tid % 128, wq = wl / 32, lane = tid % 32;
  const int g = lane >> 2, t = lane & 3;
  const int arow = (16 * wq + g) * 32 + t;
  // This thread's elements of a 64 x 32 accumulator tile: element e is
  // row row0 + 8 ((e >> 1) & 1) of the tile (the basis side), lane
  // lane0 + 8 (e >> 2) + (e & 1).
  const int row0 = 16 * wq + g, lane0 = 2 * t;
  const bool nonneg = prox & 2;
  const bool even = prox & 1;
  Ring ring(smem_u32(bars + 2 * stages * wg), stages);
  const float* rs = ring_s + wg * stages * WG_TILE;
  float* my_lo = lo_s + 2 * wg * WG_ATOM;

  // The epilogues take the accumulator tile through the tail slices: thread
  // wl handles lane L = wl / 4 at columns 4 q + 16 i (q = wl % 4, i < 4).
  const int L = wl >> 2, q = wl & 3, bL = b0 + L;
  const float muL = mu_s[L], rmuL = rmu_s[L], thrL = thr_s[L];

  // dinv at this thread's elements of the row tile rt = wg of w
  float dv[16];
#pragma unroll
  for (int e = 0; e < 16; ++e) {
    const int r = 64 * wg + row0 + 8 * ((e >> 1) & 1), b = b0 + lane0 + 8 * (e >> 2) + (e & 1);
    dv[e] = (wg < RT && r < R && b < B) ? __ldg(dinv + (size_t)b * R + r) : 0.f;
  }
  float p1[2][16];
  float4 hv[4], av[4];
#pragma unroll
  for (int rt = 0; rt < 2; ++rt)
#pragma unroll
    for (int e = 0; e < 16; ++e) p1[rt][e] = 0.f;

  const WgOrder order(wg, MT);
  // The two warpgroups take turns at their epilogues, so that one's
  // arithmetic runs beside the other's products (where they have as many
  // tiles; warpgroup 0 goes first).
  const bool turns = MT % 2 == 0;
  if (turns && wg == 1) wg_turn_pass<1>();
  if (order.T > 0) {
    // h and acy run a tile ahead of the epilogues that use them.
    wg_fetch(hv, av, ho, acy, order.tile(0), q, bL, B, N, vec);
    // Product 1 of the first iteration, from the v loaded above.
    for (int k = 0; k < order.T; ++k) {
      const int m = order.tile(k);
#pragma unroll
      for (int e = 0; e < 16; ++e) {
        const int c = row0 + 8 * ((e >> 1) & 1), ln = lane0 + 8 * (e >> 2) + (e & 1);
        my_lo[wg_at(ln, c)] = tf32_tail(v_s[wg_at(ln, 64 * m + c)]);
      }
      fence_async_shared();
      if (wg == 0) wg_sync<0>(); else wg_sync<1>();
      wg_product1(p1, m, N, RT, v_s, my_lo, rs, ring, arow, g, lane);
    }
  }
  wg_finish_w(p1, w_s, wlo_s, lo_s, dv, wg, wl, row0, lane0, R, RA, RT);

  for (int it = 0; it < n_iters; ++it) {
    const bool last = it == n_iters - 1;
    const bool before_last = it == n_iters - 2;
    for (int k = 0; k < order.T; ++k) {
      const int m = order.tile(k);
      float acc[16];
#pragma unroll
      for (int e = 0; e < 16; ++e) acc[e] = 0.f;
      wg_sum(acc, RA, R, rs, ring, arow, g, lane, [&](int a, uint64_t& bhi, uint64_t& blo) {
        bhi = wg_desc(w_s + a * WG_ATOM);
        blo = wg_desc(wlo_s + a * WG_ATOM);
      });
      // The tile (x0 = w Ut before the thin term) into the tail slices, in
      // the lane operand's layout (the tail of v takes each element's place
      // below), then per thread four runs of four columns of one lane.
      if (turns) {
        if (wg == 0) wg_turn_wait<0>(); else wg_turn_wait<1>();
      }
#pragma unroll
      for (int e = 0; e < 16; ++e)
        my_lo[wg_at(lane0 + 8 * (e >> 2) + (e & 1), row0 + 8 * ((e >> 1) & 1))] = acc[e];
      if (wg == 0) wg_sync<0>(); else wg_sync<1>();
      // x0 (+ v/mu), prox, dual ascent, the next v and its tail.
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int c = 4 * q + 16 * i, n = 64 * m + c;
        float4* xp = reinterpret_cast<float4*>(my_lo + wg_at(L, c));
        float4* vp = reinterpret_cast<float4*>(v_s + wg_at(L, n));
        const float4 x4 = *xp;
        const float4 v4 = thin ? *vp : make_float4(0.f, 0.f, 0.f, 0.f);
        float x0n[4] = {x4.x, x4.y, x4.z, x4.w}, vv[4] = {v4.x, v4.y, v4.z, v4.w};
        float hh[4] = {hv[i].x, hv[i].y, hv[i].z, hv[i].w};
        const float aa[4] = {av[i].x, av[i].y, av[i].z, av[i].w};
        float x1n[4], tail[4];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          update(x0n[j], x1n[j], hh[j], vv[j], muL, rmuL, thrL, aa[j], thin, nonneg,
                 even && ((n + j) & 1));
          if (n + j >= N) vv[j] = 0.f;
          tail[j] = tf32_tail(vv[j]);
        }
        *vp = make_float4(vv[0], vv[1], vv[2], vv[3]);
        *xp = make_float4(tail[0], tail[1], tail[2], tail[3]);
        if (bL < B && n < N) {
          const size_t row = (size_t)bL * N;
          wg_store4(ho + row, n, N, vec, hh, true);
          if (last) {
            wg_store4(x0o + row, n, N, vec, x0n, false);
            wg_store4(x1o + row, n, N, vec, x1n, false);
          } else if (before_last) {
            wg_store4(x0p + row, n, N, vec, x0n, false);
          }
        }
      }
      if (turns && !(wg == 1 && last && k + 1 == order.T)) {
        if (wg == 0) wg_turn_pass<0>(); else wg_turn_pass<1>();
      }
      // the warpgroup's next tile, in this iteration or the next
      if (k + 1 < order.T || !last) wg_fetch(hv, av, ho, acy, order.tile(k + 1), q, bL, B, N, vec);
      if (!last) {
        fence_async_shared();
        if (wg == 0) wg_sync<0>(); else wg_sync<1>();
        wg_product1(p1, m, N, RT, v_s, my_lo, rs, ring, arow, g, lane);
      }
    }
    if (!last) wg_finish_w(p1, w_s, wlo_s, lo_s, dv, wg, wl, row0, lane0, R, RA, RT);
  }
}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15u) == 0; }

typedef void (*ChunkKernel)(const float*, const float*, const float*, const float*,
                            const float*, const float*, const float*, const float*,
                            const float*, float*, float*, float*, float*, int, int, int, int,
                            int, int, int, int, int);

struct ChunkArgs {
  const float *U, *Ut, *dinv, *acy, *mu, *thr, *x0, *x1, *h;
  float *x0o, *x1o, *ho, *x0p;
  int B, N, R, n_iters, prox, thin;
};

int launch(ChunkKernel kernel, int threads, int tb, size_t smem, const ChunkArgs& a,
           int stages, int cl, cudaStream_t stream) {
  const int bulk = a.N % 4 == 0 && a.R % 4 == 0 && aligned16(a.U) && aligned16(a.Ut);
  if (stages < 2 || stages > 16 || cl < 1 || cl > 8 || (cl > 1 && !bulk))
    return cudaErrorInvalidValue;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(round_up((a.B + tb - 1) / tb, cl));
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cl;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kernel, a.U, a.Ut, a.dinv, a.acy, a.mu, a.thr, a.x0, a.x1, a.h,
                           a.x0o, a.x1o, a.ho, a.x0p, a.B, a.N, a.R, a.n_iters, a.prox, a.thin,
                           stages, cl, bulk);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

PFN_cuTensorMapEncodeTiled_v12000 tensor_map_encoder() {
  static PFN_cuTensorMapEncodeTiled_v12000 fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found) ==
            cudaSuccess &&
        found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<PFN_cuTensorMapEncodeTiled_v12000>(p);
  }
  return fn;
}

// A TMA map of the row-major (rows, cols) float matrix at `p`, read in
// boxes of 32 columns by `box_rows` rows with 128-byte swizzle; false where
// none can be made.
bool tensor_map(CUtensorMap* map, const float* p, int rows, int cols, int box_rows) {
  const PFN_cuTensorMapEncodeTiled_v12000 encode = tensor_map_encoder();
  if (encode == nullptr) return false;
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)cols * sizeof(float)};
  const cuuint32_t box[2] = {32, (cuuint32_t)box_rows};
  const cuuint32_t elems[2] = {1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2, const_cast<float*>(p), dims, strides, box,
                elems, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// The wgmma kernel: bulk (TMA) copies where N and R are multiples of 4 and
// the bases 16-byte aligned, else plain loads.  No cluster.
int launch_wgmma(const ChunkArgs& a, int stages, int cl, cudaStream_t stream) {
  if (a.R > WG_MAX_R || stages < 2 || stages > 8 || cl != 1) return cudaErrorInvalidValue;
  CUtensorMap map_u = {}, map_ut = {};
  int bulk = a.N % 4 == 0 && a.R % 4 == 0 && aligned16(a.U) && aligned16(a.Ut);
  if (bulk) bulk = tensor_map(&map_u, a.U, a.N, a.R, 64) && tensor_map(&map_ut, a.Ut, a.R, a.N, 64);
  // rows of the lane state 16-byte aligned: its epilogue moves float4s
  const int vec = a.N % 4 == 0 && aligned16(a.acy) && aligned16(a.ho) && aligned16(a.x0o) &&
                  aligned16(a.x1o) && aligned16(a.x0p);
  const size_t smem = smem_bytes_wg(a.N, a.R, stages);
  cudaError_t err = cudaFuncSetAttribute(fused_two_block_wgmma_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  fused_two_block_wgmma_kernel<<<(a.B + WG_TB - 1) / WG_TB, WG_THREADS, smem, stream>>>(
      map_u, map_ut, a.U, a.Ut, a.dinv, a.acy, a.mu, a.thr, a.x0, a.x1, a.h, a.x0o, a.x1o, a.ho,
      a.x0p, a.B, a.N, a.R, a.n_iters, a.prox, a.thin, stages, bulk, vec);
  return cudaGetLastError();
}

// Measurement only: every block reads the whole buffer `passes` times
// through L2 (not L1), as every block of the chunk kernels reads all of U
// and Ut once per iteration; `rotate` starts each block at another offset,
// where the chunk kernels' blocks all start at the same one.
__global__ void __launch_bounds__(1024) l2_probe_kernel(const float4* __restrict__ buf, int n4,
                                                        int passes, int rotate,
                                                        float* __restrict__ out) {
  float sum = 0.f;
  int start = rotate ? (int)((long long)blockIdx.x * n4 / gridDim.x) : 0;
  for (int p = 0; p < passes; ++p) {
#pragma unroll 4
    for (int i = threadIdx.x; i < n4; i += 1024) {
      const int j = i + start < n4 ? i + start : i + start - n4;
      const float4 v = __ldcg(buf + j);
      sum += (v.x + v.y) + (v.z + v.w);
    }
    start = (start + 1024) % n4;
  }
  if (sum == 1.2345e30f) *out = sum;  // keeps the loads alive
}

}  // namespace

extern "C" {

// Launch the L2 read probe on `stream`: `blocks` blocks each read `n` floats
// (a multiple of 4, at most 2^30) `passes` times.
int fused_two_block_l2_probe(int device, const float* buf, int n, int passes, int rotate,
                             int blocks, float* out, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (n < 4 || n % 4 || passes < 1 || blocks < 1 || !aligned16(buf)) return cudaErrorInvalidValue;
  l2_probe_kernel<<<blocks, 1024, 0, (cudaStream_t)stream>>>(
      reinterpret_cast<const float4*>(buf), n / 4, passes, rotate, out);
  return cudaGetLastError();
}

// Dynamic shared memory, in bytes, of a block of `tb` lanes with `stages`
// k-tiles of depth `kt` in its ring; `tc` = the tensor-core kernel.
size_t fused_two_block_smem_bytes(int tb, int n, int r, int kt, int stages, int tc) {
  if (tc == 2) return smem_bytes_wg(n, r, stages);
  return tc ? smem_bytes_tc(n, r, kt, stages) : smem_bytes(tb, n, r, kt, stages);
}

// The device's opt-in shared-memory limit per block, in bytes.
int fused_two_block_max_smem(int device, int* bytes) {
  return cudaDeviceGetAttribute(bytes, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
}

const char* fused_two_block_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

// Launch on `stream` without synchronising; returns cudaGetLastError()
// after the launch (0 on success).  `tc` = 0: the FMA kernel, (tb, kt) one
// of the instantiations below; `tc` = 1: the split-TF32 tensor-core kernel,
// tb = 32, kt 16 or 32; `tc` = 2: the wgmma kernel, tb = 32, kt = 32 (its
// atom), R <= 128, stages 2..8 per warpgroup, cluster 1.  stages 2..16,
// cluster 1..8 otherwise (above 1 only when N and R are multiples of 4).
int fused_two_block_launch(int device, const float* U, const float* Ut,
                           const float* dinv, const float* acy, const float* mu,
                           const float* thr, const float* x0, const float* x1,
                           const float* h, float* x0o, float* x1o, float* ho,
                           float* x0p, int B, int N, int R, int n_iters, int prox,
                           int thin, int tb, int kt, int stages, int cluster, int tc,
                           void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  cudaStream_t s = (cudaStream_t)stream;
  const ChunkArgs a = {U, Ut, dinv, acy, mu, thr, x0, x1, h, x0o, x1o, ho, x0p,
                       B, N, R, n_iters, prox, thin};
  if (tc == 2) {
    if (tb != WG_TB || kt != 32) return cudaErrorInvalidValue;
    return launch_wgmma(a, stages, cluster, s);
  }
  if (tc) {
    if (tb != TC_TB) return cudaErrorInvalidValue;
    const size_t smem = smem_bytes_tc(N, R, kt, stages);
    if (kt == 16)
      return launch(fused_two_block_tc_kernel<16>, TC_THREADS, TC_TB, smem, a, stages, cluster, s);
    if (kt == 32)
      return launch(fused_two_block_tc_kernel<32>, TC_THREADS, TC_TB, smem, a, stages, cluster, s);
    return cudaErrorInvalidValue;
  }
  // The FMA kernel at 32 lanes is never the wrapper's choice (the tensor-core
  // kernel is); it is built so that the two routes' errors can be compared.
#define FTB_LAUNCH(T, K)                                                          \
  if (tb == T && kt == K)                                                         \
    return launch(fused_two_block_kernel<T, K>, Layout<T>::THREADS, T,            \
                  smem_bytes(T, N, R, K, stages), a, stages, cluster, s);
  FTB_LAUNCH(32, 32)
  FTB_LAUNCH(16, 16)
  FTB_LAUNCH(8, 16)
  FTB_LAUNCH(4, 16)
  FTB_LAUNCH(2, 16)
  FTB_LAUNCH(1, 16)
#undef FTB_LAUNCH
  return cudaErrorInvalidValue;
}

}  // extern "C"
