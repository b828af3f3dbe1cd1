// K1-K4: the GLM value + gradient of both families, designed for Hopper.
//
// Replaces the Pallas TPU kernels of brancher_tpu/ops/pallas_glm.py:
//   K1 _bern_kernel         (bernoulli_logit, f32 design matrix)
//   K2 _bern_kernel_bf16    (bernoulli_logit, bf16 design matrix)
//   K3 _normal_kernel       (normal_learned,  f32 design matrix)
//   K4 _normal_kernel_bf16  (normal_learned,  bf16 design matrix)
// Included by glm_vg.cu, which defines softplus_f and sigmoid_f and the C
// entries glm_vg_bernoulli_f32 / _bf16 and glm_vg_normal_f32 / _bf16, and
// logreg_vg_f32 (K6 of pallas_logreg.py, on K1's passes).
//
// What it computes, for chains z [C,D], design X [N,D], y, offset b [N], a
// diagonal Gaussian prior (m, iv) [D] and a likelihood scale s_ll:
//   bernoulli_logit:  l = z X^T + b
//     val  = s_ll sum_n (y l - softplus l) - 1/2 sum_d (z-m)^2 iv
//     grad = s_ll (y - sigmoid l) X - (z-m) iv
//   normal_learned:   r = y - (z X^T + b), rss = sum_n r^2, s = z.u + c0,
//                     e2 = exp(-2 s)
//     val  = s_ll (-1/2 e2 rss - N s) - 1/2 sum_d (z-m)^2 iv
//     grad = s_ll (e2 r X + (e2 rss - N) u) - (z-m) iv
// K2 and K4 round z and the residual to bf16 at the two products (as the
// TPU kernels do, pallas_glm.py:263, :310); softplus, sigmoid, rss, z.u,
// exp and every sum stay f32.
//
// Bound on this card.  4 C N D operations against one read of X: at the
// MXU-scale shape (C=256, N=131072, D=1024) 137 GFLOP, 0.14 ms at the
// 989 TFLOP/s of bf16 tensor cores (K2, K4) and 2.05 ms at the 67 TFLOP/s
// of f32 CUDA-core FMA (K1, K3).  All four are bound by operations there.
// The two families differ only in the elementwise middle of pass A and in
// the finish's epilogue, so they share every mainloop below.
//
// Design.  The TPU kernel sweeps row blocks in order and keeps val/grad
// resident.  Here the call is cut into passes with no atomics and a fixed
// order of every sum, so each launch is bit-reproducible:
//   pass 0  z into a scratch with a 16-byte-aligned row stride (bf16:
//           rounded once per call);
//   pass A  grid (chain tile, row tile): z X^T + b for the tile, K = D the
//           reduction; the family's elementwise middle in registers; the
//           residual (y - sigmoid l, or y - loc) to a scratch [C, ldr] (bf16
//           or f32) and one partial per (chain, row tile) to ll_part [C, T]:
//           the log-likelihood, or the rss;
//   pass B  grid (chain tile, D tile, row split): g_part[s] = resid[:, rows
//           of s] X[rows of s, :], the output tile accumulated in registers
//           over all the rows of the split and written once;
//   finish  one block per chain: the fixed-order sums of the T partials
//           and the S gradient partials, z.u for normal_learned, the prior
//           and the family's epilogue.
// The wrapper's planner (ops/glm.py plan_glm) chooses the strides, the row
// tiles and the splits; the launch checks them against the tiles here.
//
// Narrow width (f32, D up to the planner's threshold): one fused pass takes
// the place of passes 0, A and B.  At D = 55 (UCI Covertype's width) the
// passes' tiles, chosen for D = 1024, ran at a quarter of the f32 bound:
// pass A wrote a [C, N] f32 residual and pass B read it back (2.38 GB each
// way at C = 1024, N = 581,012), and pass B's 128-column block was 43 %
// full.  The fused pass (f32_narrow) keeps a chain tile's gradient in
// registers and each tile of residuals in shared memory, runs both products
// over one tile of X back to back, and writes only per-split partials; the
// same finish sums them.  Its products are exact f32 FMA as the passes'.
//
// bf16 mainloops (K2, K4): one warpgroup per block runs wgmma.m64n64k16
// (bf16 in, f32 accumulators in registers) on tiles that TMA brings into a
// 3-stage ring of shared memory, each stage completed by an mbarrier.  At
// the MXU shape K2's passes reached 275 TFLOP/s on an H100 (PERF.md), 28 %
// of the bound: pass A's 4,096 short tiles each refill the ring and run
// their epilogue (a persistent pass A is queued).  Tiles are 64 bf16
// (128 bytes) deep with the 128-byte swizzle, which the wgmma descriptors
// match.  Pass A's operands are both K-major (z rows, X rows); pass B's A
// (the residual) is K-major and its B (X, whose rows are now the depth) is
// MN-major, taken with the descriptor's transpose bit.  TMA fills out-of-
// bounds elements with zeros, which covers the ragged C, N and D edges.
//
// f32 mainloops (K1, K3): exact f32 FMA on the CUDA cores (no tensor cores,
// no TF32).  256 threads own a 128 x 128 tile, 8 x 8 outputs each; cp.async
// brings 16-byte pieces into a 4-stage ring; each thread reads its operands
// as float4, one shared-memory load for every 16 FMAs.  Ragged edges are
// zero-filled by the copies' source size.

#pragma once

namespace glm90 {

constexpr int BERNOULLI = 0;  // bernoulli_logit: K1, K2
constexpr int NORMAL = 1;     // normal_learned: K3, K4

// ---- bf16 (wgmma + TMA) -----------------------------------------------------
constexpr int T_BM = 64;        // chains per block, both passes (one wgmma M)
constexpr int T_ROWS_A = 128;   // pass A: X rows per tile (two n64 products)
constexpr int T_COLS_B = 128;   // pass B: D columns per block (two n64 products)
constexpr int T_BK = 64;        // depth per stage: 64 bf16 = 128 bytes, the swizzle span
constexpr int T_STAGES = 3;    // 74 KB of ring: three blocks per SM, so one
                                // block's epilogue runs beside the others'
                                // products (on an H100 at the MXU shape, 4
                                // stages and two blocks: 0.60 ms; 3: 0.51)
constexpr int T_BLOCKS_PER_SM = 3;
constexpr int T_THREADS = 128;  // one warpgroup
constexpr int T_STAGE_A = T_BM * T_BK * 2;   // 8 KB
constexpr int T_HALF_B = 64 * T_BK * 2;      // 8 KB: one n64 operand
constexpr int T_STAGE_B = 2 * T_HALF_B;      // 16 KB
constexpr int T_SMEM = T_STAGES * (T_STAGE_A + T_STAGE_B) + 1024 + 8 * T_STAGES;
constexpr int T_ALIGN = 8;      // elements in 16 bytes of bf16

// ---- f32 (CUDA cores, cp.async) ---------------------------------------------
constexpr int F_BM = 128;       // chains per block, both passes
constexpr int F_BN = 128;       // pass A: X rows per tile; pass B: D columns
constexpr int F_BK = 16;        // depth per stage
constexpr int F_STAGES = 4;    // 3 stages: 1 % slower at the MXU shape (H100)
constexpr int F_THREADS = 256;  // 16 x 16 threads, 8 x 8 outputs each
constexpr int F_LDK = F_BK + 4;   // [128][20] tiles with the depth contiguous
constexpr int F_LDD = F_BN + 4;   // pass B's X tile [16][132], D contiguous
constexpr int F_SMEM_A = F_STAGES * 2 * F_BM * F_LDK * 4;
constexpr int F_SMEM_B = F_STAGES * (F_BM * F_LDK + F_BK * F_LDD) * 4;
constexpr int F_ALIGN = 4;      // elements in 16 bytes of f32
constexpr int F_BLOCKS_PER_SM = 2;  // 128 registers a thread, 80 KB of ring

// ---- f32 at narrow width: one fused pass (CUDA cores, cp.async) -------------
constexpr int N_ROWS = 64;         // X rows per tile; a split is whole tiles
constexpr int N_THREADS = 256;
constexpr int N_DEPTH_ALIGN = 8;   // z and X staged D' = D rounded up to 8 wide, rows
                                   // D' + 4 floats apart: an odd count of 16-byte pieces
constexpr int N_MAX_DEPTH = 64;    // the widest D' the pass takes
constexpr int N_LDR = N_ROWS + 4;  // the residual tile's row stride

constexpr int N_BLOCKS_PER_SM = 2;  // the launch bounds' 128 registers a thread

// shared memory of one narrow block of bc chains at staged width dp: the z
// tile, the residual tile, and two stages of X, y and b
__host__ __device__ constexpr int narrow_smem_bytes(int bc, int dp) {
  return 4 * (bc * (dp + 4) + bc * N_LDR + 2 * (N_ROWS * (dp + 4) + 2 * N_ROWS));
}
// the widest block and the 1 KB an H100 keeps back for each: two fit in an
// SM's 228 KB, so shared memory never cuts the planner's two blocks
static_assert(N_BLOCKS_PER_SM * (narrow_smem_bytes(128, N_MAX_DEPTH) + 1024) <= 228 * 1024,
              "two narrow blocks a multiprocessor");

constexpr int FINISH_THREADS = 256;

// ---- PTX helpers ------------------------------------------------------------
__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(bar), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

__device__ __forceinline__ void tma_load_2d(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                            int inner, int outer) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4}], [%2];" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(inner), "r"(outer)
      : "memory");
}

// wgmma shared-memory descriptor, 128-byte swizzle; offsets in bytes
__device__ __forceinline__ uint64_t sw128_desc(uint32_t saddr, uint32_t lbo, uint32_t sbo) {
  return static_cast<uint64_t>((saddr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>((lbo & 0x3FFFF) >> 4) << 16) |
         (static_cast<uint64_t>((sbo & 0x3FFFF) >> 4) << 32) | (1ull << 62);
}

template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

// d[64 x 64] = A[64 x 16] B[16 x 64] (+ d when accumulate is 1), bf16 in,
// f32 accumulators
template <int TRANS_B>
__device__ __forceinline__ void wgmma_m64n64k16(float (&d)[32], uint64_t da, uint64_t db,
                                                int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, %35;\n}"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),
        "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]),
        "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
        "+f"(d[31])
      : "l"(da), "l"(db), "r"(accumulate), "n"(TRANS_B));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src, int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(smem_u32(dst)), "l"(src),
               "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src, int bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;" ::"r"(smem_u32(dst)), "l"(src),
               "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void cp_commit() { asm volatile("cp.async.commit_group;" ::: "memory"); }
template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(N) : "memory");
}

__device__ __forceinline__ int clamp4(int v) { return v < 0 ? 0 : (v > 4 ? 4 : v); }

// ---- pass 0: z into its aligned scratch ------------------------------------
template <typename T> __device__ __forceinline__ T to_operand(float v);
template <> __device__ __forceinline__ float to_operand<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 to_operand<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

template <typename T>
__global__ void __launch_bounds__(256) stage_z(const float* __restrict__ z, T* __restrict__ zs,
                                               int C, int D, int ldz) {
  const size_t total = static_cast<size_t>(C) * D;
  for (size_t e = blockIdx.x * 256ull + threadIdx.x; e < total; e += gridDim.x * 256ull) {
    const size_t c = e / D, d = e % D;
    zs[c * ldz + d] = to_operand<T>(z[e]);
  }
}

// ---- pass A's elementwise middle --------------------------------------------
// One element of pass A: acc = z.x_n, yv = y[n], bv = b[n].  Adds the
// element's term to the partial (log-likelihood or rss) and returns its
// residual.
template <int FAMILY>
__device__ __forceinline__ float middle(float acc, float yv, float bv, float& part) {
  const float l = acc + bv;
  if (FAMILY == BERNOULLI) {
    part += yv * l - softplus_f(l);
    return yv - sigmoid_f(l);
  }
  const float r = yv - l;
  part += r * r;
  return r;
}

// ---- bf16 mainloop: TMA ring -> wgmma ---------------------------------------
// acc[h] is the h-th n64 half of the block's [64 x 128] output.  The tensor
// cores sum each 64-deep stage into fresh registers, which are then added
// to acc on the CUDA cores in f32 with round-to-nearest: the tensor cores'
// own accumulation rounds less carefully, and over 14,592 rows (a split of
// pass B at the MXU shape) kept in their accumulator it drifted by 1.3e-5
// of the gradient's scale (measured on an H100).  Depth step k
// covers depth k0 + 64 k.  A box: (k0 + 64 k, a_outer).  B: pass A (TRANS_B
// 0) one [128 x 64] box at (k0 + 64 k, b_pos); pass B (TRANS_B 1) b_halves
// [64 depth x 64] boxes at (b_pos + 64 h, k0 + 64 k).
template <int TRANS_B>
__device__ __forceinline__ void tma_wgmma_mainloop(float (&acc)[2][32], uint8_t* buf, int k_iters,
                                                   const CUtensorMap* amap,
                                                   const CUtensorMap* bmap, int k0, int a_outer,
                                                   int b_pos, int b_halves) {
  uint64_t* bars = reinterpret_cast<uint64_t*>(buf + T_STAGES * (T_STAGE_A + T_STAGE_B));
  const int tid = threadIdx.x;
  const uint32_t bytes = T_STAGE_A + (TRANS_B ? b_halves * T_HALF_B : T_STAGE_B);
  float part[2][32];
  auto load_stage = [&](int k, int s) {
    const uint32_t bar = smem_u32(&bars[s]);
    const uint32_t a_dst = smem_u32(buf + s * T_STAGE_A);
    const uint32_t b_dst = smem_u32(buf + T_STAGES * T_STAGE_A + s * T_STAGE_B);
    const int depth = k0 + k * T_BK;
    mbar_expect_tx(bar, bytes);
    tma_load_2d(a_dst, amap, bar, depth, a_outer);
    if (TRANS_B) {
      for (int h = 0; h < b_halves; ++h) tma_load_2d(b_dst + h * T_HALF_B, bmap, bar, b_pos + 64 * h, depth);
    } else {
      tma_load_2d(b_dst, bmap, bar, depth, b_pos);
    }
  };
  if (tid == 0) {
    for (int s = 0; s < T_STAGES; ++s) mbar_init(smem_u32(&bars[s]), 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  if (tid == 0)
    for (int s = 0; s < T_STAGES && s < k_iters; ++s) load_stage(s, s);

  for (int k = 0; k < k_iters; ++k) {
    const int s = k % T_STAGES;
    mbar_wait(smem_u32(&bars[s]), (k / T_STAGES) & 1);
    const uint32_t a = smem_u32(buf + s * T_STAGE_A);
    const uint32_t b = smem_u32(buf + T_STAGES * T_STAGE_A + s * T_STAGE_B);
    fence_regs(part[0]);
    fence_regs(part[1]);
    asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
#pragma unroll
    for (int kk = 0; kk < T_BK / 16; ++kk) {
      // K-major: the next 16 of the 64 depth values are 32 bytes on within
      // each 128-byte row; 8-row groups lie 1024 bytes apart
      const uint64_t da = sw128_desc(a + kk * 32, 16, 1024);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        // MN-major: 16 depth rows of 128 bytes are 2048 bytes on; one
        // 64-wide swizzle atom spans the whole n64 operand
        const uint64_t db = TRANS_B ? sw128_desc(b + h * T_HALF_B + kk * 2048, 1024, 1024)
                                    : sw128_desc(b + h * T_HALF_B + kk * 32, 16, 1024);
        wgmma_m64n64k16<TRANS_B>(part[h], da, db, kk > 0);
      }
    }
    asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
    asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
    fence_regs(part[0]);
    fence_regs(part[1]);
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int i = 0; i < 32; ++i) acc[h][i] += part[h][i];
    __syncthreads();  // every warp is done reading stage s
    if (tid == 0 && k + T_STAGES < k_iters) load_stage(k + T_STAGES, s);
  }
}

__device__ __forceinline__ uint8_t* align1024(uint8_t* p) {
  const uint32_t off = smem_u32(p) & 1023u;
  return off ? p + (1024 - off) : p;
}

// ---- bf16 pass A ------------------------------------------------------------
// The tensor cores sum the D products in another order than cuBLAS's f32
// product in the plain version, so a logit (or loc) may differ from the
// plain one in its last bits, and where that moves the residual across a
// bf16 rounding midpoint the bf16 residual differs by one bf16 unit.  Such
// ties are rare (17 in a million Bernoulli residuals at the MXU shape on an
// H100); chip_smoke.py and the card-only tests count them and hold the rest
// of the call to the plain version given the kernel's rounding.
template <int FAMILY>
__global__ void __launch_bounds__(T_THREADS) bf16_pass_a(
    const __grid_constant__ CUtensorMap zmap, const __grid_constant__ CUtensorMap xmap,
    const float* __restrict__ y, const float* __restrict__ b, __nv_bfloat16* __restrict__ resid,
    float* __restrict__ ll_part, int C, int N, int D, int ldr, int row_tiles) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* buf = align1024(smem_raw);
  const int c_base = blockIdx.x * T_BM, r_base = blockIdx.y * T_ROWS_A;
  float acc[2][32];
#pragma unroll
  for (int h = 0; h < 2; ++h)
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[h][i] = 0.f;
  tma_wgmma_mainloop<0>(acc, buf, (D + T_BK - 1) / T_BK, &zmap, &xmap, 0, c_base, r_base, 2);

  // accumulator i of thread (warp w, lane l): chain 16 w + l/4 + 8 ((i/2) % 2),
  // row 8 (i/4) + 2 (l % 4) + i % 2 of the n64 half
  const int w = threadIdx.x >> 5, l = threadIdx.x & 31;
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    const int c = c_base + w * 16 + (l >> 2) + 8 * hr;
    float ll = 0.f;  // log-likelihood or rss of the tile's real rows
#pragma unroll
    for (int h = 0; h < 2; ++h) {
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int n = r_base + h * 64 + j * 8 + (l & 3) * 2;
        float r[2] = {0.f, 0.f};
#pragma unroll
        for (int e = 0; e < 2; ++e)
          if (n + e < N)
            r[e] = middle<FAMILY>(acc[h][j * 4 + hr * 2 + e], y[n + e], b[n + e], ll);
        if (c < C && n < N)  // n even, ldr a multiple of 8: the pair lies in the row
          *reinterpret_cast<__nv_bfloat162*>(resid + static_cast<size_t>(c) * ldr + n) =
              __floats2bfloat162_rn(r[0], r[1]);
      }
    }
    ll += __shfl_xor_sync(0xffffffffu, ll, 1);
    ll += __shfl_xor_sync(0xffffffffu, ll, 2);
    if ((l & 3) == 0 && c < C) ll_part[static_cast<size_t>(c) * row_tiles + blockIdx.y] = ll;
  }
}

// ---- bf16 pass B (both families) --------------------------------------------
__global__ void __launch_bounds__(T_THREADS) bf16_pass_b(
    const __grid_constant__ CUtensorMap rmap, const __grid_constant__ CUtensorMap xmap,
    float* __restrict__ g_part, int C, int N, int D, int ldg, int rows_per_split) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* buf = align1024(smem_raw);
  const int c_base = blockIdx.x * T_BM, d_base = blockIdx.y * T_COLS_B, s = blockIdx.z;
  const int row0 = s * rows_per_split;
  const int rows = min(rows_per_split, N - row0);
  float acc[2][32];
#pragma unroll
  for (int h = 0; h < 2; ++h)
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[h][i] = 0.f;
  const int halves = (d_base + 64 < D) ? 2 : 1;  // a second half wholly past D is not loaded
  tma_wgmma_mainloop<1>(acc, buf, (rows + T_BK - 1) / T_BK, &rmap, &xmap, row0, c_base, d_base,
                        halves);

  const int w = threadIdx.x >> 5, l = threadIdx.x & 31;
  float* g = g_part + static_cast<size_t>(s) * C * ldg;
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    const int c = c_base + w * 16 + (l >> 2) + 8 * hr;
    if (c >= C) continue;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int d = d_base + h * 64 + j * 8 + (l & 3) * 2;
        float* p = g + static_cast<size_t>(c) * ldg + d;
        const float v0 = acc[h][j * 4 + hr * 2], v1 = acc[h][j * 4 + hr * 2 + 1];
        if (d + 1 < D) {
          *reinterpret_cast<float2*>(p) = make_float2(v0, v1);
        } else if (d < D) {
          *p = v0;
        }
      }
    }
  }
}

// ---- f32 pass A -------------------------------------------------------------
template <int FAMILY>
__global__ void __launch_bounds__(F_THREADS, 2) f32_pass_a(
    const float* __restrict__ zs, const float* __restrict__ x, const float* __restrict__ y,
    const float* __restrict__ b, float* __restrict__ resid, float* __restrict__ ll_part, int C,
    int N, int D, int ldz, int ldx, int ldr, int row_tiles) {
  extern __shared__ float4 fsm4[];
  float* As = reinterpret_cast<float*>(fsm4);       // [stage][128 chains][F_LDK]
  float* Bs = As + F_STAGES * F_BM * F_LDK;          // [stage][128 rows][F_LDK]
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int c_base = blockIdx.x * F_BM, r_base = blockIdx.y * F_BN;
  const int k_iters = (D + F_BK - 1) / F_BK;

  auto load = [&](int k, int st) {
#pragma unroll
    for (int q = 0; q < 2; ++q) {
      const int e = tid + F_THREADS * q;
      const int row = e >> 2, k4 = (e & 3) * 4;
      const int gk = k * F_BK + k4;
      const int kb = 4 * clamp4(D - gk);
      const int gc = c_base + row, gn = r_base + row;
      const int zb = gc < C ? kb : 0, xb = gn < N ? kb : 0;
      cp_async16(As + (st * F_BM + row) * F_LDK + k4,
                 zb ? zs + static_cast<size_t>(gc) * ldz + gk : zs, zb);
      cp_async16(Bs + (st * F_BN + row) * F_LDK + k4,
                 xb ? x + static_cast<size_t>(gn) * ldx + gk : x, xb);
    }
  };

  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

#pragma unroll
  for (int s = 0; s < F_STAGES - 1; ++s) {
    if (s < k_iters) load(s, s);
    cp_commit();
  }
  for (int k = 0; k < k_iters; ++k) {
    cp_wait<F_STAGES - 2>();
    __syncthreads();  // stage k landed for every thread; stage k - 1 is free
    if (k + F_STAGES - 1 < k_iters) load(k + F_STAGES - 1, (k + F_STAGES - 1) % F_STAGES);
    cp_commit();
    const float* a = As + (k % F_STAGES) * F_BM * F_LDK;
    const float* bt = Bs + (k % F_STAGES) * F_BN * F_LDK;
#pragma unroll
    for (int k4 = 0; k4 < F_BK; k4 += 4) {
      float4 av[8];
#pragma unroll
      for (int i = 0; i < 8; ++i)
        av[i] = *reinterpret_cast<const float4*>(a + (ty + 16 * i) * F_LDK + k4);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float4 bv = *reinterpret_cast<const float4*>(bt + (tx + 16 * j) * F_LDK + k4);
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          acc[i][j] = fmaf(av[i].x, bv.x, acc[i][j]);
          acc[i][j] = fmaf(av[i].y, bv.y, acc[i][j]);
          acc[i][j] = fmaf(av[i].z, bv.z, acc[i][j]);
          acc[i][j] = fmaf(av[i].w, bv.w, acc[i][j]);
        }
      }
    }
  }
  cp_wait<0>();

  // outputs of thread (tx, ty): chains ty + 16 i, rows tx + 16 j
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int c = c_base + ty + 16 * i;
    float ll = 0.f;  // log-likelihood or rss of the tile's real rows
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int n = r_base + tx + 16 * j;
      if (n < N) {
        const float r = middle<FAMILY>(acc[i][j], y[n], b[n], ll);
        if (c < C) resid[static_cast<size_t>(c) * ldr + n] = r;
      }
    }
    // the 16 tx lanes of a chain, in a fixed order
#pragma unroll
    for (int off = 1; off < 16; off <<= 1) ll += __shfl_xor_sync(0xffffffffu, ll, off);
    if (tx == 0 && c < C) ll_part[static_cast<size_t>(c) * row_tiles + blockIdx.y] = ll;
  }
}

// ---- f32 pass B (both families) ---------------------------------------------
__global__ void __launch_bounds__(F_THREADS, 2) f32_pass_b(
    const float* __restrict__ resid, const float* __restrict__ x, float* __restrict__ g_part,
    int C, int N, int D, int ldr, int ldx, int ldg, int rows_per_split) {
  extern __shared__ float4 fsm4[];
  float* As = reinterpret_cast<float*>(fsm4);       // [stage][128 chains][F_LDK rows]
  float* Bs = As + F_STAGES * F_BM * F_LDK;          // [stage][16 rows][F_LDD columns]
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int c_base = blockIdx.x * F_BM, d_base = blockIdx.y * F_BN, s = blockIdx.z;
  const int row0 = s * rows_per_split;
  const int row_end = min(row0 + rows_per_split, N);
  const int k_iters = (row_end - row0 + F_BK - 1) / F_BK;

  auto load = [&](int k, int st) {
    const int n0 = row0 + k * F_BK;
#pragma unroll
    for (int q = 0; q < 2; ++q) {
      const int e = tid + F_THREADS * q;
      // residual: chain e / 4, rows n0 + 4 (e % 4) .. + 3
      const int row = e >> 2, k4 = (e & 3) * 4;
      const int gc = c_base + row, gn = n0 + k4;
      const int rb = gc < C ? 4 * clamp4(row_end - gn) : 0;
      cp_async16(As + (st * F_BM + row) * F_LDK + k4,
                 rb ? resid + static_cast<size_t>(gc) * ldr + gn : resid, rb);
      // X: row n0 + e / 32, columns d_base + 4 (e % 32) .. + 3
      const int xr = e >> 5, d4 = (e & 31) * 4;
      const int xn = n0 + xr, gd = d_base + d4;
      const int xb = xn < row_end ? 4 * clamp4(D - gd) : 0;
      cp_async16(Bs + (st * F_BK + xr) * F_LDD + d4,
                 xb ? x + static_cast<size_t>(xn) * ldx + gd : x, xb);
    }
  };

  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

#pragma unroll
  for (int st = 0; st < F_STAGES - 1; ++st) {
    if (st < k_iters) load(st, st);
    cp_commit();
  }
  for (int k = 0; k < k_iters; ++k) {
    cp_wait<F_STAGES - 2>();
    __syncthreads();
    if (k + F_STAGES - 1 < k_iters) load(k + F_STAGES - 1, (k + F_STAGES - 1) % F_STAGES);
    cp_commit();
    const float* a = As + (k % F_STAGES) * F_BM * F_LDK;
    const float* bt = Bs + (k % F_STAGES) * F_BK * F_LDD;
#pragma unroll
    for (int k4 = 0; k4 < F_BK; k4 += 4) {
      float4 av[8];
#pragma unroll
      for (int i = 0; i < 8; ++i)
        av[i] = *reinterpret_cast<const float4*>(a + (ty + 16 * i) * F_LDK + k4);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const float4 b0 = *reinterpret_cast<const float4*>(bt + (k4 + kk) * F_LDD + tx * 4);
        const float4 b1 = *reinterpret_cast<const float4*>(bt + (k4 + kk) * F_LDD + 64 + tx * 4);
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          const float av_k = kk == 0 ? av[i].x : kk == 1 ? av[i].y : kk == 2 ? av[i].z : av[i].w;
          acc[i][0] = fmaf(av_k, b0.x, acc[i][0]);
          acc[i][1] = fmaf(av_k, b0.y, acc[i][1]);
          acc[i][2] = fmaf(av_k, b0.z, acc[i][2]);
          acc[i][3] = fmaf(av_k, b0.w, acc[i][3]);
          acc[i][4] = fmaf(av_k, b1.x, acc[i][4]);
          acc[i][5] = fmaf(av_k, b1.y, acc[i][5]);
          acc[i][6] = fmaf(av_k, b1.z, acc[i][6]);
          acc[i][7] = fmaf(av_k, b1.w, acc[i][7]);
        }
      }
    }
  }
  cp_wait<0>();

  // outputs of thread (tx, ty): chains ty + 16 i, columns 4 tx + 64 jj + e
  float* g = g_part + static_cast<size_t>(s) * C * ldg;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int c = c_base + ty + 16 * i;
    if (c >= C) continue;
#pragma unroll
    for (int jj = 0; jj < 2; ++jj) {
      const int d = d_base + tx * 4 + 64 * jj;
      float* p = g + static_cast<size_t>(c) * ldg + d;
      if (d + 3 < D) {
        *reinterpret_cast<float4*>(p) =
            make_float4(acc[i][4 * jj], acc[i][4 * jj + 1], acc[i][4 * jj + 2], acc[i][4 * jj + 3]);
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (d + e < D) p[e] = acc[i][4 * jj + e];
      }
    }
  }
}

// ---- f32 narrow pass (both families) ----------------------------------------
// The narrow pass's elementwise middle: middle's, but the Bernoulli family
// takes softplus and sigmoid from one exponential, e = exp(-|l|), and
// 1 / (1 + e) from the reciprocal's approximation and one Newton step
// (1 + e lies in [1, 2]), so that no branch keeps the compiler from
// interleaving a thread's 32 elements.
template <int FAMILY>
__device__ __forceinline__ float middle_one_exp(float acc, float yv, float bv, float& part) {
  if (FAMILY == NORMAL) return middle<NORMAL>(acc, yv, bv, part);
  const float l = acc + bv;
  const float e = expf(-fabsf(l)), t = 1.f + e;
  float q = __fdividef(1.f, t);
  q = fmaf(q, fmaf(-t, q, 1.f), q);
  part += yv * l - (fmaxf(l, 0.f) + log1pf(e));  // softplus_f(l)
  return yv - (l >= 0.f ? q : e * q);
}

// Grid (chain tile, row split).  The block stages its z tile [BC, D'] once
// (D' = D rounded up to N_DEPTH_ALIGN, zeros past D), then walks the split's
// rows in tiles of N_ROWS, each tile's X rows, y and b brought by cp.async
// into a two-stage ring while the block works on the one before.  For each
// tile:
//   product 1  l = z X^T + b: thread (tx, ty) owns chains ty + 16 i and rows
//              tx + 16 j, both operands read as float4 along the depth;
//   middle     the family's elementwise middle; the tile's log-likelihood
//              (or rss) added to the thread's per-chain registers, the
//              residual to a shared tile R [BC, N_ROWS], 0 on rows past the
//              split's end (masked: a zero-filled row would otherwise add the
//              Bernoulli residual -1/2 and its log-likelihood);
//   product 2  g[BC, D'] += R X[tile rows, :]: the thread owns columns
//              4 cg .. 4 cg + 3 of chains cr + (256 / CGP) k, in registers for
//              the whole split.
// Then the block writes one gradient partial [BC, D] to g_part[split] and,
// per chain, the sum of the 16 row lanes' partials to ll_part[c, split], for
// the finish.  No [C, N] tensor reaches device memory, every sum has a fixed
// order and there are no atomics.  CGP, the column groups of product 2's
// thread grid, is D'/4 rounded up to 4 or 16; threads past D'/4 idle in
// product 2.
template <int FAMILY, int BC, int CGP>
__global__ void __launch_bounds__(N_THREADS, N_BLOCKS_PER_SM) f32_narrow(
    const float* __restrict__ z, const float* __restrict__ x, const float* __restrict__ y,
    const float* __restrict__ b, float* __restrict__ ll_part, float* __restrict__ g_part, int C,
    int N, int D, int ldx, int ldg, int splits, int rows_per_split) {
  constexpr int MI = BC / 16;              // product 1: chains a thread
  constexpr int CSTEP = N_THREADS / CGP;   // product 2: chain stride
  constexpr int NCH = BC / CSTEP;          // product 2: chains a thread
  static_assert(NCH >= 1 && BC % 16 == 0 && N_ROWS % CSTEP == 0, "narrow tile");
  extern __shared__ float4 fsm4[];
  const int dp = (D + N_DEPTH_ALIGN - 1) / N_DEPTH_ALIGN * N_DEPTH_ALIGN;
  const int ldk = dp + 4, dq = dp / 4;
  float* zs = reinterpret_cast<float*>(fsm4);  // [BC][ldk]
  float* rs = zs + BC * ldk;                   // [BC][N_LDR]
  float* xs = rs + BC * N_LDR;                 // [stage][N_ROWS][ldk]
  float* ys = xs + 2 * N_ROWS * ldk;           // [stage][N_ROWS]
  float* bs = ys + 2 * N_ROWS;                 // [stage][N_ROWS]
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int cg = tid % CGP, cr = tid / CGP;
  const int c_base = blockIdx.x * BC, s = blockIdx.y;
  const int row0 = s * rows_per_split, row_end = min(row0 + rows_per_split, N);
  const int tiles = (row_end - row0 + N_ROWS - 1) / N_ROWS;

  auto load = [&](int t, int st) {
    const int n0 = row0 + t * N_ROWS;
    float* xd = xs + st * N_ROWS * ldk;
    // the 16-byte piece cg of rows cr, cr + 256 / CGP, ... (CGP >= D'/4 pieces a row)
    if (cg < dq) {
      const int q = 4 * cg;
#pragma unroll
      for (int k = 0; k < N_ROWS / CSTEP; ++k) {
        const int r = cr + CSTEP * k, gn = n0 + r;
        const int nb = gn < row_end ? 4 * clamp4(D - q) : 0;
        cp_async16(xd + r * ldk + q, nb ? x + static_cast<size_t>(gn) * ldx + q : x, nb);
      }
    }
    if (tid < 2 * N_ROWS) {  // y and b in 4-byte pieces: no alignment asked of them
      const int r = tid % N_ROWS, gn = n0 + r;
      const float* src = tid < N_ROWS ? y : b;
      cp_async4((tid < N_ROWS ? ys : bs) + st * N_ROWS + r, gn < row_end ? src + gn : src,
                gn < row_end ? 4 : 0);
    }
  };

  if (tiles > 0) load(0, 0);
  cp_commit();
  for (int e = tid; e < BC * dp; e += N_THREADS) {
    const int c = e / dp, d = e - c * dp, gc = c_base + c;
    zs[c * ldk + d] = gc < C && d < D ? z[static_cast<size_t>(gc) * D + d] : 0.f;
  }
  float g[NCH][4], ll[MI];
#pragma unroll
  for (int k = 0; k < NCH; ++k)
#pragma unroll
    for (int e = 0; e < 4; ++e) g[k][e] = 0.f;
#pragma unroll
  for (int i = 0; i < MI; ++i) ll[i] = 0.f;

  for (int t = 0; t < tiles; ++t) {
    const int st = t & 1;
    cp_wait<0>();
    __syncthreads();  // tile t landed and z is staged; every thread is done with tile t - 1
    if (t + 1 < tiles) load(t + 1, st ^ 1);
    cp_commit();
    const float* xt = xs + st * N_ROWS * ldk;

    float acc[MI][4];
#pragma unroll
    for (int i = 0; i < MI; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
#pragma unroll 2
    for (int k4 = 0; k4 < dp; k4 += 4) {
      float4 xv[4];
#pragma unroll
      for (int j = 0; j < 4; ++j)
        xv[j] = *reinterpret_cast<const float4*>(xt + (tx + 16 * j) * ldk + k4);
#pragma unroll
      for (int i = 0; i < MI; ++i) {
        const float4 zv = *reinterpret_cast<const float4*>(zs + (ty + 16 * i) * ldk + k4);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          acc[i][j] = fmaf(zv.x, xv[j].x, acc[i][j]);
          acc[i][j] = fmaf(zv.y, xv[j].y, acc[i][j]);
          acc[i][j] = fmaf(zv.z, xv[j].z, acc[i][j]);
          acc[i][j] = fmaf(zv.w, xv[j].w, acc[i][j]);
        }
      }
    }

    const int live = row_end - (row0 + t * N_ROWS);  // rows of the tile inside the split
    float part[MI];  // the tile's four rows of each chain, then added to ll: shorter sums
#pragma unroll
    for (int i = 0; i < MI; ++i) part[i] = 0.f;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int r = tx + 16 * j;
      const bool in = r < live;  // a masked row's X, y and b read 0: finite, then dropped
      const float yv = ys[st * N_ROWS + r], bv = bs[st * N_ROWS + r];
#pragma unroll
      for (int i = 0; i < MI; ++i) {
        float p = 0.f;
        const float res = middle_one_exp<FAMILY>(acc[i][j], yv, bv, p);
        part[i] += in ? p : 0.f;
        rs[(ty + 16 * i) * N_LDR + r] = in ? res : 0.f;
      }
    }
#pragma unroll
    for (int i = 0; i < MI; ++i) ll[i] += part[i];
    __syncthreads();  // the residual tile is whole

    if (cg < dq) {
#pragma unroll 2
      for (int n4 = 0; n4 < N_ROWS; n4 += 4) {
        float4 xv[4];
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          xv[kk] = *reinterpret_cast<const float4*>(xt + (n4 + kk) * ldk + 4 * cg);
#pragma unroll
        for (int k = 0; k < NCH; ++k) {
          const float4 rv = *reinterpret_cast<const float4*>(rs + (cr + CSTEP * k) * N_LDR + n4);
          g[k][0] = fmaf(rv.x, xv[0].x, g[k][0]);
          g[k][1] = fmaf(rv.x, xv[0].y, g[k][1]);
          g[k][2] = fmaf(rv.x, xv[0].z, g[k][2]);
          g[k][3] = fmaf(rv.x, xv[0].w, g[k][3]);
          g[k][0] = fmaf(rv.y, xv[1].x, g[k][0]);
          g[k][1] = fmaf(rv.y, xv[1].y, g[k][1]);
          g[k][2] = fmaf(rv.y, xv[1].z, g[k][2]);
          g[k][3] = fmaf(rv.y, xv[1].w, g[k][3]);
          g[k][0] = fmaf(rv.z, xv[2].x, g[k][0]);
          g[k][1] = fmaf(rv.z, xv[2].y, g[k][1]);
          g[k][2] = fmaf(rv.z, xv[2].z, g[k][2]);
          g[k][3] = fmaf(rv.z, xv[2].w, g[k][3]);
          g[k][0] = fmaf(rv.w, xv[3].x, g[k][0]);
          g[k][1] = fmaf(rv.w, xv[3].y, g[k][1]);
          g[k][2] = fmaf(rv.w, xv[3].z, g[k][2]);
          g[k][3] = fmaf(rv.w, xv[3].w, g[k][3]);
        }
      }
    }
  }
  cp_wait<0>();

  // the 16 row lanes of a chain, in a fixed order
#pragma unroll
  for (int i = 0; i < MI; ++i) {
    float v = ll[i];
#pragma unroll
    for (int off = 1; off < 16; off <<= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
    const int c = c_base + ty + 16 * i;
    if (tx == 0 && c < C) ll_part[static_cast<size_t>(c) * splits + s] = v;
  }
  const int d = 4 * cg;  // ldg is D rounded up to 4: the float4 lies in the row
  if (d < D) {
    float* gp = g_part + static_cast<size_t>(s) * C * ldg;
#pragma unroll
    for (int k = 0; k < NCH; ++k) {
      const int c = c_base + cr + CSTEP * k;
      if (c < C)
        *reinterpret_cast<float4*>(gp + static_cast<size_t>(c) * ldg + d) =
            make_float4(g[k][0], g[k][1], g[k][2], g[k][3]);
    }
  }
}

// ---- finish: fixed-order sums of the partials, prior, epilogue --------------
// ll_part holds log-likelihood partials (bernoulli_logit) or rss partials
// (normal_learned); u, c0 and n_real are read for normal_learned only.
template <int FAMILY>
__global__ void __launch_bounds__(FINISH_THREADS) finish(
    const float* __restrict__ z, const float* __restrict__ m, const float* __restrict__ iv,
    const float* __restrict__ u, const float* __restrict__ ll_part,
    const float* __restrict__ g_part, float* __restrict__ val, float* __restrict__ grad, int C,
    int D, int T, int S, int ldg, float ll_scale, float c0, float n_real) {
  __shared__ float red_q[FINISH_THREADS];
  __shared__ float red_l[FINISH_THREADS];
  __shared__ float red_s[FINISH_THREADS];
  const int c = blockIdx.x, tid = threadIdx.x;
  const float* zc = z + static_cast<size_t>(c) * D;
  float q = 0.f, ll = 0.f, su = 0.f;
  for (int d = tid; d < D; d += FINISH_THREADS) {
    const float dz = zc[d] - m[d];
    q += dz * dz * iv[d];
    if (FAMILY == NORMAL) su += zc[d] * u[d];  // the f32 z, as the TPU kernel
  }
  for (int t = tid; t < T; t += FINISH_THREADS) ll += ll_part[static_cast<size_t>(c) * T + t];
  red_q[tid] = q;
  red_l[tid] = ll;
  red_s[tid] = su;
  __syncthreads();
  for (int w = FINISH_THREADS / 2; w > 0; w >>= 1) {
    if (tid < w) {
      red_q[tid] += red_q[tid + w];
      red_l[tid] += red_l[tid + w];
      red_s[tid] += red_s[tid + w];
    }
    __syncthreads();
  }
  const float s = red_s[0] + c0;  // normal_learned: the log noise scale
  const float e2 = FAMILY == NORMAL ? expf(-2.f * s) : 1.f;
  const float g_u = e2 * red_l[0] - n_real;  // normal_learned: d ll / d s
  for (int d = tid; d < D; d += FINISH_THREADS) {
    float gs = 0.f;
    for (int k = 0; k < S; ++k) gs += g_part[(static_cast<size_t>(k) * C + c) * ldg + d];
    const float g_ll = FAMILY == NORMAL ? e2 * gs + g_u * u[d] : gs;
    grad[static_cast<size_t>(c) * D + d] = ll_scale * g_ll - (zc[d] - m[d]) * iv[d];
  }
  if (tid == 0) {
    const float v_ll = FAMILY == NORMAL ? -0.5f * e2 * red_l[0] - n_real * s : red_l[0];
    val[c] = ll_scale * v_ll - 0.5f * red_q[0];
  }
}

// ---- host side ----------------------------------------------------------------
// cuTensorMapEncodeTiled is a driver-API call; it is reached through the
// runtime's cudaGetDriverEntryPoint, so the library needs no -lcuda.
typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                  const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                  CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

inline EncodeTiledFn tensor_map_encoder() {
  static EncodeTiledFn fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                       cudaEnableDefault, &q);
#else
    cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q);
#endif
    if (err == cudaSuccess && q == cudaDriverEntryPointSuccess) fn = reinterpret_cast<EncodeTiledFn>(p);
  }
  return fn;
}

// a 2-D bf16 tensor [outer, inner] with rows row_bytes apart, read in boxes
// [box_outer, 64] with the 128-byte swizzle; out-of-bounds elements read 0
inline int encode_bf16_map(CUtensorMap* map, const void* ptr, int inner, int outer, int row_bytes,
                           int box_outer) {
  EncodeTiledFn fn = tensor_map_encoder();
  if (fn == nullptr) return static_cast<int>(cudaErrorSymbolNotFound);
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(inner), static_cast<cuuint64_t>(outer)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(row_bytes)};
  const cuuint32_t box[2] = {static_cast<cuuint32_t>(T_BK), static_cast<cuuint32_t>(box_outer)};
  const cuuint32_t elem[2] = {1, 1};
  const CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(ptr), dims,
                        strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
                        CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : static_cast<int>(cudaErrorInvalidValue);
}

inline bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15u) == 0; }

// the plan the wrapper made must be the one these tiles need
inline bool plan_ok(bool bf16, int C, int N, int D, int ldx, int ldz, int ldr, int ldg,
                    int row_tiles, int splits, int rows_per_split) {
  const int align = bf16 ? T_ALIGN : F_ALIGN;
  const int rows_a = bf16 ? T_ROWS_A : F_BN;
  const int rows_b = bf16 ? T_BK : F_BK;
  if (C <= 0 || N <= 0 || D <= 0) return false;
  if (ldx < D || ldz < D || ldr < N || ldg < D) return false;
  if (ldx % align || ldz % align || ldr % align || ldg % 4) return false;
  if (row_tiles != (N + rows_a - 1) / rows_a) return false;
  if (splits < 1 || rows_per_split <= 0 || rows_per_split % rows_b) return false;
  const long long covered = static_cast<long long>(splits) * rows_per_split;
  return covered >= N && covered - rows_per_split < N && splits <= 65535;
}

// the same for the narrow pass: no operand scratch, one partial per split
inline bool narrow_plan_ok(int C, int N, int D, int ldx, int ldg, int row_tiles, int splits,
                           int rows_per_split, int chain_tile) {
  if (C <= 0 || N <= 0 || D <= 0 || D > N_MAX_DEPTH) return false;
  if (chain_tile != 64 && chain_tile != 128) return false;
  if (ldx < D || ldg < D || ldx % F_ALIGN || ldg % 4) return false;
  if (row_tiles != splits || splits < 1 || rows_per_split <= 0 || rows_per_split % N_ROWS)
    return false;
  const long long covered = static_cast<long long>(splits) * rows_per_split;
  return covered >= N && covered - rows_per_split < N && splits <= 65535;
}

#define GLM90_CHECK(call)                               \
  do {                                                  \
    call;                                               \
    const cudaError_t e_ = cudaGetLastError();          \
    if (e_ != cudaSuccess) return static_cast<int>(e_); \
  } while (0)

// Opt a kernel in to more than 48 KB of dynamic shared memory, once per
// device (the attribute holds for the process).
#define GLM90_SMEM_ONCE(KERNEL, BYTES)                                             \
  do {                                                                             \
    static bool done_[64] = {};                                                    \
    int dev_ = 0;                                                                  \
    GLM90_CHECK(cudaGetDevice(&dev_));                                             \
    if (dev_ >= 64 || !done_[dev_]) {                                              \
      GLM90_CHECK(cudaFuncSetAttribute(KERNEL, cudaFuncAttributeMaxDynamicSharedMemorySize, \
                                       BYTES));                                    \
      if (dev_ < 64) done_[dev_] = true;                                           \
    }                                                                              \
  } while (0)

// The bf16 kernels' four tensor maps: X in pass A's boxes [128 rows, 64
// columns] and in pass B's [64, 64], the z scratch and the residual scratch
// in [64 chains, 64] boxes.  The wrapper encodes them once per X and scratch
// and keeps them.
inline int encode_maps(const void* x, int ldx, const void* zs, int ldz, const void* resid,
                       int ldr, int C, int N, int D, CUtensorMap (&maps)[4]) {
  int err = encode_bf16_map(&maps[0], x, D, N, ldx * 2, T_ROWS_A);
  if (err == 0) err = encode_bf16_map(&maps[1], x, D, N, ldx * 2, 64);
  if (err == 0) err = encode_bf16_map(&maps[2], zs, D, C, ldz * 2, T_BM);
  if (err == 0) err = encode_bf16_map(&maps[3], resid, N, C, ldr * 2, T_BM);
  return err;
}

// The narrow pass's product-2 column groups CGP for width D (f32_narrow)
inline int narrow_column_groups(int D) {
  const int dp = (D + N_DEPTH_ALIGN - 1) / N_DEPTH_ALIGN * N_DEPTH_ALIGN;
  return dp <= 16 ? 4 : 16;
}

// One launch of the narrow pass, the kernel opted in to the shared memory
// of its widest D'; or, with occupancy set, the blocks of it that one
// multiprocessor holds at width D, as the runtime counts them, to *occupancy.
template <int FAMILY, int BC, int CGP>
int narrow_cgp(const float* z, const float* x, const float* y, const float* b, float* ll_part,
               float* g_part, int C, int N, int D, int ldx, int ldg, int splits,
               int rows_per_split, cudaStream_t st, int* occupancy) {
  const auto kernel = f32_narrow<FAMILY, BC, CGP>;
  GLM90_SMEM_ONCE(kernel, narrow_smem_bytes(BC, 4 * CGP));
  const int smem = narrow_smem_bytes(BC, (D + N_DEPTH_ALIGN - 1) / N_DEPTH_ALIGN * N_DEPTH_ALIGN);
  if (occupancy != nullptr) {
    GLM90_CHECK(cudaOccupancyMaxActiveBlocksPerMultiprocessor(occupancy, kernel, N_THREADS, smem));
    return 0;
  }
  GLM90_CHECK((f32_narrow<FAMILY, BC, CGP><<<dim3((C + BC - 1) / BC, splits), N_THREADS, smem,
                                            st>>>(z, x, y, b, ll_part, g_part, C, N, D, ldx, ldg,
                                                  splits, rows_per_split)));
  return 0;
}

template <int FAMILY, int BC>
int narrow(const float* z, const float* x, const float* y, const float* b, float* ll_part,
           float* g_part, int C, int N, int D, int ldx, int ldg, int splits, int rows_per_split,
           cudaStream_t st, int* occupancy = nullptr) {
  return narrow_column_groups(D) == 4
             ? narrow_cgp<FAMILY, BC, 4>(z, x, y, b, ll_part, g_part, C, N, D, ldx, ldg, splits,
                                         rows_per_split, st, occupancy)
             : narrow_cgp<FAMILY, BC, 16>(z, x, y, b, ll_part, g_part, C, N, D, ldx, ldg,
                                          splits, rows_per_split, st, occupancy);
}

// The narrow pass's blocks a multiprocessor holds at chain tile 64 or 128
// and width D (the Bernoulli kernel; the families share tiles and launch
// bounds): out[0]
inline int narrow_occupancy(int chain_tile, int D, int* out) {
  if ((chain_tile != 64 && chain_tile != 128) || D <= 0 || D > N_MAX_DEPTH)
    return static_cast<int>(cudaErrorInvalidValue);
  return chain_tile == 64
             ? narrow<BERNOULLI, 64>(nullptr, nullptr, nullptr, nullptr, nullptr, nullptr, 1, 1, D,
                                     D, D, 1, N_ROWS, nullptr, out)
             : narrow<BERNOULLI, 128>(nullptr, nullptr, nullptr, nullptr, nullptr, nullptr, 1, 1,
                                      D, D, D, 1, N_ROWS, nullptr, out);
}

// One value+grad call: every pass, on one stream.  For bf16, maps holds the
// four tensor maps of encode_maps for these X and scratch; f32 takes none.
// u, c0 and n_real (the number of rows) are read for normal_learned only.
// chain_tile 0 runs passes 0, A and B; 64 or 128 (f32 only) runs the narrow
// pass with that chain tile instead, which takes neither z_s nor resid
// (they may be null; ldz and ldr are not read) and row_tiles equal to
// splits: one log-likelihood partial per split.
template <int FAMILY, bool BF16>
int launch(const float* z, const void* x, const void* maps, const float* y, const float* b,
           const float* m, const float* iv, const float* u, float c0, float ll_scale,
           float n_real, float* val, float* grad, void* zs, void* resid, float* ll_part,
           float* g_part, int C, int N, int D, int ldx, int ldz, int ldr, int ldg, int row_tiles,
           int splits, int rows_per_split, int chain_tile, void* stream) {
  const bool fused = chain_tile != 0;
  const bool plan = fused ? !BF16 && narrow_plan_ok(C, N, D, ldx, ldg, row_tiles, splits,
                                                    rows_per_split, chain_tile)
                          : plan_ok(BF16, C, N, D, ldx, ldz, ldr, ldg, row_tiles, splits,
                                    rows_per_split) && aligned16(zs) && aligned16(resid);
  if (!plan || !aligned16(x) || !aligned16(g_part) || (BF16 && maps == nullptr) ||
      (FAMILY == NORMAL && u == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  typedef typename std::conditional<BF16, __nv_bfloat16, float>::type OT;
  if (fused) {
    const float* xf = static_cast<const float*>(x);
    const int err = chain_tile == 64
                        ? narrow<FAMILY, 64>(z, xf, y, b, ll_part, g_part, C, N, D, ldx, ldg,
                                             splits, rows_per_split, st)
                        : narrow<FAMILY, 128>(z, xf, y, b, ll_part, g_part, C, N, D, ldx, ldg,
                                              splits, rows_per_split, st);
    if (err != 0) return err;
  } else {
    const int z_blocks = static_cast<int>(
        std::min<long long>((static_cast<long long>(C) * D + 255) / 256, 4096));
    GLM90_CHECK((stage_z<OT><<<z_blocks, 256, 0, st>>>(z, static_cast<OT*>(zs), C, D, ldz)));
    if (BF16) {
      CUtensorMap m4[4];  // X for pass A, X for pass B, z scratch, residual
      memcpy(m4, maps, sizeof(m4));
      GLM90_SMEM_ONCE(bf16_pass_a<FAMILY>, T_SMEM);
      GLM90_SMEM_ONCE(bf16_pass_b, T_SMEM);
      GLM90_CHECK((bf16_pass_a<FAMILY><<<dim3((C + T_BM - 1) / T_BM, row_tiles), T_THREADS, T_SMEM,
                                         st>>>(m4[2], m4[0], y, b,
                                               static_cast<__nv_bfloat16*>(resid), ll_part, C, N,
                                               D, ldr, row_tiles)));
      GLM90_CHECK((bf16_pass_b<<<dim3((C + T_BM - 1) / T_BM, (D + T_COLS_B - 1) / T_COLS_B, splits),
                                 T_THREADS, T_SMEM, st>>>(m4[3], m4[1], g_part, C, N, D, ldg,
                                                          rows_per_split)));
    } else {
      GLM90_SMEM_ONCE(f32_pass_a<FAMILY>, F_SMEM_A);
      GLM90_SMEM_ONCE(f32_pass_b, F_SMEM_B);
      GLM90_CHECK((f32_pass_a<FAMILY><<<dim3((C + F_BM - 1) / F_BM, row_tiles), F_THREADS, F_SMEM_A,
                                        st>>>(static_cast<const float*>(zs),
                                              static_cast<const float*>(x), y, b,
                                              static_cast<float*>(resid), ll_part, C, N, D, ldz,
                                              ldx, ldr, row_tiles)));
      GLM90_CHECK((f32_pass_b<<<dim3((C + F_BM - 1) / F_BM, (D + F_BN - 1) / F_BN, splits),
                                F_THREADS, F_SMEM_B, st>>>(static_cast<const float*>(resid),
                                                           static_cast<const float*>(x), g_part, C,
                                                           N, D, ldr, ldx, ldg, rows_per_split)));
    }
  }
  GLM90_CHECK((finish<FAMILY><<<C, FINISH_THREADS, 0, st>>>(z, m, iv, u, ll_part, g_part, val,
                                                           grad, C, D, row_tiles, splits, ldg,
                                                           ll_scale, c0, n_real)));
  return 0;
}

#undef GLM90_SMEM_ONCE
#undef GLM90_CHECK

}  // namespace glm90
