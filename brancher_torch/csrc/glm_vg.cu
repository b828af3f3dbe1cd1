// Fused GLM value + gradient, written by hand for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernels of brancher_tpu/ops/pallas_glm.py:
//   K1 _bern_kernel        (family bernoulli_logit, f32 design matrix)
//   K2 _bern_kernel_bf16   (family bernoulli_logit, bf16 design matrix)
//   K3 _normal_kernel      (family normal_learned,  f32 design matrix)
//   K4 _normal_kernel_bf16 (family normal_learned,  bf16 design matrix)
// all launched by _glm_pallas_call and built by build_glm_vg_pallas, and
//   K6 _kernel             of brancher_tpu/ops/pallas_logreg.py (family
//                          logreg: bernoulli_logit with no offset and a
//                          N(0, 1/piv) prior), launched by
//                          logreg_value_and_grad_pallas.
// K1 and K2 have their own design for this card, in
// glm_bernoulli_sm90.cuh (wgmma and TMA for K2, register-tiled f32 FMA
// with cp.async for K1); this file holds their C entries.  The template
// below serves K3, K4 and K6.
//
// What the template computes, for chains z [C,D], design X [N,D], y,
// offset b [N], a diagonal Gaussian prior (m, iv) [D] and a likelihood
// scale s_ll:
//   normal_learned:  loc = z X^T + b, s = z.u + c0, e2 = exp(-2 s),
//                    rss = sum_n (y - loc)^2
//     val  = -1/2 sum_d (z-m)^2 iv - s_ll N s + s_ll (-1/2) e2 rss
//     grad = -(z-m) iv - s_ll N u + s_ll (e2 (y - loc) X + e2 rss u)
//   logreg (K6):     l = z X^T
//     val  = sum_n (y l - softplus l) - 1/2 piv sum_d z^2
//     grad = (y - sigmoid l) X - piv z
// The bf16 variant rounds z and the residual to bf16 at the two products
// (the product of two bf16 values is exact in f32), accumulates in f32, and
// keeps softplus, sigmoid, exp and every accumulator in f32.
//
// Bound on this card.  Work is FLOPs = 4 C N D (two products through X);
// bytes are at least one read of X, N D 4 (f32) or N D 2 (bf16), plus
// C D 4 twice for z and grad.  At the repo's MXU-scale GLM shape
// (C=256, N=131072, D=1024) that is 137 GFLOP against 0.5 GB: the f32
// kernels are bound by operations, 2.05 ms at 67 TFLOP/s of CUDA-core FMA
// (against 0.16 ms for the bytes at 3.35 TB/s; TF32 tensor cores would
// change the numbers); the bf16 ones by tensor-core operations, 0.14 ms at
// 989 TFLOP/s (bytes 0.08 ms).  At the floor shape (C=1024, N=1000, D=32)
// the call is 131 MFLOP and 0.4 MB, under 2 us of either bound, so launch
// latency, not the card, bounds it.
//
// Design of the template.  The TPU kernel keeps val/grad resident in VMEM
// across a SEQUENTIAL sweep of row blocks.  Here blocks run in parallel and
// in no order, so the work is cut in two deterministic passes, no atomics:
//   pass 1, grid (chain block of BC chains) x (row split):  each block walks
//     its rows in tiles of BN.  Per tile it forms the [BC,BN] logits in
//     registers (z and X chunks staged through shared memory), applies the
//     family's elementwise middle, stages the residual in shared memory,
//     and adds resid . X_tile into its own slice of the scratch g_part
//     [S,C,D] (each element has one owning thread: a plain read-modify-
//     write, deterministic).  The per-chain log-lik (or rss) goes to
//     ll_part [S,C] after a fixed-order reduction.
//   pass 2, one block per chain: sums the S partials in a fixed order and
//     applies the prior and the family epilogue.
// Each X tile is read once per product from device memory or L2: the
// second product re-reads the tile the first one just brought through L2.
// FMAs run in f32 on the CUDA cores from 4x4 register micro-tiles.  Ragged
// edges (N not a multiple of BN, C not a multiple of BC, D not a multiple
// of BK or BD) are masked with bounds checks: no padded copy of X is made.

#include <cuda.h>
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stddef.h>
#include <stdint.h>
#include <string.h>

#include <algorithm>
#include <type_traits>

namespace {

constexpr int BC = 64;        // chains per block
constexpr int BN = 64;        // rows per tile
constexpr int BK = 16;        // depth of a first-product chunk (over D)
constexpr int BD = 64;        // width of a second-product chunk (over D)
constexpr int THREADS = 256;  // 16 x 16 threads, 4 x 4 outputs each
constexpr int RED_THREADS = 256;

constexpr int NORMAL_LEARNED = 1;
constexpr int LOGREG = 2;

template <typename XT> __device__ __forceinline__ float load_x(const XT* p);
template <> __device__ __forceinline__ float load_x<float>(const float* p) { return *p; }
template <> __device__ __forceinline__ float load_x<__nv_bfloat16>(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}

// the operand rounding of the products: none for f32, round-to-nearest-even
// to bf16 for the bf16 kernels (what astype(bfloat16) does)
template <typename XT> __device__ __forceinline__ float as_operand(float v);
template <> __device__ __forceinline__ float as_operand<float>(float v) { return v; }
template <> __device__ __forceinline__ float as_operand<__nv_bfloat16>(float v) {
  return __bfloat162float(__float2bfloat16(v));
}

// jax.nn.softplus = logaddexp(x, 0): no threshold
__device__ __forceinline__ float softplus_f(float x) {
  return fmaxf(x, 0.f) + log1pf(expf(-fabsf(x)));
}
__device__ __forceinline__ float sigmoid_f(float x) { return 1.f / (1.f + expf(-x)); }

template <int FAMILY, typename XT>
__global__ void __launch_bounds__(THREADS) glm_pass1(
    const float* __restrict__ z, const XT* __restrict__ x,
    const float* __restrict__ y, const float* __restrict__ b,
    float* __restrict__ ll_part, float* __restrict__ g_part,
    int C, int N, int D, int tiles_per_split) {
  __shared__ float zs[BK][BC + 1];
  __shared__ float xs[BK][BN + 1];
  __shared__ float rs[BN][BC + 1];
  __shared__ float xg[BN][BD];
  __shared__ float red[BC][17];

  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const int c_base = blockIdx.x * BC;
  const int split = blockIdx.y;
  const int n_tiles = (N + BN - 1) / BN;
  const int tile_begin = split * tiles_per_split;
  const int tile_end = min(tile_begin + tiles_per_split, n_tiles);
  float* g_blk = g_part + (size_t)split * C * D;

  float ll_acc[4] = {0.f, 0.f, 0.f, 0.f};

  for (int tile = tile_begin; tile < tile_end; ++tile) {
    const int r_base = tile * BN;

    // ---- first product: logits/loc [BC, BN] = z_blk . X_tile^T ----------
    float acc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

    for (int k0 = 0; k0 < D; k0 += BK) {
      for (int e = tid; e < BK * BC; e += THREADS) {
        const int k = e % BK, c = e / BK;
        const int gc = c_base + c, gk = k0 + k;
        const float v = (gc < C && gk < D) ? z[(size_t)gc * D + gk] : 0.f;
        zs[k][c] = as_operand<XT>(v);
      }
      for (int e = tid; e < BK * BN; e += THREADS) {
        const int k = e % BK, n = e / BK;
        const int gn = r_base + n, gk = k0 + k;
        xs[k][n] = (gn < N && gk < D) ? load_x<XT>(x + (size_t)gn * D + gk) : 0.f;
      }
      __syncthreads();
#pragma unroll
      for (int k = 0; k < BK; ++k) {
        float a[4], bb[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) a[i] = zs[k][ty + 16 * i];
#pragma unroll
        for (int j = 0; j < 4; ++j) bb[j] = xs[k][tx + 16 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], bb[j], acc[i][j]);
      }
      __syncthreads();
    }

    // ---- elementwise middle: residual and log-lik (or rss) --------------
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int c = ty + 16 * i;
      const bool chain_ok = c_base + c < C;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int n = tx + 16 * j;
        const int gn = r_base + n;
        float r = 0.f;
        if (chain_ok && gn < N) {
          const float yv = y[gn];
          const float l = (FAMILY == LOGREG) ? acc[i][j] : acc[i][j] + b[gn];
          if (FAMILY != NORMAL_LEARNED) {
            ll_acc[i] += yv * l - softplus_f(l);
            r = yv - sigmoid_f(l);
          } else {
            r = yv - l;
            ll_acc[i] += r * r;
          }
        }
        rs[n][c] = as_operand<XT>(r);
      }
    }
    __syncthreads();

    // ---- second product: g_part[split, c, :] += resid . X_tile -----------
    for (int d0 = 0; d0 < D; d0 += BD) {
      for (int e = tid; e < BN * BD; e += THREADS) {
        const int d = e % BD, n = e / BD;
        const int gn = r_base + n, gd = d0 + d;
        xg[n][d] = (gn < N && gd < D) ? load_x<XT>(x + (size_t)gn * D + gd) : 0.f;
      }
      __syncthreads();
      float out[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) out[i][j] = 0.f;
#pragma unroll 8
      for (int n = 0; n < BN; ++n) {
        float a[4], bb[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) a[i] = rs[n][ty + 16 * i];
#pragma unroll
        for (int j = 0; j < 4; ++j) bb[j] = xg[n][tx + 16 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) out[i][j] = fmaf(a[i], bb[j], out[i][j]);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int gc = c_base + ty + 16 * i;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int gd = d0 + tx + 16 * j;
          if (gc < C && gd < D) {
            float* p = g_blk + (size_t)gc * D + gd;
            *p = (tile == tile_begin) ? out[i][j] : *p + out[i][j];
          }
        }
      }
      __syncthreads();
    }
  }

  // ---- per-chain log-lik: fixed-order reduction over the 16 tx lanes ----
#pragma unroll
  for (int i = 0; i < 4; ++i) red[ty + 16 * i][tx] = ll_acc[i];
  __syncthreads();
  if (tid < BC) {
    float s = 0.f;
#pragma unroll
    for (int t = 0; t < 16; ++t) s += red[tid][t];
    const int gc = c_base + tid;
    if (gc < C) ll_part[(size_t)split * C + gc] = s;
  }
}

template <int FAMILY>
__global__ void __launch_bounds__(RED_THREADS) glm_pass2(
    const float* __restrict__ z, const float* __restrict__ m,
    const float* __restrict__ iv, const float* __restrict__ u,
    const float* __restrict__ ll_part, const float* __restrict__ g_part,
    float* __restrict__ val, float* __restrict__ grad,
    int C, int D, int S, float ll_scale, float c0, float n_real, float prior_iv) {
  __shared__ float red_q[RED_THREADS];
  __shared__ float red_s[RED_THREADS];
  const int c = blockIdx.x;
  const int tid = threadIdx.x;
  const float* zc = z + (size_t)c * D;

  float q = 0.f, su = 0.f;
  for (int d = tid; d < D; d += RED_THREADS) {
    if (FAMILY == LOGREG) {
      q += zc[d] * zc[d];
    } else {
      const float dz = zc[d] - m[d];
      q += dz * dz * iv[d];
    }
    if (FAMILY == NORMAL_LEARNED) su += zc[d] * u[d];
  }
  red_q[tid] = q;
  red_s[tid] = su;
  __syncthreads();
  for (int w = RED_THREADS / 2; w > 0; w >>= 1) {
    if (tid < w) {
      red_q[tid] += red_q[tid + w];
      red_s[tid] += red_s[tid + w];
    }
    __syncthreads();
  }
  q = red_q[0];
  const float s = red_s[0] + c0;

  float ll = 0.f;  // log-lik (bernoulli) or rss (normal), fixed order
  for (int k = 0; k < S; ++k) ll += ll_part[(size_t)k * C + c];
  const float e2 = (FAMILY == NORMAL_LEARNED) ? expf(-2.f * s) : 1.f;

  for (int d = tid; d < D; d += RED_THREADS) {
    float gs = 0.f;
    for (int k = 0; k < S; ++k) gs += g_part[((size_t)k * C + c) * D + d];
    float g;
    if (FAMILY == LOGREG) {
      g = gs - prior_iv * zc[d];
    } else {
      const float dz = zc[d] - m[d];
      g = -dz * iv[d] - (ll_scale * n_real) * u[d] + ll_scale * (e2 * gs + (e2 * ll) * u[d]);
    }
    grad[(size_t)c * D + d] = g;
  }
  if (tid == 0) {
    if (FAMILY == LOGREG) {
      val[c] = ll - 0.5f * prior_iv * q;
    } else {
      val[c] = (-0.5f * q - ll_scale * n_real * s) + ll_scale * (-0.5f) * e2 * ll;
    }
  }
}

template <int FAMILY, typename XT>
int launch(const float* z, const void* x, const float* y, const float* b,
           const float* m, const float* iv, const float* u, float c0,
           float ll_scale, float n_real, float prior_iv, float* val, float* grad,
           float* ll_part, float* g_part, int C, int N, int D, int S,
           int tiles_per_split, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  dim3 grid1((C + BC - 1) / BC, S);
  glm_pass1<FAMILY, XT><<<grid1, THREADS, 0, st>>>(
      z, static_cast<const XT*>(x), y, b, ll_part, g_part, C, N, D, tiles_per_split);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  glm_pass2<FAMILY><<<C, RED_THREADS, 0, st>>>(
      z, m, iv, u, ll_part, g_part, val, grad, C, D, S, ll_scale, c0, n_real, prior_iv);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

#include "glm_bernoulli_sm90.cuh"

#define GLM_ENTRY(NAME, FAMILY, XT)                                               \
  extern "C" int NAME(const float* z, const void* x, const float* y,             \
                      const float* b, const float* m, const float* iv,           \
                      const float* u, float c0, float ll_scale, float n_real,    \
                      float* val, float* grad, float* ll_part, float* g_part,    \
                      int C, int N, int D, int S, int tiles_per_split,           \
                      void* stream) {                                            \
    return launch<FAMILY, XT>(z, x, y, b, m, iv, u, c0, ll_scale, n_real, 0.f,   \
                              val, grad, ll_part, g_part, C, N, D, S,            \
                              tiles_per_split, stream);                          \
  }

// K1 and K2 (glm_bernoulli_sm90.cuh): z [C,D]; X [N,D] with rows ldx
// elements apart (16-byte aligned); the scratch z_s [C,ldz] and resid
// [C,ldr] in the operand type, ll_part [C,row_tiles] and g_part
// [splits,C,ldg] in f32, as ops/glm.py plan_bernoulli lays them out
#define BERN_ENTRY(NAME, BF16)                                                     \
  extern "C" int NAME(const float* z, const void* x, const void* maps,            \
                      const float* y, const float* b, const float* m,              \
                      const float* iv, float ll_scale, float* val, float* grad,    \
                      void* z_s, void* resid, float* ll_part, float* g_part,       \
                      int C, int N, int D, int ldx, int ldz, int ldr, int ldg,     \
                      int row_tiles, int splits, int rows_per_split,               \
                      void* stream) {                                              \
    return bern::launch<BF16>(z, x, maps, y, b, m, iv, ll_scale, val, grad, z_s,   \
                              resid, ll_part, g_part, C, N, D, ldx, ldz, ldr, ldg, \
                              row_tiles, splits, rows_per_split, stream);          \
  }

BERN_ENTRY(glm_vg_bernoulli_f32, false)
BERN_ENTRY(glm_vg_bernoulli_bf16, true)
GLM_ENTRY(glm_vg_normal_f32, NORMAL_LEARNED, float)
GLM_ENTRY(glm_vg_normal_bf16, NORMAL_LEARNED, __nv_bfloat16)

// K6: no offset, no mask, prior N(0, 1/prior_iv); its own symbol, so that
// its launches are counted apart from K1's
extern "C" int logreg_vg_f32(const float* z, const float* x, const float* y,
                             float prior_iv, float* val, float* grad,
                             float* ll_part, float* g_part, int C, int N, int D,
                             int S, int tiles_per_split, void* stream) {
  return launch<LOGREG, float>(z, x, y, nullptr, nullptr, nullptr, nullptr, 0.f,
                               1.f, static_cast<float>(N), prior_iv, val, grad,
                               ll_part, g_part, C, N, D, S, tiles_per_split, stream);
}

// tile sizes, read by the wrapper to cut the rows into splits
extern "C" int glm_vg_block_chains() { return BC; }
extern "C" int glm_vg_block_rows() { return BN; }

// K1/K2 tiles (chains and rows of pass A, chains, columns and depth of
// pass B, the row alignment in elements, and the blocks one SM holds),
// which the wrapper's planner must match: out[7]
extern "C" int glm_bern_tiles(int bf16, int* out) {
  const int t[2][7] = {
      {bern::F_BM, bern::F_BN, bern::F_BM, bern::F_BN, bern::F_BK, bern::F_ALIGN,
       bern::F_BLOCKS_PER_SM},
      {bern::T_BM, bern::T_ROWS_A, bern::T_BM, bern::T_COLS_B, bern::T_BK, bern::T_ALIGN,
       bern::T_BLOCKS_PER_SM}};
  for (int i = 0; i < 7; ++i) out[i] = t[bf16 ? 1 : 0][i];
  return 0;
}

// K2's four tensor maps (bern::encode_maps) of a bf16 X [N,D] with rows
// ldx elements apart and of the scratch z_s [C,ldz] and resid [C,ldr]:
// 4 x 128 bytes to out.
extern "C" int glm_bern_encode_maps(const void* x, int ldx, const void* z_s, int ldz,
                                    const void* resid, int ldr, int C, int N, int D, void* out) {
  if (!bern::aligned16(x) || !bern::aligned16(z_s) || !bern::aligned16(resid) || C <= 0 ||
      N <= 0 || D <= 0 || ldx < D || ldz < D || ldr < N || ldx % bern::T_ALIGN ||
      ldz % bern::T_ALIGN || ldr % bern::T_ALIGN)
    return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap maps[4];
  const int err = bern::encode_maps(x, ldx, z_s, ldz, resid, ldr, C, N, D, maps);
  if (err == 0) memcpy(out, maps, sizeof(maps));
  return err;
}
