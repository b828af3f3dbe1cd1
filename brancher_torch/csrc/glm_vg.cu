// Fused GLM value + gradient, written by hand for Hopper (sm_90a).
//
// This source builds one library with every value+grad kernel:
//   K1-K4, the GLM kernels of brancher_tpu/ops/pallas_glm.py (_bern_kernel,
//     _bern_kernel_bf16, _normal_kernel, _normal_kernel_bf16, launched by
//     _glm_pallas_call): their passes are in glm_sm90.cuh (wgmma and TMA
//     for the bf16 X, register-tiled f32 FMA with cp.async for the f32 X),
//     and their C entries below;
//   K6, _kernel of brancher_tpu/ops/pallas_logreg.py (logistic regression
//     with no offset and a N(0, 1/piv) prior, launched by
//     logreg_value_and_grad_pallas): the two-pass template below, which
//     serves K6 only.
//
// What the template computes, for chains z [C,D], design X [N,D] (f32)
// and labels y [N]:
//   l = z X^T
//   val  = sum_n (y l - softplus l) - 1/2 piv sum_d z^2
//   grad = (y - sigmoid l) X - piv z
//
// Bound on this card.  Work is FLOPs = 4 C N D (two products through X);
// bytes are at least one read of X, N D 4, plus C D 4 twice for z and grad.
// At the MXU-scale shape (C=256, N=131072, D=1024) that is 137 GFLOP
// against 0.5 GB: bound by operations, 2.05 ms at 67 TFLOP/s of CUDA-core
// FMA (against 0.16 ms for the bytes at 3.35 TB/s).  At the floor shape
// (C=1024, N=1000, D=32) the call is 131 MFLOP and 0.4 MB, under 2 us of
// either bound, so launch latency, not the card, bounds it.
//
// Design of the template, the first port's: the TPU kernel keeps val/grad
// resident in VMEM across a SEQUENTIAL sweep of row blocks; here blocks run
// in parallel and in no order, so the work is cut in two deterministic
// passes, no atomics:
//   pass 1, grid (chain block of BC chains) x (row split):  each block walks
//     its rows in tiles of BN.  Per tile it forms the [BC,BN] logits in
//     registers (z and X chunks staged through shared memory), applies the
//     elementwise middle, stages the residual in shared memory, and adds
//     resid . X_tile into its own slice of the scratch g_part [S,C,D] (each
//     element has one owning thread: a plain read-modify-write,
//     deterministic).  The per-chain log-lik goes to ll_part [S,C] after a
//     fixed-order reduction.
//   pass 2, one block per chain: sums the S partials in a fixed order and
//     applies the prior.
// FMAs run in f32 on the CUDA cores from 4x4 register micro-tiles.  Ragged
// edges are masked with bounds checks.  At the MXU shape it takes about
// 11 ms (PERF.md); moving K6 onto the passes of glm_sm90.cuh is queued.

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

// jax.nn.softplus = logaddexp(x, 0): no threshold
__device__ __forceinline__ float softplus_f(float x) {
  return fmaxf(x, 0.f) + log1pf(expf(-fabsf(x)));
}
__device__ __forceinline__ float sigmoid_f(float x) { return 1.f / (1.f + expf(-x)); }

__global__ void __launch_bounds__(THREADS) logreg_pass1(
    const float* __restrict__ z, const float* __restrict__ x, const float* __restrict__ y,
    float* __restrict__ ll_part, float* __restrict__ g_part, int C, int N, int D,
    int tiles_per_split) {
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

    // ---- first product: logits [BC, BN] = z_blk . X_tile^T ---------------
    float acc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

    for (int k0 = 0; k0 < D; k0 += BK) {
      for (int e = tid; e < BK * BC; e += THREADS) {
        const int k = e % BK, c = e / BK;
        const int gc = c_base + c, gk = k0 + k;
        zs[k][c] = (gc < C && gk < D) ? z[(size_t)gc * D + gk] : 0.f;
      }
      for (int e = tid; e < BK * BN; e += THREADS) {
        const int k = e % BK, n = e / BK;
        const int gn = r_base + n, gk = k0 + k;
        xs[k][n] = (gn < N && gk < D) ? x[(size_t)gn * D + gk] : 0.f;
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

    // ---- elementwise middle: residual and log-lik -------------------------
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
          const float l = acc[i][j];
          ll_acc[i] += yv * l - softplus_f(l);
          r = yv - sigmoid_f(l);
        }
        rs[n][c] = r;
      }
    }
    __syncthreads();

    // ---- second product: g_part[split, c, :] += resid . X_tile -----------
    for (int d0 = 0; d0 < D; d0 += BD) {
      for (int e = tid; e < BN * BD; e += THREADS) {
        const int d = e % BD, n = e / BD;
        const int gn = r_base + n, gd = d0 + d;
        xg[n][d] = (gn < N && gd < D) ? x[(size_t)gn * D + gd] : 0.f;
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

__global__ void __launch_bounds__(RED_THREADS) logreg_pass2(
    const float* __restrict__ z, const float* __restrict__ ll_part,
    const float* __restrict__ g_part, float* __restrict__ val, float* __restrict__ grad, int C,
    int D, int S, float prior_iv) {
  __shared__ float red_q[RED_THREADS];
  const int c = blockIdx.x;
  const int tid = threadIdx.x;
  const float* zc = z + (size_t)c * D;

  float q = 0.f;
  for (int d = tid; d < D; d += RED_THREADS) q += zc[d] * zc[d];
  red_q[tid] = q;
  __syncthreads();
  for (int w = RED_THREADS / 2; w > 0; w >>= 1) {
    if (tid < w) red_q[tid] += red_q[tid + w];
    __syncthreads();
  }

  float ll = 0.f;  // fixed order
  for (int k = 0; k < S; ++k) ll += ll_part[(size_t)k * C + c];
  for (int d = tid; d < D; d += RED_THREADS) {
    float gs = 0.f;
    for (int k = 0; k < S; ++k) gs += g_part[((size_t)k * C + c) * D + d];
    grad[(size_t)c * D + d] = gs - prior_iv * zc[d];
  }
  if (tid == 0) val[c] = ll - 0.5f * prior_iv * red_q[0];
}

}  // namespace

#include "glm_sm90.cuh"

// K1-K4 (glm_sm90.cuh): z [C,D]; X [N,D] with rows ldx elements apart
// (16-byte aligned); the scratch z_s [C,ldz] and resid [C,ldr] in the
// operand type, ll_part [C,row_tiles] and g_part [splits,C,ldg] in f32, as
// ops/glm.py plan_glm lays them out; maps the four tensor maps of
// glm_sm90_encode_maps (bf16 only); u [D], c0 and n_real (= N) for
// normal_learned only (u may be null for bernoulli_logit).  Each kernel has
// its own symbol, so that its launches are counted apart.
#define GLM90_ENTRY(NAME, FAMILY, BF16)                                                  \
  extern "C" int NAME(const float* z, const void* x, const void* maps, const float* y,  \
                      const float* b, const float* m, const float* iv, const float* u,  \
                      float c0, float ll_scale, float n_real, float* val, float* grad,  \
                      void* z_s, void* resid, float* ll_part, float* g_part, int C, int N, \
                      int D, int ldx, int ldz, int ldr, int ldg, int row_tiles, int splits, \
                      int rows_per_split, void* stream) {                                \
    return glm90::launch<FAMILY, BF16>(z, x, maps, y, b, m, iv, u, c0, ll_scale, n_real, \
                                       val, grad, z_s, resid, ll_part, g_part, C, N, D,  \
                                       ldx, ldz, ldr, ldg, row_tiles, splits,            \
                                       rows_per_split, stream);                          \
  }

GLM90_ENTRY(glm_vg_bernoulli_f32, glm90::BERNOULLI, false)
GLM90_ENTRY(glm_vg_bernoulli_bf16, glm90::BERNOULLI, true)
GLM90_ENTRY(glm_vg_normal_f32, glm90::NORMAL, false)
GLM90_ENTRY(glm_vg_normal_bf16, glm90::NORMAL, true)

// K6: the two-pass template above
extern "C" int logreg_vg_f32(const float* z, const float* x, const float* y, float prior_iv,
                             float* val, float* grad, float* ll_part, float* g_part, int C,
                             int N, int D, int S, int tiles_per_split, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  logreg_pass1<<<dim3((C + BC - 1) / BC, S), THREADS, 0, st>>>(z, x, y, ll_part, g_part, C, N,
                                                               D, tiles_per_split);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  logreg_pass2<<<C, RED_THREADS, 0, st>>>(z, ll_part, g_part, val, grad, C, D, S, prior_iv);
  return static_cast<int>(cudaGetLastError());
}

// K6's tile sizes, read by its wrapper to cut the rows into splits
extern "C" int glm_vg_block_chains() { return BC; }
extern "C" int glm_vg_block_rows() { return BN; }

// K1-K4's tiles (chains and rows of pass A, chains, columns and depth of
// pass B, the row alignment in elements, and the blocks one SM holds),
// which the wrapper's planner must match: out[7]
extern "C" int glm_sm90_tiles(int bf16, int* out) {
  const int t[2][7] = {
      {glm90::F_BM, glm90::F_BN, glm90::F_BM, glm90::F_BN, glm90::F_BK, glm90::F_ALIGN,
       glm90::F_BLOCKS_PER_SM},
      {glm90::T_BM, glm90::T_ROWS_A, glm90::T_BM, glm90::T_COLS_B, glm90::T_BK, glm90::T_ALIGN,
       glm90::T_BLOCKS_PER_SM}};
  for (int i = 0; i < 7; ++i) out[i] = t[bf16 ? 1 : 0][i];
  return 0;
}

// The bf16 kernels' four tensor maps (glm90::encode_maps) of a bf16 X [N,D]
// with rows ldx elements apart and of the scratch z_s [C,ldz] and resid
// [C,ldr]: 4 x 128 bytes to out.
extern "C" int glm_sm90_encode_maps(const void* x, int ldx, const void* z_s, int ldz,
                                    const void* resid, int ldr, int C, int N, int D, void* out) {
  if (!glm90::aligned16(x) || !glm90::aligned16(z_s) || !glm90::aligned16(resid) || C <= 0 ||
      N <= 0 || D <= 0 || ldx < D || ldz < D || ldr < N || ldx % glm90::T_ALIGN ||
      ldz % glm90::T_ALIGN || ldr % glm90::T_ALIGN)
    return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap maps[4];
  const int err = glm90::encode_maps(x, ldx, z_s, ldz, resid, ldr, C, N, D, maps);
  if (err == 0) memcpy(out, maps, sizeof(maps));
  return err;
}
