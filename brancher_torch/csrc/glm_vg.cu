// Fused GLM value + gradient, written by hand for Hopper (sm_90a): the C
// entries of one family of passes.
//
// The passes are in glm_sm90.cuh (four launches per call, two for the f32
// narrow pass; no atomics, every sum in a fixed order; wgmma fed by TMA for
// a bf16 X, register-tiled f32 FMA fed by cp.async for an f32 X).  This source defines the elementwise
// helpers they use and one C entry per TPU kernel, each with its own symbol
// so that its launches are counted apart:
//   K1-K4, the GLM kernels of brancher_tpu/ops/pallas_glm.py (_bern_kernel,
//     _bern_kernel_bf16, _normal_kernel, _normal_kernel_bf16, launched by
//     _glm_pallas_call);
//   K6, _kernel of brancher_tpu/ops/pallas_logreg.py (logistic regression
//     over the whole X with no offset and a N(0, sigma^2) prior, launched by
//     logreg_value_and_grad_pallas): K1's f32 Bernoulli passes, given b = 0,
//     m = 0, iv = 1/sigma^2 on every coordinate and ll_scale = 1 by its
//     wrapper (ops/logreg.py).
// Bounds on this card and the design of the passes: glm_sm90.cuh.

#include <cuda.h>
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stddef.h>
#include <stdint.h>
#include <string.h>

#include <algorithm>
#include <type_traits>

namespace {

// jax.nn.softplus = logaddexp(x, 0): no threshold
__device__ __forceinline__ float softplus_f(float x) {
  return fmaxf(x, 0.f) + log1pf(expf(-fabsf(x)));
}
__device__ __forceinline__ float sigmoid_f(float x) { return 1.f / (1.f + expf(-x)); }

}  // namespace

#include "glm_sm90.cuh"

// K1-K4 (glm_sm90.cuh): z [C,D]; X [N,D] with rows ldx elements apart
// (16-byte aligned); the scratch z_s [C,ldz] and resid [C,ldr] in the
// operand type, ll_part [C,row_tiles] and g_part [splits,C,ldg] in f32, as
// ops/glm.py plan_glm lays them out; maps the four tensor maps of
// glm_sm90_encode_maps (bf16 only); u [D], c0 and n_real (= N) for
// normal_learned only (u may be null for bernoulli_logit).  chain_tile 0
// runs passes 0, A and B; 64 or 128 the f32 narrow pass, which takes no
// z_s or resid.  Each kernel has its own symbol, so that its launches are
// counted apart.
#define GLM90_ENTRY(NAME, FAMILY, BF16)                                                  \
  extern "C" int NAME(const float* z, const void* x, const void* maps, const float* y,  \
                      const float* b, const float* m, const float* iv, const float* u,  \
                      float c0, float ll_scale, float n_real, float* val, float* grad,  \
                      void* z_s, void* resid, float* ll_part, float* g_part, int C, int N, \
                      int D, int ldx, int ldz, int ldr, int ldg, int row_tiles, int splits, \
                      int rows_per_split, int chain_tile, void* stream) {                \
    return glm90::launch<FAMILY, BF16>(z, x, maps, y, b, m, iv, u, c0, ll_scale, n_real, \
                                       val, grad, z_s, resid, ll_part, g_part, C, N, D,  \
                                       ldx, ldz, ldr, ldg, row_tiles, splits,            \
                                       rows_per_split, chain_tile, stream);              \
  }

GLM90_ENTRY(glm_vg_bernoulli_f32, glm90::BERNOULLI, false)
GLM90_ENTRY(glm_vg_bernoulli_bf16, glm90::BERNOULLI, true)
GLM90_ENTRY(glm_vg_normal_f32, glm90::NORMAL, false)
GLM90_ENTRY(glm_vg_normal_bf16, glm90::NORMAL, true)
// K6: K1's passes with b = 0, m = 0, iv = 1/sigma^2 and ll_scale = 1 (ops/logreg.py)
GLM90_ENTRY(logreg_vg_f32, glm90::BERNOULLI, false)

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

// The f32 narrow pass's tiles (rows a tile, the alignment of its staged
// width, the widest D it takes, threads a block, blocks one SM holds),
// which the planner must match: out[5]
extern "C" int glm_sm90_narrow_tiles(int* out) {
  const int t[5] = {glm90::N_ROWS, glm90::N_DEPTH_ALIGN, glm90::N_MAX_DEPTH, glm90::N_THREADS,
                    glm90::N_BLOCKS_PER_SM};
  for (int i = 0; i < 5; ++i) out[i] = t[i];
  return 0;
}

// The narrow pass's blocks that one multiprocessor of the current device
// holds at chain tile 64 or 128 and width D, as the runtime counts them
// (registers and shared memory): out[0]
extern "C" int glm_sm90_narrow_blocks(int chain_tile, int D, int* out) {
  return glm90::narrow_occupancy(chain_tile, D, out);
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
