// Fused leapfrog trajectory of a GLM potential, written by hand for
// Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel K5 of brancher_tpu/ops/pallas_leapfrog.py:
//   _leap_kernel (launched by the closure of build_fused_leapfrog).
//
// What it computes, for chains z, r, g [C,D] (position, momentum, and the
// gradient of the log density at z), a design X [N,D], y, offset b [N], a
// diagonal Gaussian prior (m, iv) [D], a diagonal inverse mass im [D] and
// a likelihood scale s_ll, with the step size eps and the step count
// n_steps read from device memory:
//   repeat n_steps times:
//     r += eps/2 g;  z += eps im r;  (val, g) = vg(z);  r += eps/2 g
// where vg is the family's value+grad (the same arithmetic as glm_vg.cu):
//   bernoulli_logit: l = X z + b
//     val = s_ll sum_n (y l - softplus l) - 1/2 sum_d (z-m)^2 iv
//     g   = s_ll (y - sigmoid l) X - (z-m) iv
//   normal_learned: resid = y - X z - b, s = z.u + c0, e2 = exp(-2 s)
//     val = -1/2 sum_d (z-m)^2 iv - s_ll N s + s_ll (-1/2) e2 rss
//     g   = -(z-m) iv - s_ll N u + s_ll (e2 resid X + e2 rss u)
// With n_steps = 0 the outputs are the inputs and val = 0, as in JAX.
// Non-finite values are propagated, never clamped: the engines read them.
//
// Bound on this card.  One trajectory is n_steps value+grad evaluations,
// 4 C N D operations each (two products through X), on the f32 CUDA cores
// (67 TFLOP/s); the bytes are one read of X and of the [C,D] state and one
// write of it.  At the floor shape (C=1024, N=1000, D=32, 32 steps) that
// is 4.2 GFLOP against 0.4 MB: bound by operations, 63 us.
//
// Design.  Chains never interact along a trajectory, so one warp owns one
// chain for the whole launch and no block-wide or grid-wide barrier is
// needed after the start.  The TPU kernel keeps X resident in VMEM; here
// each block copies the whole of X once into shared memory (rows padded
// to an odd stride, so that lanes walking rows and lanes walking columns
// both hit distinct banks) and every step of every warp reads it there:
// device memory is read once per block, not once per step.  That sets the
// size gate in ops/leapfrog.py: X plus one warp's state must fit in the
// 227 KB of shared memory a block may opt in to.  Per step a warp
//   - kicks and drifts its chain (lanes over D, state in shared memory);
//   - sweeps N in tiles of 32 rows, one row per lane: the row's logit (a
//     D-long dot with the chain), its log-lik term and residual; the 32
//     residuals go to shared memory and the lanes, now over D, add
//     resid . X_tile into the chain's gradient accumulator;
//   - reduces the log-lik, the prior and z.u with a butterfly of warp
//     shuffles (every lane gets the same bits) and applies the epilogue
//     and the second half kick.
// Every sum runs in a fixed order, so two launches give identical bits.
// Products are f32 FMAs on the CUDA cores; tensor cores are later work.

#include <cuda_runtime.h>
#include <stddef.h>

namespace {

constexpr int WARP = 32;
constexpr int BERNOULLI_LOGIT = 0;
constexpr int NORMAL_LEARNED = 1;

// jax.nn.softplus = logaddexp(x, 0): no threshold
__device__ __forceinline__ float softplus_f(float x) {
  return fmaxf(x, 0.f) + log1pf(expf(-fabsf(x)));
}
__device__ __forceinline__ float sigmoid_f(float x) { return 1.f / (1.f + expf(-x)); }

// xor butterfly: a + b == b + a exactly, so every lane ends with the same bits
__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = WARP / 2; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

template <int FAMILY>
__global__ void leapfrog_kernel(
    const float* __restrict__ z_in, const float* __restrict__ r_in,
    const float* __restrict__ g_in, const float* __restrict__ x,
    const float* __restrict__ y, const float* __restrict__ b,
    const float* __restrict__ m, const float* __restrict__ iv,
    const float* __restrict__ im, const float* __restrict__ u,
    const float* __restrict__ eps_p, const int* __restrict__ n_steps_p,
    float c0, float ll_scale, float n_real,
    float* __restrict__ z_out, float* __restrict__ r_out,
    float* __restrict__ val_out, float* __restrict__ g_out,
    int C, int N, int D, int ldx) {
  extern __shared__ float smem[];
  const int warps = blockDim.x / WARP;
  float* xs = smem;                      // [N][ldx]
  float* zs = xs + (size_t)N * ldx;      // [warps][D] positions
  float* rs = zs + (size_t)warps * D;    // [warps][D] momenta
  float* gs = rs + (size_t)warps * D;    // [warps][D] gradients
  float* res = gs + (size_t)warps * D;   // [warps][32] residuals of a tile

  for (int e = threadIdx.x; e < N * D; e += blockDim.x) {
    xs[(size_t)(e / D) * ldx + e % D] = x[e];
  }
  const int w = threadIdx.x / WARP, lane = threadIdx.x % WARP;
  const int c = blockIdx.x * warps + w;
  float* zw = zs + (size_t)w * D;
  float* rw = rs + (size_t)w * D;
  float* gw = gs + (size_t)w * D;
  float* resw = res + w * WARP;
  if (c < C) {
    for (int k = lane; k < D; k += WARP) {
      zw[k] = z_in[(size_t)c * D + k];
      rw[k] = r_in[(size_t)c * D + k];
      gw[k] = g_in[(size_t)c * D + k];
    }
  }
  __syncthreads();  // X is in place; from here on each warp runs alone
  if (c >= C) return;

  const float eps = *eps_p;
  const int n_steps = *n_steps_p;
  float val = 0.f;
  for (int step = 0; step < n_steps; ++step) {
    // ---- first half kick and drift -----------------------------------
    for (int k = lane; k < D; k += WARP) {
      const float rk = rw[k] + 0.5f * eps * gw[k];
      rw[k] = rk;
      zw[k] = zw[k] + eps * im[k] * rk;
      gw[k] = 0.f;  // now the accumulator of resid . X
    }
    __syncwarp();

    // ---- value and gradient at the new z -----------------------------
    float ll = 0.f;  // log-lik (bernoulli) or rss (normal), this lane's rows
    for (int n0 = 0; n0 < N; n0 += WARP) {
      const int n = n0 + lane;
      float rn = 0.f;
      if (n < N) {
        const float* xr = xs + (size_t)n * ldx;
        float acc = 0.f;
        for (int k = 0; k < D; ++k) acc = fmaf(zw[k], xr[k], acc);
        const float l = acc + b[n];
        const float yv = y[n];
        if (FAMILY == BERNOULLI_LOGIT) {
          ll += yv * l - softplus_f(l);
          rn = yv - sigmoid_f(l);
        } else {
          rn = yv - l;
          ll += rn * rn;
        }
      }
      resw[lane] = rn;
      __syncwarp();
      const int rows = min(WARP, N - n0);
      for (int k = lane; k < D; k += WARP) {
        const float* xc = xs + (size_t)n0 * ldx + k;
        float s = 0.f;
        for (int j = 0; j < rows; ++j) s = fmaf(resw[j], xc[(size_t)j * ldx], s);
        gw[k] += s;
      }
      __syncwarp();
    }
    ll = warp_sum(ll);

    // ---- prior, family epilogue, second half kick ---------------------
    float q = 0.f, su = 0.f;
    for (int k = lane; k < D; k += WARP) {
      const float dz = zw[k] - m[k];
      q += dz * dz * iv[k];
      if (FAMILY == NORMAL_LEARNED) su += zw[k] * u[k];
    }
    q = warp_sum(q);
    const float s = (FAMILY == NORMAL_LEARNED) ? warp_sum(su) + c0 : 0.f;
    const float e2 = (FAMILY == NORMAL_LEARNED) ? expf(-2.f * s) : 1.f;
    for (int k = lane; k < D; k += WARP) {
      const float dz = zw[k] - m[k];
      float gk;
      if (FAMILY == BERNOULLI_LOGIT) {
        gk = ll_scale * gw[k] - dz * iv[k];
      } else {
        gk = -dz * iv[k] - (ll_scale * n_real) * u[k] + ll_scale * (e2 * gw[k] + (e2 * ll) * u[k]);
      }
      gw[k] = gk;
      rw[k] = rw[k] + 0.5f * eps * gk;
    }
    if (FAMILY == BERNOULLI_LOGIT) {
      val = ll_scale * ll - 0.5f * q;
    } else {
      val = (-0.5f * q - ll_scale * n_real * s) + ll_scale * (-0.5f) * e2 * ll;
    }
    __syncwarp();
  }

  for (int k = lane; k < D; k += WARP) {
    z_out[(size_t)c * D + k] = zw[k];
    r_out[(size_t)c * D + k] = rw[k];
    g_out[(size_t)c * D + k] = gw[k];
  }
  if (lane == 0) val_out[c] = val;
}

template <int FAMILY>
int launch(const float* z, const float* r, const float* g, const float* x,
           const float* y, const float* b, const float* m, const float* iv,
           const float* im, const float* u, const float* eps, const int* n_steps,
           float c0, float ll_scale, float n_real, float* z_out, float* r_out,
           float* val_out, float* g_out, int C, int N, int D, int ldx,
           int warps_per_block, size_t smem_bytes, void* stream) {
  cudaError_t err = cudaFuncSetAttribute(
      leapfrog_kernel<FAMILY>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem_bytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int blocks = (C + warps_per_block - 1) / warps_per_block;
  leapfrog_kernel<FAMILY><<<blocks, warps_per_block * WARP, smem_bytes,
                            static_cast<cudaStream_t>(stream)>>>(
      z, r, g, x, y, b, m, iv, im, u, eps, n_steps, c0, ll_scale, n_real,
      z_out, r_out, val_out, g_out, C, N, D, ldx);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

#define LEAPFROG_ENTRY(NAME, FAMILY)                                              \
  extern "C" int NAME(const float* z, const float* r, const float* g,            \
                      const float* x, const float* y, const float* b,            \
                      const float* m, const float* iv, const float* im,          \
                      const float* u, const float* eps, const int* n_steps,      \
                      float c0, float ll_scale, float n_real, float* z_out,      \
                      float* r_out, float* val_out, float* g_out, int C, int N,  \
                      int D, int ldx, int warps_per_block, size_t smem_bytes,    \
                      void* stream) {                                            \
    return launch<FAMILY>(z, r, g, x, y, b, m, iv, im, u, eps, n_steps, c0,      \
                          ll_scale, n_real, z_out, r_out, val_out, g_out, C, N,  \
                          D, ldx, warps_per_block, smem_bytes, stream);          \
  }

LEAPFROG_ENTRY(leapfrog_bernoulli_f32, BERNOULLI_LOGIT)
LEAPFROG_ENTRY(leapfrog_normal_f32, NORMAL_LEARNED)
