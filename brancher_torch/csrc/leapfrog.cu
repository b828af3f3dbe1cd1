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
// Design.  Chains never interact along a trajectory, so one launch runs it
// all and blocks never meet.  The TPU kernel keeps X resident in VMEM; here
// each block copies the whole of X once into its shared memory (rows padded
// to the odd stride D | 1, so that lanes walking rows and lanes walking
// columns both hit distinct banks) and every step reads it there.  A block
// takes G chains (1, 2, 4 or 8) and up to 16 warps, so that each X value
// read from shared memory feeds G FMAs and enough warps hide the latency of
// the sums.  The chains' z stays in shared memory across steps, r and g too
// where they fit (else in the outputs).  Per step:
//   kick, drift   threads over the block's (chain, column) elements;
//   per row tile  (T rows; one tile at the floor shape)
//     product 1   each thread takes two rows at a time: the 2 G logits, each
//                 X value feeding G FMAs, z read as 16-byte broadcasts (one
//                 load serves four depth steps of both rows); the family's
//                 middle; the residuals [G][T] to shared memory and the
//                 log-lik (or rss) terms to registers;
//     product 2   warps take (row slice, 32-column chunk) items; a lane holds
//                 the G sums of its column over the slice's rows in
//                 registers, the residuals read as 16-byte broadcasts (four
//                 rows a load), and adds them to the slice's partial
//                 gradient [S][G][D] (r and g's row when S = 1);
//   reductions    the log-lik by warp butterflies, then over warps; the prior
//                 and z.u by one warp per chain;
//   epilogue      threads over the elements: the slices' partials summed,
//                 the family's epilogue, the second half kick.
// Every sum runs in a fixed order, so two launches give identical bits.
// Three __syncthreads per step at one tile, two more for each further tile.
// Products are f32 FMAs on the CUDA cores: the limit against the plain
// version sits below what TF32 products give.  ops/leapfrog.py plan_leapfrog
// chooses G, the warps, T, S and where r and g live from what X leaves of
// the shared memory; the launch recomputes the layout and refuses a plan
// that does not fit it.

#include <cuda_runtime.h>
#include <stddef.h>

namespace {

constexpr int WARP = 32;
constexpr int MAX_WARPS = 16;
constexpr int BERNOULLI_LOGIT = 0;
constexpr int NORMAL_LEARNED = 1;

// xor butterfly: a + b == b + a exactly, so every lane ends with the same bits
__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = WARP / 2; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__host__ __device__ __forceinline__ long long round4(long long v) { return (v + 3) / 4 * 4; }

// A block's shared memory, in floats.  Every region but X (the last) starts
// 16 bytes aligned.  ops/leapfrog.py leapfrog_layout_floats mirrors it.
struct Layout {
  long long ldz, ldres, zs, res, part, rs, gs, red, xs, total;
};

__host__ __device__ __forceinline__ Layout layout(int G, int W, int N, int D, int T, int S,
                                                  int state_in_smem) {
  Layout L;
  L.ldz = round4(D);
  L.ldres = round4(T);
  long long off = 0;
  L.zs = off;   off += G * L.ldz;                                      // z [G][ldz]
  L.res = off;  off += G * L.ldres;                                    // residuals [G][ldres]
  L.part = off; off += S > 1 ? round4(static_cast<long long>(S) * G * D) : 0;  // [S][G][D]
  L.rs = off;   off += state_in_smem ? round4(static_cast<long long>(G) * D) : 0;
  L.gs = off;   off += state_in_smem ? round4(static_cast<long long>(G) * D) : 0;
  L.red = off;  off += round4(static_cast<long long>(W) * G + 2 * G); // [W][G], q [G], z.u [G]
  L.xs = off;   off += static_cast<long long>(N) * (D | 1);           // X [N][D | 1]
  L.total = off;
  return L;
}

// The family's middle for one element: l = z.x_n + b_n, y_n.  Adds its
// log-lik (or rss) term to part and returns the residual.
template <int FAMILY>
__device__ __forceinline__ float middle(float l, float yv, float& part) {
  if (FAMILY == BERNOULLI_LOGIT) {
    // softplus = logaddexp(l, 0) with no threshold, as jax.nn.softplus;
    // sigmoid from the same exp(-|l|)
    const float e = expf(-fabsf(l));
    part += yv * l - (fmaxf(l, 0.f) + log1pf(e));
    const float inv = 1.f / (1.f + e);
    return yv - (l >= 0.f ? inv : e * inv);
  }
  const float r = yv - l;
  part += r * r;
  return r;
}

template <int FAMILY, int G>
__global__ void __launch_bounds__(MAX_WARPS * WARP, 1) leapfrog_kernel(
    const float* __restrict__ z_in, const float* __restrict__ r_in,
    const float* __restrict__ g_in, const float* __restrict__ x,
    const float* __restrict__ y, const float* __restrict__ b,
    const float* __restrict__ m, const float* __restrict__ iv,
    const float* __restrict__ im, const float* __restrict__ u,
    const float* __restrict__ eps_p, const int* __restrict__ n_steps_p,
    float c0, float ll_scale, float n_real,
    float* __restrict__ z_out, float* __restrict__ r_out,
    float* __restrict__ val_out, float* __restrict__ g_out,
    int C, int N, int D, int T, int S, int state_in_smem) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int tid = threadIdx.x, nthreads = blockDim.x;
  const int W = nthreads / WARP, w = tid / WARP, lane = tid % WARP;
  const Layout L = layout(G, W, N, D, T, S, state_in_smem);
  const int ldz = static_cast<int>(L.ldz), ldres = static_cast<int>(L.ldres), ldx = D | 1;
  float* zs = smem + L.zs;
  float* res = smem + L.res;
  float* red_ll = smem + L.red;  // [W][G]
  float* red_q = red_ll + W * G;
  float* red_s = red_q + G;
  float* xs = smem + L.xs;
  const int c_base = blockIdx.x * G;
  const int gv = min(G, C - c_base);  // this block's chains
  const int nel = gv * D;             // and their (chain, column) elements
  const size_t off = static_cast<size_t>(c_base) * D;
  // r and g [gv][D]: in shared memory, or in the outputs from the start
  float* rw = state_in_smem ? smem + L.rs : r_out + off;
  float* gw = state_in_smem ? smem + L.gs : g_out + off;
  float* part = S > 1 ? smem + L.part : gw;  // [S][G][D]; S = 1: g's rows

  for (int e = tid; e < N * D; e += nthreads) xs[(e / D) * ldx + e % D] = x[e];
  for (int e = tid; e < G * ldz; e += nthreads) {
    const int g = e / ldz, d = e % ldz;
    zs[e] = (g < gv && d < D) ? z_in[off + static_cast<size_t>(g) * D + d] : 0.f;
  }
  for (int e = tid; e < nel; e += nthreads) {
    rw[e] = r_in[off + e];
    gw[e] = g_in[off + e];
  }
  if (tid < gv) val_out[c_base + tid] = 0.f;
  const float eps = *eps_p;
  const int n_steps = *n_steps_p;
  const int dc = (D + WARP - 1) / WARP;  // 32-column chunks of product 2
  __syncthreads();

  for (int step = 0; step < n_steps; ++step) {
    // ---- first half kick and drift ---------------------------------------
    for (int e = tid; e < nel; e += nthreads) {
      const int g = e / D, d = e % D;
      const float rk = rw[e] + 0.5f * eps * gw[e];
      rw[e] = rk;
      zs[g * ldz + d] = zs[g * ldz + d] + eps * im[d] * rk;
    }
    __syncthreads();

    float ll[G];  // this thread's log-lik (or rss) terms, per chain
#pragma unroll
    for (int g = 0; g < G; ++g) ll[g] = 0.f;
    for (int t0 = 0; t0 < N; t0 += T) {
      const int rows = min(T, N - t0);
      // ---- product 1 and the middle: rows i and i + nthreads ------------
      for (int i = tid; i < rows; i += 2 * nthreads) {
        const bool two = i + nthreads < rows;
        const float* xa = xs + (t0 + i) * ldx;
        const float* xb = two ? xa + nthreads * ldx : xa;
        float acc[2][G];
#pragma unroll
        for (int g = 0; g < G; ++g) acc[0][g] = acc[1][g] = 0.f;
        int d = 0;
        for (; d + 4 <= D; d += 4) {
          const float a0 = xa[d], a1 = xa[d + 1], a2 = xa[d + 2], a3 = xa[d + 3];
          const float b0 = xb[d], b1 = xb[d + 1], b2 = xb[d + 2], b3 = xb[d + 3];
#pragma unroll
          for (int g = 0; g < G; ++g) {
            const float4 zv = *reinterpret_cast<const float4*>(zs + g * ldz + d);
            acc[0][g] = fmaf(zv.x, a0, acc[0][g]);
            acc[1][g] = fmaf(zv.x, b0, acc[1][g]);
            acc[0][g] = fmaf(zv.y, a1, acc[0][g]);
            acc[1][g] = fmaf(zv.y, b1, acc[1][g]);
            acc[0][g] = fmaf(zv.z, a2, acc[0][g]);
            acc[1][g] = fmaf(zv.z, b2, acc[1][g]);
            acc[0][g] = fmaf(zv.w, a3, acc[0][g]);
            acc[1][g] = fmaf(zv.w, b3, acc[1][g]);
          }
        }
        for (; d < D; ++d) {
          const float av = xa[d], bv = xb[d];
#pragma unroll
          for (int g = 0; g < G; ++g) {
            acc[0][g] = fmaf(zs[g * ldz + d], av, acc[0][g]);
            acc[1][g] = fmaf(zs[g * ldz + d], bv, acc[1][g]);
          }
        }
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          if (h == 1 && !two) break;
          const int ih = i + h * nthreads, n = t0 + ih;
          const float yv = y[n], bn = b[n];
#pragma unroll
          for (int g = 0; g < G; ++g) res[g * ldres + ih] = middle<FAMILY>(acc[h][g] + bn, yv, ll[g]);
        }
      }
      __syncthreads();

      // ---- product 2: partial[s][g][d] (+)= resid[g, rows of s] X[rows of s, d]
      const int rps = static_cast<int>(round4((rows + S - 1) / S));  // whole float4s
      for (int it = w; it < S * dc; it += W) {
        const int s = it / dc, d = (it % dc) * WARP + lane;
        if (d >= D) continue;
        const int i0 = min(s * rps, rows), i1 = min(i0 + rps, rows);
        const float* xc = xs + t0 * ldx + d;
        float acc[G];
#pragma unroll
        for (int g = 0; g < G; ++g) acc[g] = 0.f;
        int i = i0;
        for (; i + 4 <= i1; i += 4) {
          const float x0 = xc[i * ldx], x1 = xc[(i + 1) * ldx];
          const float x2 = xc[(i + 2) * ldx], x3 = xc[(i + 3) * ldx];
#pragma unroll
          for (int g = 0; g < G; ++g) {
            const float4 rv = *reinterpret_cast<const float4*>(res + g * ldres + i);
            acc[g] = fmaf(rv.x, x0, acc[g]);
            acc[g] = fmaf(rv.y, x1, acc[g]);
            acc[g] = fmaf(rv.z, x2, acc[g]);
            acc[g] = fmaf(rv.w, x3, acc[g]);
          }
        }
        for (; i < i1; ++i) {
          const float xv = xc[i * ldx];
#pragma unroll
          for (int g = 0; g < G; ++g) acc[g] = fmaf(res[g * ldres + i], xv, acc[g]);
        }
        float* p = part + static_cast<size_t>(s) * G * D + d;
#pragma unroll
        for (int g = 0; g < G; ++g)
          if (g < gv) p[g * D] = t0 == 0 ? acc[g] : p[g * D] + acc[g];
      }
      if (t0 + T < N) __syncthreads();  // the next tile's residuals overwrite these
    }

    // ---- reductions: log-lik (or rss) over threads, prior and z.u --------
#pragma unroll
    for (int g = 0; g < G; ++g) {
      const float v = warp_sum(ll[g]);
      if (lane == 0) red_ll[w * G + g] = v;
    }
    for (int g = w; g < gv; g += W) {
      float q = 0.f, su = 0.f;
      for (int d = lane; d < D; d += WARP) {
        const float zv = zs[g * ldz + d];
        const float dz = zv - m[d];
        q += dz * dz * iv[d];
        if (FAMILY == NORMAL_LEARNED) su += zv * u[d];
      }
      q = warp_sum(q);
      if (FAMILY == NORMAL_LEARNED) su = warp_sum(su);
      if (lane == 0) {
        red_q[g] = q;
        red_s[g] = su;
      }
    }
    __syncthreads();

    // ---- family epilogue and second half kick ----------------------------
    for (int e = tid; e < nel; e += nthreads) {
      const int g = e / D, d = e % D;
      float llg = 0.f;
      for (int k = 0; k < W; ++k) llg += red_ll[k * G + g];
      float gsum = 0.f;
      for (int s = 0; s < S; ++s) gsum += part[(static_cast<size_t>(s) * G + g) * D + d];
      const float dz = zs[g * ldz + d] - m[d];
      float gk, val;
      if (FAMILY == BERNOULLI_LOGIT) {
        gk = ll_scale * gsum - dz * iv[d];
        val = ll_scale * llg - 0.5f * red_q[g];
      } else {
        const float s = red_s[g] + c0;
        const float e2 = expf(-2.f * s);
        gk = -dz * iv[d] - (ll_scale * n_real) * u[d] + ll_scale * (e2 * gsum + (e2 * llg) * u[d]);
        val = (-0.5f * red_q[g] - ll_scale * n_real * s) + ll_scale * (-0.5f) * e2 * llg;
      }
      gw[e] = gk;
      rw[e] = rw[e] + 0.5f * eps * gk;
      if (d == 0) val_out[c_base + g] = val;
    }
  }

  for (int e = tid; e < nel; e += nthreads) {
    z_out[off + e] = zs[(e / D) * ldz + e % D];
    if (state_in_smem) {
      r_out[off + e] = rw[e];
      g_out[off + e] = gw[e];
    }
  }
}

template <int FAMILY, int G>
int launch_g(const float* z, const float* r, const float* g, const float* x, const float* y,
             const float* b, const float* m, const float* iv, const float* im, const float* u,
             const float* eps, const int* n_steps, float c0, float ll_scale, float n_real,
             float* z_out, float* r_out, float* val_out, float* g_out, int C, int N, int D,
             int warps, int T, int S, int state_in_smem, size_t smem_bytes, cudaStream_t st) {
  // opt in to the dynamic shared memory once per device and size: the
  // largest size asked for so far covers every smaller launch
  static size_t opted[64] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev >= 64 || opted[dev] < smem_bytes) {
    err = cudaFuncSetAttribute(leapfrog_kernel<FAMILY, G>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem_bytes));
    if (err != cudaSuccess) return static_cast<int>(err);
    if (dev < 64) opted[dev] = smem_bytes;
  }
  leapfrog_kernel<FAMILY, G><<<(C + G - 1) / G, warps * WARP, smem_bytes, st>>>(
      z, r, g, x, y, b, m, iv, im, u, eps, n_steps, c0, ll_scale, n_real, z_out, r_out,
      val_out, g_out, C, N, D, T, S, state_in_smem);
  return static_cast<int>(cudaGetLastError());
}

template <int FAMILY>
int launch(const float* z, const float* r, const float* g, const float* x, const float* y,
           const float* b, const float* m, const float* iv, const float* im, const float* u,
           const float* eps, const int* n_steps, float c0, float ll_scale, float n_real,
           float* z_out, float* r_out, float* val_out, float* g_out, int C, int N, int D,
           int ldx, int chains, int warps, int T, int S, int state_in_smem, size_t smem_bytes,
           void* stream) {
  // the plan ops/leapfrog.py made must fit the layout these arguments give
  if (C <= 0 || N <= 0 || D <= 0 || ldx != (D | 1) || warps < 1 || warps > MAX_WARPS ||
      T < 4 || T % 4 || S < 1 || (FAMILY == NORMAL_LEARNED && u == nullptr) ||
      4 * layout(chains, warps, N, D, T, S, state_in_smem).total > static_cast<long long>(smem_bytes))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define K5_LAUNCH(G_)                                                                       \
  return launch_g<FAMILY, G_>(z, r, g, x, y, b, m, iv, im, u, eps, n_steps, c0, ll_scale,   \
                              n_real, z_out, r_out, val_out, g_out, C, N, D, warps, T, S,   \
                              state_in_smem, smem_bytes, st)
  switch (chains) {
    case 1: K5_LAUNCH(1);
    case 2: K5_LAUNCH(2);
    case 4: K5_LAUNCH(4);
    case 8: K5_LAUNCH(8);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef K5_LAUNCH
}

}  // namespace

// z, r, g [C,D], X [N,D] contiguous; y, b [N]; m, iv, im, u [D] (u may be
// null for bernoulli_logit); eps and n_steps on the device; the plan of
// ops/leapfrog.py plan_leapfrog: ldx = D | 1, chains per block (1, 2, 4 or
// 8), warps per block, rows per tile (a multiple of 4), row slices, whether
// r and g live in shared memory, and the block's shared-memory bytes.
#define LEAPFROG_ENTRY(NAME, FAMILY)                                                       \
  extern "C" int NAME(const float* z, const float* r, const float* g, const float* x,     \
                      const float* y, const float* b, const float* m, const float* iv,    \
                      const float* im, const float* u, const float* eps,                  \
                      const int* n_steps, float c0, float ll_scale, float n_real,         \
                      float* z_out, float* r_out, float* val_out, float* g_out, int C,    \
                      int N, int D, int ldx, int chains, int warps, int rows_per_tile,    \
                      int row_slices, int state_in_smem, size_t smem_bytes,               \
                      void* stream) {                                                     \
    return launch<FAMILY>(z, r, g, x, y, b, m, iv, im, u, eps, n_steps, c0, ll_scale,     \
                          n_real, z_out, r_out, val_out, g_out, C, N, D, ldx, chains,     \
                          warps, rows_per_tile, row_slices, state_in_smem, smem_bytes,    \
                          stream);                                                        \
  }

LEAPFROG_ENTRY(leapfrog_bernoulli_f32, BERNOULLI_LOGIT)
LEAPFROG_ENTRY(leapfrog_normal_f32, NORMAL_LEARNED)
