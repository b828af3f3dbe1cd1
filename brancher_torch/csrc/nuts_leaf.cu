// The lockstep NUTS leaf's bookkeeping, written by hand for Hopper (sm_90a):
// K7, a head and a tail kernel around the potential.
//
// Replaces no Pallas kernel.  The JAX package's leaf is the body of the
// while_loop in brancher_tpu/inference/vectorized_nuts.py
// (nuts_transition_batched), which XLA fuses on the TPU.  The port's plain
// leaf (_NutsTree.plain_leaf in inference/vectorized_nuts.py) is about 90
// PyTorch ops: each a launch, and at width each a pass over a [C, d] tensor
// in device memory.  The U-turn dots alone build a [kdim, C, d] tensor
// several times a leaf, of which the schedule reads one or two rows.
//
// What it computes: _NutsTree.plain_leaf, for the chains of the tree's
// buffers, with leaf n's schedule row read per chain from flags and slot at
// n[i * n_stride] (n is [1] for the lockstep engine, [C] for the pipelined
// one).  The potential sits between the two kernels:
//   head  a subtree's start: the direction from dir_pos, the moving end
//         from ends, s_lw = -inf, s_cum = 0, s_failed = false; then the
//         half kick and the drift from the moving end into z_new, the
//         potential's input; the schedule row of each chain into row;
//   tail  the second half kick, the energy (NaN read as +inf), the
//         divergence, the accept sums, the checkpoint row slot[n] (the
//         spare row of odd leaves is not written: nothing reads it), the
//         progressive swap, the U-turn dots over the checkpoint rows the
//         schedule flags, the subtree's update, its merge into the tree at
//         its end, the full-tree U-turn, active, and n + 1.
// A stopped chain (active false) reads its row and advances n; a failed one
// deactivates at its subtree's end; neither writes anything else.  The
// plain leaf writes their checkpoint rows and, at a subtree's start, their
// moving end and subtree sums; every one of those is written again, by the
// chain's next start and first leaf, before anything reads it.
//
// The same mathematics at the same precision: arithmetic in the tree's
// dtype (float or double), every product and sum rounded on its own
// (__fmul_rn, __fadd_rn: no contraction into an FMA), so each elementwise
// value is the plain leaf's bit for bit; the accurate expf and log1pf.  The
// sums (the kinetic energy and the dots) run in a fixed order with no
// atomics, so two launches give identical bits; the order is not
// torch.sum's, so those sums differ from the plain leaf's in their last
// bits.
//
// Bound on this card: bytes.  A leaf at C = 1024, d = 3002 in f32 reads the
// moving end, the gradient, s_cum and z_new and writes the drift, the
// moving end, s_cum and an even leaf's checkpoint pair: 12 to 16 passes
// over 12.3 MB, 45-60 us at 3.35 TB/s.  At C = 64, d = 55 a pass is 14 KB
// and the leaf is bound by its two launches.
//
// Design.  The head is elementwise: a block per (chain, up to 1024
// columns), four columns a thread.  The tail gives each chain G threads (a
// warp when d <= 256, four chains a block, two columns a thread; a block of
// 256 threads when d is wider, two blocks an SM in float, 12 columns a
// thread): a chunk of G VPT columns, 64 or 3072, held in registers from the
// reduction phase to the write phase.  A wider chain takes its chunks in
// turn and re-reads them, from L2, in the write phase.  Every per-chain decision comes from one
// reduction over the chain's threads of up to 11 sums: the kinetic energy,
// the two full-turn dots (at a subtree's end; speculatively, as only
// merging chains use them) and two dots for each of up to four checkpoint
// rows (more rows, one odd leaf in 16, take another round).  Then every
// thread of the chain runs the same scalar logic, and the writes follow,
// each predicated per chain: no swap writes no sp row, no merge no ends,
// prop or r_sum.  A thread issues all its loads of a phase before its
// first store, so their latencies overlap (a store could alias a later
// load, which the compiler would otherwise wait for).

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

// The tree's buffers (_NutsTree), as ops/nuts_leaf.py's _LeafArgs lays
// them out: every field 8 bytes.
struct LeafArgs {
  int64_t* n;
  int64_t n_stride;
  const bool* flags;  // [max_n + 1, 2 + kdim]: start, end, the rows an odd leaf checks
  int64_t flag_cols;
  const int64_t* slot;  // [max_n + 1]: the checkpoint row a leaf writes (kdim: none read)
  int64_t* row;         // [C]: each chain's schedule row, from the head to the tail
  const void* eps;      // [] and [d]
  const void* inv_mass;
  const bool* dir_pos;  // [C] draws
  const void* swap_u;
  const void* take_u;
  const void* val_new;  // [C], [C, d]: the potential at z_new
  const void* grad_new;
  void* z_new;  // [C, d]
  void* ends;   // [2, 3, C, d]
  void* mov;    // [3, C, d]
  void* prop;   // [2, C, d]
  void* sp;     // [2, C, d]
  void* prop_val;
  void* sp_val;
  void* h0;
  void* lw;
  void* s_lw;
  void* dirn;
  void* sum_acc;
  void* cnt;
  void* r_sum;  // [C, d]
  void* s_cum;
  bool* s_failed;
  bool* active;
  bool* diverging;
  void* r_ck;  // [kdim + 1, C, d]
  void* rs_ck;
  double max_delta_energy;
  int64_t c;
  int64_t d;
  int64_t kdim;
};

namespace {

constexpr int KG = 4;             // checkpoint rows one round of the tail checks
constexpr int NS = 3 + 2 * KG;    // its sums: energy, two full-turn dots, two dots a row
constexpr int HEAD_THREADS = 256;
constexpr int HEAD_COLS = 4;      // columns a head thread
constexpr int WIDE = 256;         // a wide chain's threads in the tail
constexpr int WARP_VPT = 2;       // columns a thread in registers: a warp a chain
constexpr int WIDE_VPT = 12;      // and a block a chain

__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ double mul(double a, double b) { return __dmul_rn(a, b); }
__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ double add(double a, double b) { return __dadd_rn(a, b); }
__device__ __forceinline__ float sub(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ double sub(double a, double b) { return __dsub_rn(a, b); }
__device__ __forceinline__ float exp_(float x) { return expf(x); }
__device__ __forceinline__ double exp_(double x) { return exp(x); }
__device__ __forceinline__ float log1p_(float x) { return log1pf(x); }
__device__ __forceinline__ double log1p_(double x) { return log1p(x); }

// torch.clamp(x, max=0), which keeps a NaN
template <typename T>
__device__ __forceinline__ T clamp0(T x) {
  return x > T(0) ? T(0) : x;
}

// torch.logaddexp
template <typename T>
__device__ __forceinline__ T logaddexp(T a, T b) {
  if (isinf(a) && a == b) return a;
  const T m = a < b ? b : a;
  return add(m, log1p_(exp_(-fabs(sub(a, b)))));
}

template <typename T>
__global__ void __launch_bounds__(HEAD_THREADS) leaf_head(const LeafArgs a) {
  const int64_t i = blockIdx.x, d = a.d, cd = a.c * a.d;
  const int64_t r = a.n[i * a.n_stride];
  if (blockIdx.y == 0 && threadIdx.x == 0) a.row[i] = r;
  if (!a.active[i]) return;
  const bool start = a.flags[r * a.flag_cols];
  T* dirn_p = static_cast<T*>(a.dirn);
  // at a start one thread writes dirn and s_failed; the others read
  // neither there
  const T dirn = start ? (a.dir_pos[i] ? T(1) : T(-1)) : dirn_p[i];
  if (start && blockIdx.y == 0 && threadIdx.x == 0) {
    dirn_p[i] = dirn;
    static_cast<T*>(a.s_lw)[i] = -INFINITY;
    a.s_failed[i] = false;
  }
  // a failed chain: the potential's value there is not read
  if (!start && a.s_failed[i]) return;
  const T eps_c = mul(*static_cast<const T*>(a.eps), dirn);
  const T half = mul(T(0.5), eps_c);
  const T* im = static_cast<const T*>(a.inv_mass);
  T* mov = static_cast<T*>(a.mov);
  T* s_cum = static_cast<T*>(a.s_cum);
  T* z_new = static_cast<T*>(a.z_new);
  // the moving end: the subtree's starting end at its start
  const T* src = start ? static_cast<const T*>(a.ends) + (dirn > T(0) ? 3 : 0) * cd : mov;
  const int64_t j0 = int64_t(blockIdx.y) * blockDim.x * HEAD_COLS + threadIdx.x;
  T m0[HEAD_COLS], m1[HEAD_COLS], m2[HEAD_COLS];
#pragma unroll
  for (int v = 0; v < HEAD_COLS; ++v) {
    const int64_t j = j0 + v * blockDim.x, e = i * d + j;
    if (j < d) {
      m0[v] = src[e];
      m1[v] = src[cd + e];
      m2[v] = src[2 * cd + e];
    }
  }
#pragma unroll
  for (int v = 0; v < HEAD_COLS; ++v) {
    const int64_t j = j0 + v * blockDim.x, e = i * d + j;
    if (j < d) {
      if (start) {
        mov[e] = m0[v];
        mov[cd + e] = m1[v];
        mov[2 * cd + e] = m2[v];
        s_cum[e] = T(0);
      }
      const T r_half = add(m2[v], mul(half, m1[v]));
      z_new[e] = add(m0[v], mul(mul(eps_c, im[j]), r_half));
    }
  }
}

// Sums v[0..used) over the G threads of a chain, in a fixed order; every
// thread of the chain gets the totals.  G = 32: a warp; G = WIDE: the block.
template <typename T, int G>
__device__ __forceinline__ void chain_sum(T (&v)[NS], int used, T (&part)[G / 32][NS]) {
#pragma unroll
  for (int s = 0; s < NS; ++s) {
    if (s < used) {
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) v[s] = add(v[s], __shfl_xor_sync(0xffffffffu, v[s], o));
    }
  }
  if constexpr (G > 32) {
    const int warp = threadIdx.x / 32;
    if (threadIdx.x % 32 == 0) {
#pragma unroll
      for (int s = 0; s < NS; ++s)
        if (s < used) part[warp][s] = v[s];
    }
    __syncthreads();
#pragma unroll
    for (int s = 0; s < NS; ++s) {
      if (s < used) {
        T t = part[0][s];
#pragma unroll
        for (int w = 1; w < G / 32; ++w) t = add(t, part[w][s]);
        v[s] = t;
      }
    }
    __syncthreads();  // part is written again by a later round
  }
}

// A wide float chain asks for two blocks an SM (128 registers a thread),
// so that one chain's loads overlap another's reduction and writes.
template <typename T, int G, int VPT>
__global__ void __launch_bounds__(G == 32 ? 128 : G, G == 32 || sizeof(T) > 4 ? 1 : 2)
    leaf_tail(const LeafArgs a) {
  constexpr int THREADS = G == 32 ? 128 : G;
  __shared__ T part[G / 32][NS];
  const int lane = threadIdx.x % G;
  const int64_t i = G == 32 ? int64_t(blockIdx.x) * (THREADS / 32) + threadIdx.x / 32
                            : int64_t(blockIdx.x);
  if (i >= a.c) return;  // G = 32 only: the whole warp
  const int64_t d = a.d, cd = a.c * a.d, r = a.row[i];
  const bool writes_n = lane == 0 && (a.n_stride != 0 || i == 0);
  if (!a.active[i]) {
    if (writes_n) a.n[i * a.n_stride] = r + 1;
    return;
  }
  const bool* fl = a.flags + r * a.flag_cols;
  const bool is_end = fl[1];
  if (a.s_failed[i]) {  // active, not live: a failed subtree ends with its tree
    if (lane == 0 && is_end) a.active[i] = false;
    if (writes_n) a.n[i * a.n_stride] = r + 1;
    return;
  }
  uint32_t checks = 0;
  for (int k = 0; k < a.kdim; ++k)
    if (fl[2 + k]) checks |= 1u << k;
  const int64_t slot = a.slot[r];

  const T dirn = static_cast<const T*>(a.dirn)[i];
  const T eps_c = mul(*static_cast<const T*>(a.eps), dirn);
  const T half = mul(T(0.5), eps_c);
  const int side = dirn > T(0) ? 1 : 0;
  // the chain's numbers, read before the reduction so that their latency
  // hides behind it
  T* s_lw = static_cast<T*>(a.s_lw);
  T* lw = static_cast<T*>(a.lw);
  T* sp_val = static_cast<T*>(a.sp_val);
  const T val = static_cast<const T*>(a.val_new)[i], h0 = static_cast<const T*>(a.h0)[i];
  const T s_lw0 = s_lw[i], lw0 = lw[i], sp_val0 = sp_val[i];
  const T swap_u = static_cast<const T*>(a.swap_u)[i], take_u = static_cast<const T*>(a.take_u)[i];
  const T* im = static_cast<const T*>(a.inv_mass);
  const T* grad_new = static_cast<const T*>(a.grad_new);
  const T* z_new = static_cast<const T*>(a.z_new);
  T* mov = static_cast<T*>(a.mov);
  T* s_cum = static_cast<T*>(a.s_cum);
  T* r_sum = static_cast<T*>(a.r_sum);
  T* ends = static_cast<T*>(a.ends);
  T* sp = static_cast<T*>(a.sp);
  T* prop = static_cast<T*>(a.prop);
  T* r_ck = static_cast<T*>(a.r_ck);
  T* rs_ck = static_cast<T*>(a.rs_ck);
  const T* other_r = ends + ((1 - side) * 3 + 2) * cd;  // the end that does not move

  // each thread's columns j = base + lane + v G, v < VPT, of a chunk of G VPT
  // columns: r_new, s_cum before the leaf and grad_new, kept in registers
  T rc[VPT], sco[VPT], gc[VPT];
  constexpr int64_t CHUNK = int64_t(G) * VPT;
  const int64_t chunks = (d + CHUNK - 1) / CHUNK;
  auto load = [&](int64_t base) {
#pragma unroll
    for (int v = 0; v < VPT; ++v) {
      const int64_t j = base + lane + v * G;
      if (j < d) {
        const int64_t e = i * d + j;
        const T g = grad_new[e];
        const T r_half = add(mov[2 * cd + e], mul(half, mov[cd + e]));
        rc[v] = add(r_half, mul(half, g));
        sco[v] = s_cum[e];
        gc[v] = g;
      }
    }
  };
  // one round: the sums of the rows in the mask (at most KG), and in the
  // first round the energy and, at a subtree's end, the full-turn dots
  auto pass = [&](uint32_t rows, bool first, T (&acc)[NS]) {
#pragma unroll
    for (int s = 0; s < NS; ++s) acc[s] = T(0);
    for (int64_t ch = 0; ch < chunks; ++ch) {
      const int64_t base = ch * CHUNK;
      if (first || chunks > 1) load(base);
#pragma unroll
      for (int v = 0; v < VPT; ++v) {
        const int64_t j = base + lane + v * G;
        if (j < d) {
          const int64_t e = i * d + j;
          const T imj = im[j], rv = rc[v], sc = add(sco[v], rv);
          const T vb = mul(rv, imj);
          if (first) {
            acc[0] = add(acc[0], mul(mul(rv, rv), imj));
            if (is_end) {
              const T rho = add(r_sum[e], sc);
              acc[1] = add(acc[1], mul(rho, vb));
              acc[2] = add(acc[2], mul(rho, mul(other_r[e], imj)));
            }
          }
          uint32_t m = rows;
#pragma unroll
          for (int q = 0; q < KG; ++q) {
            if (m) {
              const int64_t k = __ffs(int(m)) - 1;
              m &= m - 1;
              const T rho = sub(sc, rs_ck[k * cd + e]);
              acc[3 + 2 * q] = add(acc[3 + 2 * q], mul(mul(rho, r_ck[k * cd + e]), imj));
              acc[4 + 2 * q] = add(acc[4 + 2 * q], mul(rho, vb));
            }
          }
        }
      }
    }
  };
  // the first KG rows of a mask
  auto first_rows = [](uint32_t m) {
    uint32_t out = 0;
    for (int q = 0; q < KG && m; ++q) {
      out |= m & (~m + 1);
      m &= m - 1;
    }
    return out;
  };

  // a row turns where either of its dots is <= 0
  auto turns = [](const T (&t)[NS], int nrows) {
    bool out = false;
#pragma unroll
    for (int q = 0; q < KG; ++q)
      if (q < nrows) out |= t[3 + 2 * q] <= T(0) || t[4 + 2 * q] <= T(0);
    return out;
  };

  T tot[NS];
  uint32_t rows = first_rows(checks);
  pass(rows, true, tot);
  chain_sum<T, G>(tot, 3 + 2 * __popc(rows), part);
  const T ke = mul(T(0.5), tot[0]);
  const bool full_turn = tot[1] <= T(0) || tot[2] <= T(0);
  bool turn = turns(tot, __popc(rows));
  for (uint32_t rest = checks & ~rows; rest; rest &= ~rows) {
    rows = first_rows(rest);
    pass(rows, false, tot);
    chain_sum<T, G>(tot, 3 + 2 * __popc(rows), part);
    turn |= turns(tot, __popc(rows));
  }

  // --- the chain's decisions: every thread of the chain, the same bits ---
  T h = sub(ke, val);
  if (isnan(h)) h = INFINITY;
  const T lw_leaf = sub(h0, h);
  const bool dvg = lw_leaf < T(-a.max_delta_energy);
  const T s_lw_new = logaddexp(s_lw0, lw_leaf);
  const bool swap = swap_u < exp_(sub(lw_leaf, s_lw_new));
  const bool new_fail = dvg || turn;
  const bool upd = !new_fail;
  const T s_lw1 = upd ? s_lw_new : s_lw0;
  const bool merging = is_end && upd;
  const bool take = merging && take_u < exp_(clamp0(sub(s_lw1, lw0)));
  if (lane == 0) {
    T* sum_acc = static_cast<T*>(a.sum_acc);
    T* cnt = static_cast<T*>(a.cnt);
    sum_acc[i] = add(sum_acc[i], exp_(clamp0(lw_leaf)));
    cnt[i] = add(cnt[i], T(1));
    if (take) static_cast<T*>(a.prop_val)[i] = swap ? val : sp_val0;
    if (swap) sp_val[i] = val;
    if (new_fail) a.s_failed[i] = true;
    if (dvg) a.diverging[i] = true;
    if (upd) s_lw[i] = s_lw_new;
    if (merging) lw[i] = logaddexp(lw0, s_lw1);
    if (new_fail || (merging && full_turn)) a.active[i] = false;
  }
  if (writes_n) a.n[i * a.n_stride] = r + 1;

  // --- the writes, predicated per chain: a chunk's loads first, as a
  // store could alias them -----------------------------------------------
  const bool ckpt = slot < a.kdim;
  T* end = ends + side * 3 * cd;
  // the last chunk first, as it is still in registers; then the others,
  // each loaded again
  for (int64_t k = 0; k < chunks; ++k) {
    const int64_t base = (k == 0 ? chunks - 1 : k - 1) * CHUNK;
    if (k != 0) load(base);
    T zc[VPT], rs[VPT];
#pragma unroll
    for (int v = 0; v < VPT; ++v) {
      const int64_t j = base + lane + v * G, e = i * d + j;
      zc[v] = j < d && (upd || swap) ? z_new[e] : T(0);
      rs[v] = j < d && merging ? r_sum[e] : T(0);
    }
    if (take && !swap) {  // the tree's proposal takes the subtree's as it was
      T p0[VPT], p1[VPT];
#pragma unroll
      for (int v = 0; v < VPT; ++v) {
        const int64_t j = base + lane + v * G, e = i * d + j;
        p0[v] = j < d ? sp[e] : T(0);
        p1[v] = j < d ? sp[cd + e] : T(0);
      }
#pragma unroll
      for (int v = 0; v < VPT; ++v) {
        const int64_t j = base + lane + v * G, e = i * d + j;
        if (j < d) {
          prop[e] = p0[v];
          prop[cd + e] = p1[v];
        }
      }
    }
#pragma unroll
    for (int v = 0; v < VPT; ++v) {
      const int64_t j = base + lane + v * G;
      if (j < d) {
        const int64_t e = i * d + j;
        const T rv = rc[v], g = gc[v], z = zc[v], sc = add(sco[v], rv);
        if (ckpt) {
          r_ck[slot * cd + e] = rv;
          rs_ck[slot * cd + e] = sco[v];
        }
        if (take && swap) {
          prop[e] = z;
          prop[cd + e] = g;
        }
        if (swap) {
          sp[e] = z;
          sp[cd + e] = g;
        }
        if (upd) {
          s_cum[e] = sc;
          mov[e] = z;
          mov[cd + e] = g;
          mov[2 * cd + e] = rv;
        }
        if (merging) {
          end[e] = z;
          end[cd + e] = g;
          end[2 * cd + e] = rv;
          r_sum[e] = add(rs[v], sc);
        }
      }
    }
  }
}

// the tail's (G, VPT) at width d: a warp a chain, two columns a thread, up
// to 256 columns; then a block of WIDE threads, 12 columns a thread.  A
// chain wider than G VPT columns takes the chunks in turn
void tiling(int64_t d, int* g, int* vpt) {
  *g = d <= 256 ? 32 : WIDE;
  *vpt = d <= 256 ? WARP_VPT : WIDE_VPT;
}

// the head's threads a block at width d: HEAD_COLS columns each
int head_threads(int64_t d) {
  const int64_t per = (d + HEAD_COLS - 1) / HEAD_COLS;
  return per >= HEAD_THREADS ? HEAD_THREADS : int((per + 31) / 32 * 32);
}

bool valid(const LeafArgs* a) {
  const int64_t span = int64_t(HEAD_THREADS) * HEAD_COLS;
  return a->c > 0 && a->d > 0 && a->kdim > 0 && a->kdim <= 32 && a->flag_cols == 2 + a->kdim &&
         (a->n_stride == 0 || a->n_stride == 1) && (a->d + span - 1) / span <= 65535 &&
         a->c <= 0x7fffffff;
}

template <typename T>
cudaError_t launch_head(const LeafArgs& a, cudaStream_t s) {
  const int threads = head_threads(a.d);
  const int64_t span = int64_t(threads) * HEAD_COLS;
  const dim3 grid(unsigned(a.c), unsigned((a.d + span - 1) / span));
  leaf_head<T><<<grid, threads, 0, s>>>(a);
  return cudaGetLastError();
}

template <typename T, int G, int VPT>
cudaError_t launch_tail_at(const LeafArgs& a, cudaStream_t s) {
  const int64_t per_block = G == 32 ? 4 : 1;
  leaf_tail<T, G, VPT><<<unsigned((a.c + per_block - 1) / per_block), G == 32 ? 128 : G, 0, s>>>(a);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_tail(const LeafArgs& a, cudaStream_t s) {
  return a.d <= 256 ? launch_tail_at<T, 32, WARP_VPT>(a, s) : launch_tail_at<T, WIDE, WIDE_VPT>(a, s);
}

}  // namespace

// K7's head and tail over the buffers of *a, in float (f64 = 0) or double
// (f64 = 1), on the stream; 0 or the CUDA error of the launch.
extern "C" int nuts_leaf_head(const LeafArgs* a, int f64, void* stream) {
  if (!valid(a)) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return static_cast<int>(f64 ? launch_head<double>(*a, s) : launch_head<float>(*a, s));
}

extern "C" int nuts_leaf_tail(const LeafArgs* a, int f64, void* stream) {
  if (!valid(a)) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return static_cast<int>(f64 ? launch_tail<double>(*a, s) : launch_tail<float>(*a, s));
}

// The tail's threads a chain and columns a thread at width d: out[2]
extern "C" int nuts_leaf_tiling(int64_t d, int* out) {
  tiling(d, &out[0], &out[1]);
  return 0;
}

// sizeof(LeafArgs), which the wrapper's structure must match
extern "C" int64_t nuts_leaf_args_bytes() { return sizeof(LeafArgs); }
