// Fused GMM VBE step (responsibilities + sufficient statistics) for Hopper.
//
// Replaces the Pallas TPU kernel src/repro/kernels/gmm_estep.py::_kernel_nodes
// (wrapper gmm_estep_nodes).  For node n, point t and component k:
//
//   y_tk       = x_t - s_k                 (s = shift; 0 when shift is null)
//   log rho_tk = log_prior_k - (y_tk' Wn_k y_tk - 2 y_tk . b_k + c_k) / 2
//   r_tk       = softmax_k(log rho_t.) * mask_t
//   R_k += r_tk,  sum_x_k += r_tk y_tk,  sum_xx_k += r_tk y_tk y_tk'
//
// and the statistics are scaled by `rep` (the Appendix-A replication
// factor) once, at emit.  With a null shift this is exactly the TPU
// kernel's function.  The engine passes s_k = m_k (with b = 0, c = D/beta):
// log rho is then the direct (x - m)' E[L] (x - m) form and the statistics
// are centred per component, which keeps f32 statistics well conditioned
// (the expanded form cancels terms ~|x|^2 |Wn| apart).
//
// Output layout per node, (K + K*D + K, D) floats: rows [0, K) sum_x; rows
// K + k*D + d hold sum_xx[k][d][:]; rows K + K*D + k hold R_k in column 0
// (other columns zero).
//
// What bounds it on the H100.  At the main-path shape (N=1000 nodes, T=4096
// points, K=3, D=2, f32 x, no r) it reads x plus mask, 12 B a point, about
// 49 MB (the per-node terms are negligible) and writes 96 KB (1000 x 12 x
// 2 floats): about 15 us at 3.35 TB/s.  The arithmetic is about 120 FLOP
// a point, 0.49 GFLOP, about 7 us at 67 TFLOP/s f32.  But a K=3, D=2 point
// is too small for wide instructions, so what a design runs into first is
// instruction issue and latency: the first one (one block per node, log
// rho computed three times a point, a warp butterfly per statistic per
// tile) took 67 us.
//
// At D = 34 (1000 nodes x 4096 points, K = 2) the function is ~31 GFLOP
// against 0.6 GB: operations bind (~0.46 ms at 67 TFLOP/s, the rate of
// both the f32 CUDA cores and the FP64 tensor cores).
//
// Three paths; the wrapper (kernels/gmm_estep.py::kernel_variant) picks
// one by (K, D) alone, never by T or N:
//
// * gmm_estep_regs_kernel, when the K (1 + D + D(D+1)/2) statistics fit
//   kRegBudget = 24 floats (K <= 4 at D = 2, K <= 8 at D = 1; the main
//   path's K = 3 is 18).
//   - One block of kThreads = 128 per node.  Its points come in tiles of
//     kTile = 512; thread i takes the kGroup = 4 consecutive points
//     tile*kTile + 4i + j, as whole vectors: 16-byte float4 loads of f32 x
//     and mask (8-byte for bf16) when T % 4 == 0 and both bases are
//     aligned (`vec`), scalar loads otherwise and for a ragged last group.
//     The next tile's group is loaded while the current one computes, and
//     the first one before the node's terms are staged.
//   - K is a runtime value at most KMAX = kRegBudget / (1 + D + D(D+1)/2);
//     the loops over components are unrolled to KMAX with a k < K guard:
//     one instance per (D, x dtype).  Per group: log rho of each point and
//     component once, in the plain version's form (y' Wn y - 2 y.b + c),
//     the max, K expf, one approximate reciprocal a point (the denominator
//     lies in [1, K]), then r and the statistics, which stay in registers
//     across all of a thread's points.  The statistics' bars against the
//     plain version are tight where a node's sum cancels: exp2 through
//     ex2.approx (its error is a fixed function of the argument, so it adds
//     up over similar points) went 1.5x past the sum_x bar where expf stays
//     inside it (PERF.md).
//   - Once per block: the threads' partial sums go to shared memory; lane l
//     of a warp adds those of threads l, l + 32, ... in that order, then a
//     __shfl_xor_sync butterfly.
//   - A node's tiles are not split over blocks: a split over a
//     thread-block cluster cost more per-thread start-up and reduction
//     than it gained at the main path (PERF.md).
//   - Registers bound the occupancy: a budget of 48 floats (K <= 8 at
//     D = 2) took 127 registers and ran slower at K = 3.
// * gmm_estep_smem_kernel<D, x dtype, CBM>, for the other (K, D) with
//   D <= 8 (the wrapper's SHARED_KMAX, while the plan's shared memory
//   fits).  Operations bind it: the function needs 2 D^2 + 8 D + 15 of
//   them a point and component, 7.5 GFLOP at K = 32, D = 3 on 1000 x 4096
//   points (0.11 ms at 67 TFLOP/s) against 49 MB of x and mask (0.015 ms).
//   It runs them on the FP64 tensor cores:
//   - each point becomes its features phi = the upper triangle of
//     x' x'^T, x' = (x, 1) (F = (D+1)(D+2)/2; exact products of f32 in
//     f64), converted once into the converting warp's f64 tile; each
//     component's terms, shift and log_prior fold once a node into u_k on
//     the same triangle (sm_u), so log rho = phi . u_k is one chain of
//     m16n8k8 products (16 points by a block of 8 components, NS k-steps
//     of 8 features), formed once a point and component;
//   - the softmax stays in registers (a point's components of a block
//     over the four lanes of its row: max, one expf a value, the sum by
//     two xor shuffles; a warp holding several blocks keeps their log rho
//     in its shared memory meanwhile, which leaves the instances of
//     D <= 4 at <= 128 registers, two blocks an SM); e goes through a
//     small per-warp transpose in shared memory, and each point's mask /
//     denominator is applied as B is formed;
//   - sum_t r_tk phi(x_t) holds R, sum_x and sum_xx at once: m16n8k16
//     products (A = phi^T, features x points; B = r, points x
//     components) accumulated in each warp's registers across all of the
//     node's tiles (no per-tile reduction), added in warp order at the
//     end and centred on s_k in f64, times rep, at emit.
//   One block of 8 warps a node; block_t points a tile arrive by cp.async
//   into a double buffer (one barrier a tile), and warp w takes the
//   tile's 16-point steps w, w + 8, ...  A warp holds CBM blocks of 8
//   components (the instance: 1, or 4 at D <= 4 and 2 above); past that
//   the node takes an lse pass (each point's largest log rho and softmax
//   denominator, online over the blocks, to a workspace) and passes of
//   CBM blocks.  What bounds it (PERF.md): instruction issue and latency
//   around the products (the conversion, softmax, transpose and their
//   addressing take several times the tensor pipe's cycles at small K)
//   at one or two blocks an SM (holding every block's log rho in
//   registers took ~170 of them, one block an SM, and ran slower at
//   K = 32, D = 3).
// * the wide path, for everything else (the paper's real-data tables run
//   D = 34 and D = 52; any K and D): log rho and the statistics in f64 on
//   the FP64 tensor cores with mma.sync (m16n8k8 for the quadratic form,
//   m16n8k16 for the statistics; m8n8k4 runs at half the rate on the
//   H100, tools/dmma_probe.cu), in up to four launches a call:
//   - gmm_estep_wide_prep_kernel folds each (node, component)'s terms into
//     one f64 matrix U_k with x'^T U_k x' = y^T Wn y - 2 y.b + c for
//     x' = (x, 1), y = x - s_k: M = [[Wn, -v], [-v^T, cc]], v = (Wn +
//     Wn^T) s / 2 + b, cc = s^T Wn s + 2 s.b + c, kept on the 8 x 8 blocks
//     on and above the diagonal (M_ij + M_ji above it: 15 of 25 blocks at
//     D = 34), written once a call in fragment order to the workspace.
//     The expanded form is safe in f64 (f32 x carries 29 fewer bits).
//   - gmm_estep_wide_kernel<x dtype, mode, x from global>: one block of
//     kWideThreads = 256 per node (and component group, below) walks the
//     node's tiles of kWideTile = 128 points (halved while a tile does not
//     fit).  The raw tile arrives by cp.async into a double buffer (the
//     next tile's copy overlaps this tile's work) and is converted to an
//     f64 tile x' = (x, 1, 0 ..) whose row stride is 4 mod 16
//     (conflict-free fragment loads).  Quadratic form: warp w takes 16
//     points and holds their A fragments in registers across the
//     components (kWideSteps k-steps of 8 at a time); per column block J,
//     a switch on its k-steps gives straight-line code: the U fragments
//     (staged once a block in shared memory when they fit), two
//     accumulators, the row dot with x'.  log rho is f64 (an f32 log rho
//     misses tests/test_kernels.py's bars at D = 52, PERF.md); the softmax
//     takes 256 / tile threads a point (xor butterflies), exp and r in
//     f32.  Statistics: sum_t r x' x'^T as 16 x 8 items (row block I,
//     column block J >= 2I: the upper triangle; its column D gives sum_x,
//     its corner R), m16n8k16 products over 16 points, each warp holding
//     up to kWideItems = 9 items in registers across the node's tiles; a
//     block's items are chunked and split over point groups so that the
//     busiest warp has the least work, and the groups' sums are added in
//     group order at the end.  Nothing of a node's statistics has to fit
//     one block: a block takes up to 8 x 9 items (whole components when
//     they fit, else one component's items over several blocks), and
//     when a node needs more than one block a first launch (mode kLse)
//     writes each point's largest log rho and softmax denominator
//     (online over chunks of kWideComps components) and the blocks (mode
//     kSplit) read them.  The entries i <= j of every item go to an f64
//     workspace.  Past a 16-point tile's shared memory (D > ~1790) the
//     fragments read x from global memory (XG).
//   - gmm_estep_wide_emit_kernel centres the statistics on s_k in f64,
//     times `rep`, and writes the f32 rows.
//   What bounds it (PERF.md; tools/gmm_wide_profile.py): at D = 34
//   (K = 2) a 128-point tile is ~4,200 cycles of each SM sub-partition's
//   tensor pipe (30 m16n8k8 and 18 m16n8k16 products a warp, two warps a
//   sub-partition) but takes ~16,700: the quadratic form ~6,000 and the
//   statistics ~5,300 (dependent load -> multiply -> product chains in
//   in-order issue, two warps a sub-partition to hide them at 236
//   registers a thread), the conversion ~2,200 and the softmax ~1,600,
//   which run beside no tensor work.
//
// Determinism: no atomics.  The association order of every statistic
// depends on the point index and the compile-time constants (kThreads,
// kGroup; kSmWarps and kSmStep on the shared path; the plan, a function
// of (K, D) and x's dtype, on the wide path), never on T: points at or
// past T read as x = 0, mask = 0 and contribute exact zeros, exactly like
// trailing mask-zero padding in memory, which only appends zero terms to
// each thread's sequence.  Stats for x and for x with zero rows appended
// are bit-identical, and two launches on the same inputs are too.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
//        -Xcompiler -fPIC (repro_torch/kernels/build.py); called via ctypes.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// log rho of one point and component in the plain version's form and
// order (y' Wn y - 2 y.b + c, Wn applied row by row), so that the kernel
// and its oracle round alike
template <int D>
__device__ __forceinline__ float log_rho(const float* w, const float* bk,
                                         float lp, float ck,
                                         const float (&y)[D]) {
  float quad = 0.f, cross = 0.f;
#pragma unroll
  for (int e = 0; e < D; ++e) {
    float yw = 0.f;
#pragma unroll
    for (int d = 0; d < D; ++d) yw += y[d] * w[d * D + e];
    quad += yw * y[e];
    cross += y[e] * bk[e];
  }
  return lp - 0.5f * (quad - 2.f * cross + ck);
}

// ===========================================================================
// Register path
// ===========================================================================
// floats of per-thread statistics; repro_torch/kernels/gmm_estep.py mirrors
// it (REG_STATS_BUDGET) and checks it against gmm_estep_reg_kmax
constexpr int kRegBudget = 24;
constexpr int kThreads = 128;              // threads per block
constexpr int kGroup = 4;                  // consecutive points a thread takes
constexpr int kTile = kThreads * kGroup;   // points per tile

template <int D>
struct RegShape {
  static constexpr int SK = 1 + D + D * (D + 1) / 2;   // stats a component
  static constexpr int KMAX = kRegBudget / SK;         // 0: no register path
  // per-component terms in shared memory: s (D), Wn (D*D), b (D), lp, c
  static constexpr int STRIDE = (2 * D + D * D + 2 + 3) / 4 * 4;
};

// four consecutive elements of x or mask, as loaded
template <typename Tin>
struct Vec4;
template <>
struct Vec4<float> {
  using type = float4;
};
template <>
struct Vec4<__nv_bfloat16> {
  using type = uint2;
};

__device__ __forceinline__ float4 ld4(const float* p) {
  return __ldg(reinterpret_cast<const float4*>(p));
}
__device__ __forceinline__ uint2 ld4(const __nv_bfloat16* p) {
  return __ldg(reinterpret_cast<const uint2*>(p));
}

// the first n (0..4) of four elements, the rest zero (scalar loads)
__device__ __forceinline__ float4 ld4_part(const float* p, int n) {
  float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
  if (n > 0) v.x = p[0];
  if (n > 1) v.y = p[1];
  if (n > 2) v.z = p[2];
  if (n > 3) v.w = p[3];
  return v;
}
__device__ __forceinline__ uint2 ld4_part(const __nv_bfloat16* p, int n) {
  const unsigned short* q = reinterpret_cast<const unsigned short*>(p);
  const uint32_t e0 = n > 0 ? q[0] : 0u, e1 = n > 1 ? q[1] : 0u;
  const uint32_t e2 = n > 2 ? q[2] : 0u, e3 = n > 3 ? q[3] : 0u;
  return make_uint2(e0 | (e1 << 16), e2 | (e3 << 16));
}

__device__ __forceinline__ void unpack4(float4 v, float* o) {
  o[0] = v.x;
  o[1] = v.y;
  o[2] = v.z;
  o[3] = v.w;
}
// bf16 -> f32 is exact: the bf16 bits are the high half of the f32 bits
__device__ __forceinline__ void unpack4(uint2 v, float* o) {
  o[0] = __uint_as_float(v.x << 16);
  o[1] = __uint_as_float(v.x & 0xffff0000u);
  o[2] = __uint_as_float(v.y << 16);
  o[3] = __uint_as_float(v.y & 0xffff0000u);
}

// one thread's kGroup consecutive points of a tile, as loaded
template <int D, typename Tin>
struct Group {
  typename Vec4<Tin>::type x[D];   // kGroup * D coordinates
  typename Vec4<Tin>::type m;      // kGroup mask values
};

template <int D, typename Tin>
__device__ __forceinline__ void load_group(Group<D, Tin>& g,
                                           const Tin* __restrict__ xn,
                                           const Tin* __restrict__ mn, int p,
                                           int T, bool vec) {
  const int valid = min(max(T - p, 0), kGroup);   // points in range
  if (vec && valid == kGroup) {
#pragma unroll
    for (int c = 0; c < D; ++c) g.x[c] = ld4(xn + (size_t)p * D + 4 * c);
    g.m = ld4(mn + p);
  } else {
#pragma unroll
    for (int c = 0; c < D; ++c)
      g.x[c] = ld4_part(xn + (size_t)p * D + 4 * c,
                        min(max(valid * D - 4 * c, 0), 4));
    g.m = ld4_part(mn + p, valid);
  }
}

// r and the statistics of one group of points (points p .. p + kGroup - 1),
// added into acc.  The loops over the group's points sit inside the loops
// over components, so each component's terms are read from shared memory
// once per group and the points' work interleaves; each acc[k][s] still
// takes the points in point order.
template <int D, typename Tin>
__device__ __forceinline__ void process_group(
    const Group<D, Tin>& g, const float* __restrict__ s_terms, int K, int p,
    int T, float* __restrict__ r_node,
    float (&acc)[RegShape<D>::KMAX][RegShape<D>::SK]) {
  using S = RegShape<D>;
  float xs[kGroup][D], ms[kGroup];
#pragma unroll
  for (int c = 0; c < D; ++c) unpack4(g.x[c], &xs[0][0] + 4 * c);
  unpack4(g.m, ms);
  // log rho, then e = exp(log rho - max) in place
  float e[kGroup][S::KMAX], mx[kGroup], den[kGroup];
#pragma unroll
  for (int j = 0; j < kGroup; ++j) {
    mx[j] = -INFINITY;
    den[j] = 0.f;
  }
#pragma unroll
  for (int k = 0; k < S::KMAX; ++k) {
    if (k < K) {
      const float* t = s_terms + k * S::STRIDE;
#pragma unroll
      for (int j = 0; j < kGroup; ++j) {
        float y[D];
#pragma unroll
        for (int d = 0; d < D; ++d) y[d] = xs[j][d] - t[d];
        e[j][k] = log_rho<D>(t + D, t + D + D * D, t[2 * D + D * D],
                             t[2 * D + D * D + 1], y);
        mx[j] = fmaxf(mx[j], e[j][k]);
      }
    }
  }
#pragma unroll
  for (int k = 0; k < S::KMAX; ++k) {
    if (k < K) {
#pragma unroll
      for (int j = 0; j < kGroup; ++j) {
        e[j][k] = expf(e[j][k] - mx[j]);
        den[j] += e[j][k];
      }
    }
  }
  float inv[kGroup];
#pragma unroll
  for (int j = 0; j < kGroup; ++j) inv[j] = __fdividef(ms[j], den[j]);
#pragma unroll
  for (int k = 0; k < S::KMAX; ++k) {
    if (k < K) {
      const float* t = s_terms + k * S::STRIDE;
#pragma unroll
      for (int j = 0; j < kGroup; ++j) {
        const float r = e[j][k] * inv[j];   // den in [1, K]
        if (r_node != nullptr && p + j < T)
          r_node[(size_t)(p + j) * K + k] = r;
        float y[D], ry[D];
#pragma unroll
        for (int d = 0; d < D; ++d) {
          y[d] = xs[j][d] - t[d];
          ry[d] = r * y[d];
        }
        acc[k][0] += r;
#pragma unroll
        for (int d = 0; d < D; ++d) acc[k][1 + d] += ry[d];
        int i = 1 + D;
#pragma unroll
        for (int d = 0; d < D; ++d) {
#pragma unroll
          for (int f = d; f < D; ++f, ++i)
            acc[k][i] = fmaf(ry[d], y[f], acc[k][i]);
        }
      }
    }
  }
}

template <int D, typename Tin>
__global__ void __launch_bounds__(kThreads)
    gmm_estep_regs_kernel(const Tin* __restrict__ x,
                          const Tin* __restrict__ mask,
                          const float* __restrict__ log_prior,
                          const float* __restrict__ Wn,
                          const float* __restrict__ b,
                          const float* __restrict__ c,
                          const float* __restrict__ shift,
                          float* __restrict__ r_out,
                          float* __restrict__ stats, int T, int K, float rep,
                          int vec) {
  using S = RegShape<D>;
  constexpr int kStats = S::KMAX * S::SK;
  __shared__ __align__(16) float s_terms[S::KMAX * S::STRIDE];
  __shared__ float s_part[kStats][kThreads];   // per-thread partial sums
  __shared__ float s_tot[kStats];              // the node's totals
  const int n = blockIdx.x;
  const int tid = threadIdx.x;

  const Tin* xn = x + (size_t)n * T * D;
  const Tin* mn = mask + (size_t)n * T;
  float* r_node = r_out != nullptr ? r_out + (size_t)n * T * K : nullptr;
  const int ntiles = (T + kTile - 1) / kTile;
  const int off = kGroup * tid;
  // the first group's loads go out before the terms are staged
  Group<D, Tin> cur = {}, nxt = {};
  if (ntiles > 0) load_group(cur, xn, mn, off, T, vec != 0);

  for (int i = tid; i < K * S::STRIDE; i += kThreads) {
    const int k = i / S::STRIDE, o = i % S::STRIDE;
    const size_t nk = (size_t)n * K + k;
    float v = 0.f;
    if (o < D)
      v = shift != nullptr ? shift[nk * D + o] : 0.f;
    else if (o < D + D * D)
      v = Wn[nk * D * D + (o - D)];
    else if (o < 2 * D + D * D)
      v = b[nk * D + (o - D - D * D)];
    else if (o == 2 * D + D * D)
      v = log_prior[nk];
    else if (o == 2 * D + D * D + 1)
      v = c[nk];
    s_terms[i] = v;
  }
  __syncthreads();

  float acc[S::KMAX][S::SK];
#pragma unroll
  for (int k = 0; k < S::KMAX; ++k)
#pragma unroll
    for (int s = 0; s < S::SK; ++s) acc[k][s] = 0.f;

  // the next tile's group is loaded while this one computes
  for (int tile = 0; tile < ntiles; ++tile) {
    if (tile + 1 < ntiles)
      load_group(nxt, xn, mn, (tile + 1) * kTile + off, T, vec != 0);
    process_group<D, Tin>(cur, s_terms, K, tile * kTile + off, T, r_node,
                          acc);
    cur = nxt;
  }

  // node total of statistic i: lane l of a warp adds the partials of
  // threads l, l + 32, ... in that order, then the warp's butterfly; warp w
  // takes statistics w, w + kWarps, ...
  constexpr int kWarps = kThreads / 32;
  const int nstat = K * S::SK;
#pragma unroll
  for (int k = 0; k < S::KMAX; ++k) {
    if (k < K) {
#pragma unroll
      for (int s = 0; s < S::SK; ++s) s_part[k * S::SK + s][tid] = acc[k][s];
    }
  }
  __syncthreads();
  const int lane = tid & 31, warp = tid >> 5;
  for (int i = warp; i < nstat; i += kWarps) {
    float v = s_part[i][lane];
#pragma unroll
    for (int w = 1; w < kWarps; ++w) v += s_part[i][lane + 32 * w];
    v = warp_sum(v);
    if (lane == 0) s_tot[i] = v;
  }
  __syncthreads();
  const int rows = K + K * D + K;
  float* out = stats + (size_t)n * rows * D;
  for (int o = tid; o < rows * D; o += kThreads) {
    const int row = o / D, col = o % D;
    float val;
    if (row < K) {
      val = s_tot[row * S::SK + 1 + col];
    } else if (row < K + K * D) {
      const int k = (row - K) / D, d = (row - K) % D;
      const int i = d < col ? d : col, j = d < col ? col : d;
      val = s_tot[k * S::SK + 1 + D + i * D - i * (i - 1) / 2 + (j - i)];
    } else {
      val = col == 0 ? s_tot[(row - K - K * D) * S::SK] : 0.f;
    }
    out[o] = val * rep;
  }
}

// ===========================================================================
// Wide path: any D, and the (K, D) shapes the two paths above do not take
// ===========================================================================
// repro_torch/kernels/gmm_estep.py mirrors these (WIDE_THREADS, WIDE_TILE,
// WIDE_ITEMS, WIDE_STEPS, WIDE_COMPS) and checks its plan against
// gmm_estep_wide_plan.
constexpr int kWideThreads = 256;
constexpr int kWideWarps = kWideThreads / 32;
constexpr int kWideTile = 128;    // points a tile (halved while it does not fit)
constexpr int kWideItems = 9;     // statistics items a warp holds in registers
constexpr int kWideSteps = 5;    // k-steps of 8 of A fragments a warp holds
static_assert(kWideItems == 9 && kWideSteps == 5,
              "the WIDE_STATS switch takes 1 .. 9, WIDE_QUAD 1 .. 5");
constexpr int kWideComps = 32;    // components whose log rho rows a block holds
constexpr int kWideSmem = 227 * 1024;

enum WideMode { kFused = 0, kLse = 1, kSplit = 2 };

__host__ __device__ inline int wmin(int a, int b) { return a < b ? a : b; }
__host__ __device__ inline int wmax(int a, int b) { return a > b ? a : b; }

// The wide path's shape at (K, D) and x's element size.  x' = (x, 1) has
// Dq = D + 1 coordinates.  The quadratic form x'^T U_k x' runs as
// m16n8k8 DMMA products over nS = nJ k-steps of 8 coordinates and nJ
// column blocks of 8; U_k keeps only the blocks on or above the 8 x 8
// diagonal (column block J takes k-steps 0 .. J), nfrag fragments of 64
// doubles.  The statistics sum_t r x' x'^T are m16n8k16 products over 16
// points, items of 16 x 8 (row block I, column block J >= 2I), nitems a
// component.
struct WidePlan {
  int Dq, nS, nJ, nI, nfrag, nitems, ntri;
  int kb;       // components a block (0: one component over nsplit blocks)
  int nsplit;   // blocks a component when its items exceed one block's
  int per;      // items a block then
  int nby;      // blocks a node (1: one fused launch)
  int kq;       // components whose q / r rows a block holds at once
  int tp;       // points a tile
  int xs;       // row stride of the f64 point tile, 16 nI + 4 (= 4 mod 16)
  int xg;       // 1: no point tile fits shared memory; x is read from global
  int raw;      // bytes of one raw tile buffer (16 spare for alignment)
  int su;       // 1: a split or fused block's U fragments fit shared memory
  int off_xt, off_raw, off_q, off_m, off_lp, off_u, smem;   // smem bytes
};

__host__ __device__ inline WidePlan wide_plan(int K, int D, int esize) {
  WidePlan P;
  P.Dq = D + 1;
  P.nJ = (P.Dq + 7) / 8;
  P.nS = P.nJ;
  P.nI = (P.Dq + 15) / 16;
  P.nfrag = P.nJ * (P.nJ + 1) / 2;
  P.nitems = 0;
  for (int I = 0; 2 * I < P.nJ; ++I) P.nitems += P.nJ - 2 * I;
  P.ntri = P.Dq * (P.Dq + 1) / 2;
  const int cap = kWideWarps * kWideItems;
  if (P.nitems <= cap) {
    P.kb = wmin(wmin(K, kWideComps), cap / P.nitems);
    P.nsplit = 1;
    P.per = 0;
    P.nby = (K + P.kb - 1) / P.kb;
  } else {
    P.kb = 0;
    P.nsplit = (P.nitems + cap - 1) / cap;
    P.per = (P.nitems + P.nsplit - 1) / P.nsplit;
    P.nby = K * P.nsplit;
  }
  P.kq = wmin(K, kWideComps);
  P.xs = 16 * P.nI + 4;
  P.xg = 1;
  P.tp = kWideTile;
  P.raw = 0;
  for (int tp = kWideTile; tp >= 16; tp /= 2) {
    const long long raw = ((long long)tp * D * esize + 15) / 16 * 16 + 16;
    const long long need = (long long)tp * P.xs * 8 + 2 * raw +
                           (long long)P.kq * tp * 8 + tp * 4;
    if (need <= kWideSmem) {
      P.tp = tp;
      P.xg = 0;
      P.raw = (int)raw;
      break;
    }
  }
  int o = 0;
  P.off_xt = o;
  o += P.xg ? 0 : P.tp * P.xs * 8;
  P.off_raw = o;
  o += 2 * P.raw;
  P.off_q = o;
  o += P.kq * P.tp * 8;
  P.off_m = o;
  o += P.tp * 4;
  P.off_lp = o;
  o += (P.kq * 8 + 15) / 16 * 16;
  const long long ub = (long long)(P.kb > 0 ? P.kb : 1) * P.nfrag * 512;
  P.su = o + ub <= kWideSmem;
  P.off_u = o;
  o += P.su ? (int)ub : 0;
  // the end's reduction reuses the whole area: every warp's items
  P.smem = wmax(o, kWideWarps * kWideItems * 128 * 8);
  return P;
}

// items of one block: [lo, hi) of the node's list (component-major, then
// row block I, then column block J), components kbase .. kbase + nkb - 1
struct WideBlock {
  int lo, hi, kbase, nkb, first;   // first: this block writes r
};

__device__ __forceinline__ WideBlock wide_block(const WidePlan& P, int K,
                                                int y) {
  WideBlock B;
  if (P.kb > 0) {
    B.kbase = y * P.kb;
    B.nkb = wmin(K, B.kbase + P.kb) - B.kbase;
    B.lo = B.kbase * P.nitems;
    B.hi = (B.kbase + B.nkb) * P.nitems;
    B.first = 1;
  } else {
    B.kbase = y / P.nsplit;
    const int j = y % P.nsplit;
    B.nkb = 1;
    B.lo = B.kbase * P.nitems + j * P.per;
    B.hi = B.kbase * P.nitems + wmin(P.nitems, (j + 1) * P.per);
    B.first = j == 0;
  }
  return B;
}

// A block's nbi items over its warps: nchunk chunks of csz consecutive
// items (at most kWideItems), each over G point groups (a power of two,
// at most the tile's k-steps of 16 points), nchunk * G <= kWideWarps;
// of the choices, the one with the least work for the busiest warp
// (csz items x tile / 16 / G k-steps), then the fewest warps.
__host__ __device__ inline void wide_chunks(int nbi, int tp, int& nchunk,
                                            int& csz, int& G) {
  int best = -1;
  for (int nc = (nbi + kWideItems - 1) / kWideItems; nc <= kWideWarps;
       ++nc) {
    const int cs = (nbi + nc - 1) / nc;
    if ((nc - 1) * cs >= nbi) continue;   // a chunk would be empty
    int g = 1;
    while (2 * g * nc <= kWideWarps && 2 * g <= tp / 16) g *= 2;
    const int work = cs * (tp / 16 / g);
    if (best < 0 || work < best) {
      best = work;
      nchunk = nc;
      csz = cs;
      G = g;
    }
  }
}

// item `local` of a component -> row block I, column block J
__device__ __forceinline__ void wide_item(const WidePlan& P, int local,
                                          int& I, int& J) {
  I = 0;
  while (local >= P.nJ - 2 * I) {
    local -= P.nJ - 2 * I;
    ++I;
  }
  J = 2 * I + local;
}

// D = C + A B in f64 on the tensor cores; lane l = 4 g + t holds D rows g,
// g + 8 of columns 2t, 2t + 1 (tools/dmma_probe.cu checks these layouts
// on the card).  m16n8k8: A 16 x 8 (a0..a3: rows g, g + 8 of column t,
// then of column t + 4), B 8 x 8 (b0, b1: rows t, t + 4 of column g)
__device__ __forceinline__ void dmma8(double (&d)[4], const double (&a)[4],
                                      double b0, double b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f64.f64.f64.f64 {%0,%1,%2,%3}, "
      "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+d"(d[0]), "+d"(d[1]), "+d"(d[2]), "+d"(d[3])
      : "d"(a[0]), "d"(a[1]), "d"(a[2]), "d"(a[3]), "d"(b0), "d"(b1));
}

// m16n8k16: A 16 x 16 (a[2j], a[2j + 1]: rows g, g + 8 of column t + 4j),
// B 16 x 8 (b[j]: row t + 4j of column g)
__device__ __forceinline__ void dmma16(double (&d)[4], const double (&a)[8],
                                       const double (&b)[4]) {
  asm("mma.sync.aligned.m16n8k16.row.col.f64.f64.f64.f64 {%0,%1,%2,%3}, "
      "{%4,%5,%6,%7,%8,%9,%10,%11}, {%12,%13,%14,%15}, {%0,%1,%2,%3};\n"
      : "+d"(d[0]), "+d"(d[1]), "+d"(d[2]), "+d"(d[3])
      : "d"(a[0]), "d"(a[1]), "d"(a[2]), "d"(a[3]), "d"(a[4]), "d"(a[5]),
        "d"(a[6]), "d"(a[7]), "d"(b[0]), "d"(b[1]), "d"(b[2]), "d"(b[3]));
}

__device__ __forceinline__ double wide_shfl(double v, int o) {
  return __shfl_xor_sync(0xffffffffu, v, o);
}

// v = *a (a shared address) when p, else v unchanged: a predicated load
__device__ __forceinline__ void lds_f64_if(double& v, bool p,
                                           const double* a) {
  asm volatile(
      "{\n .reg .pred q;\n setp.ne.b32 q, %1, 0;\n"
      " @q ld.shared.f64 %0, [%2];\n}\n"
      : "+d"(v)
      : "r"((int)p), "r"((unsigned)__cvta_generic_to_shared(a)));
}

__device__ __forceinline__ void cp_async16(void* s, const void* g) {
  const unsigned sa = (unsigned)__cvta_generic_to_shared(s);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(sa),
               "l"(g));
}

// coordinate c of x' for tile point p: the f64 tile in shared memory, or
// (XG) x itself, read and converted (points at or past T are x = 0)
template <typename Tin, bool XG>
struct WideX {
  const double* xt;
  int xs;
  const Tin* xn;   // x of the node, from point p0
  int valid, D;    // points of the tile before T
  __device__ __forceinline__ double operator()(int p, int c) const {
    if constexpr (XG) {
      if (c == D) return 1.0;
      return (c < D && p < valid) ? (double)to_f32(xn[(size_t)p * D + c])
                                  : 0.0;
    } else {
      return xt[p * xs + c];
    }
  }
};

// One column block of the quadratic form over NS k-steps of 8 (NS known
// at compile time): the fragments (a lane's two values adjacent) and x'
// values first, then the products on two accumulators (even and odd
// k-steps), then the row dot with x'.
template <int NS, typename XT>
__device__ __forceinline__ void wide_quad_block(
    const double* U, const double (&av)[kWideSteps][4], const XT& X, int pr,
    int c, double& qa, double& qb) {
  double2 ub[NS];
#pragma unroll
  for (int i = 0; i < NS; ++i)
    ub[i] = *reinterpret_cast<const double2*>(U + i * 64);
  const double x0 = X(pr, c), x1 = X(pr, c + 1);
  const double x2 = X(pr + 8, c), x3 = X(pr + 8, c + 1);
  double z0[4] = {0.0, 0.0, 0.0, 0.0}, z1[4] = {0.0, 0.0, 0.0, 0.0};
#pragma unroll
  for (int i = 0; i < NS; ++i) {
    if (i & 1)
      dmma8(z1, av[i], ub[i].x, ub[i].y);
    else
      dmma8(z0, av[i], ub[i].x, ub[i].y);
  }
  qa = fma(z0[0] + z1[0], x0, qa);
  qa = fma(z0[1] + z1[1], x1, qa);
  qb = fma(z0[2] + z1[2], x2, qb);
  qb = fma(z0[3] + z1[3], x3, qb);
}

// q = x'^T U_k x' of each point of the tile and each component kk <
// ncomp (U fragments of component kk at Ub + kk nfrag 64), into
// s_q[kk][p].  Warp w takes the 16 points of block w % npb and the
// components kk = w / npb, w / npb + 8 / npb, ...; its A fragments (the
// points' coordinates) stay in registers across the components, in
// chunks of kWideSteps k-steps of 8 (the chunks' row dots add up in s_q);
// per column block J, a switch on its k-steps in the chunk.
template <typename Tin, bool XG>
__device__ __forceinline__ void wide_quad(const WidePlan& P,
                                          const WideX<Tin, XG>& X,
                                          const double* Ub, int ncomp,
                                          double* s_q, int warp, int lane) {
  const int g = lane >> 2, t = lane & 3;
  const int npb = P.tp / 16;
  const int pr = (warp % npb) * 16 + g;
  for (int sc = 0; sc < P.nS; sc += kWideSteps) {
    const int se = wmin(P.nS, sc + kWideSteps);
    double av[kWideSteps][4];
#pragma unroll
    for (int i = 0; i < kWideSteps; ++i) {
      const int c = 8 * (sc + i) + t;
      const bool in = sc + i < se;
      av[i][0] = in ? X(pr, c) : 0.0;
      av[i][1] = in ? X(pr + 8, c) : 0.0;
      av[i][2] = in ? X(pr, c + 4) : 0.0;
      av[i][3] = in ? X(pr + 8, c + 4) : 0.0;
    }
    for (int kk = warp / npb; kk < ncomp; kk += kWideWarps / npb) {
      const double* U = Ub + (size_t)kk * P.nfrag * 64 + 2 * lane;
      double qa = 0.0, qb = 0.0;
      for (int J = sc; J < P.nJ; ++J) {
        // column block J's k-steps sc .. min(J + 1, se) - 1
        const double* Uj = U + (size_t)(J * (J + 1) / 2 + sc) * 64;
        switch (wmin(J + 1, se) - sc) {
#define WIDE_QUAD(NN)                                                     \
  case NN:                                                                \
    wide_quad_block<NN>(Uj, av, X, pr, 8 * J + 2 * t, qa, qb);            \
    break;
          WIDE_QUAD(1) WIDE_QUAD(2) WIDE_QUAD(3) WIDE_QUAD(4) WIDE_QUAD(5)
#undef WIDE_QUAD
          default:
            break;
        }
      }
      qa += wide_shfl(qa, 1);
      qa += wide_shfl(qa, 2);
      qb += wide_shfl(qb, 1);
      qb += wide_shfl(qb, 2);
      if (t == 0) {
        double* q = s_q + kk * P.tp + pr;
        q[0] = sc == 0 ? qa : q[0] + qa;
        q[8] = sc == 0 ? qb : q[8] + qb;
      }
    }
  }
}

// k-steps st0 .. st1 - 1 of a tile (16 points each; lane t's points
// 16 st + t + 4 j, j < 4) for a warp's L statistics items, L known at
// compile time: per k-step the items' (component, I, J) walk, then per
// item A = x'[rows 16 I ..] (loaded where (component, I) changes, by
// predicated loads, so that no item branches), r of the component (where
// it changes), B = r x'[columns 8 J ..] and the product.
template <int L, typename Tin, bool XG>
__device__ __forceinline__ void wide_stats_tile(
    const WidePlan& P, const WideX<Tin, XG>& X, const double* s_r, int st0,
    int st1, int t, int g, int kl0, int I0, int J0,
    double (&acc)[kWideItems][4]) {
  for (int st = st0; st < st1; ++st) {
    const int p = 16 * st + t;
    int kl[L], ia[L], jb[L];
    bool newa[L], newr[L];
    {
      int k = kl0, I = I0, J = J0;
#pragma unroll
      for (int c = 0; c < L; ++c) {
        newa[c] = newr[c] = c == 0;
        if (c > 0 && ++J == P.nJ) {
          newa[c] = true;
          if (2 * ++I >= P.nJ) {
            ++k;
            I = 0;
            newr[c] = true;
          }
          J = 2 * I;
        }
        kl[c] = k;
        ia[c] = 16 * I + g;
        jb[c] = 8 * J + g;
      }
    }
    double a[8] = {0, 0, 0, 0, 0, 0, 0, 0}, rv[4] = {0, 0, 0, 0};
#pragma unroll
    for (int c = 0; c < L; ++c) {
      double b[4];
      if constexpr (XG) {
        if (newa[c]) {
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            a[2 * j] = X(p + 4 * j, ia[c]);
            a[2 * j + 1] = X(p + 4 * j, ia[c] + 8);
          }
        }
        if (newr[c]) {
#pragma unroll
          for (int j = 0; j < 4; ++j) rv[j] = s_r[kl[c] * P.tp + p + 4 * j];
        }
      } else {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const double* row = X.xt + (p + 4 * j) * X.xs;
          lds_f64_if(a[2 * j], newa[c], row + ia[c]);
          lds_f64_if(a[2 * j + 1], newa[c], row + ia[c] + 8);
          lds_f64_if(rv[j], newr[c], s_r + kl[c] * P.tp + p + 4 * j);
        }
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = X(p + 4 * j, jb[c]) * rv[j];
      dmma16(acc[c], a, b);
    }
  }
}

struct WideArgs {
  const void* x;
  const void* mask;
  const float* log_prior;
  const double* ufrag;   // (N, K, nfrag, 32, 2) U fragments (prep kernel)
  double* lse_mx;        // (N, T) the points' largest log rho (split)
  float* lse_den;        // (N, T) their softmax denominators (split)
  float* r_out;          // (N, T, K) or null
  double* s64;           // (N, K, ntri) upper triangle of sum r x' x'^T
  int T, K, D;
};

// MODE kFused: one block a node takes every component: log rho, the
// softmax and the statistics.  kLse: one block a node, every component in
// chunks of kq, writes the points' largest log rho and the softmax
// denominator (online over the chunks).  kSplit: block (n, y) takes the
// items wide_block gives it and reads the softmax's terms from kLse.
template <typename Tin, int MODE, bool XG>
__global__ void __launch_bounds__(kWideThreads, 1)
    gmm_estep_wide_kernel(WideArgs a, WidePlan P) {
  extern __shared__ __align__(16) unsigned char wsm[];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int n = blockIdx.x;
  const int T = a.T, K = a.K, D = a.D, tp = P.tp;
  const Tin* xn = static_cast<const Tin*>(a.x) + (size_t)n * T * D;
  const Tin* mn = static_cast<const Tin*>(a.mask) + (size_t)n * T;
  const float* lp = a.log_prior + (size_t)n * K;
  const double* U0 = a.ufrag + (size_t)n * K * P.nfrag * 64;
  double* s_xt = reinterpret_cast<double*>(wsm + P.off_xt);
  unsigned char* s_raw = wsm + P.off_raw;
  double* s_q = reinterpret_cast<double*>(wsm + P.off_q);
  float* s_m = reinterpret_cast<float*>(wsm + P.off_m);
  const int ntiles = (T + tp - 1) / tp;
  const int tpp = kWideThreads / tp;   // threads a point in the softmax
  const int sp = tid / tpp, sh = tid % tpp;
  const int esize = (int)sizeof(Tin);

  for (int y = blockIdx.y; y < (MODE == kSplit ? P.nby : 1);
       y += gridDim.y) {
    WideBlock B;
    if (MODE == kLse) {
      B.kbase = 0;
      B.nkb = K;
      B.lo = B.hi = 0;
      B.first = 0;
    } else {
      B = wide_block(P, K, y);
    }
    // this warp's statistics: chunk `chunk` of the block's items (csz
    // consecutive items, k-major), point group gi of G (the k-steps
    // gi * spg .. of each tile)
    const int nbi = B.hi - B.lo;
    int nchunk = 0, csz = 0, G = 1;
    if (MODE != kLse) wide_chunks(nbi, tp, nchunk, csz, G);
    const int chunk = warp / G, gi = warp % G;
    const int it0 = B.lo + chunk * csz;
    const int len = (MODE != kLse && chunk < nchunk)
                        ? wmin(B.hi, it0 + csz) - it0 : 0;
    const int spg = tp / 16 / G;   // k-steps of 16 points a group
    int kl0 = 0, I0 = 0, J0 = 0;
    if (len > 0) {
      kl0 = it0 / P.nitems - B.kbase;
      wide_item(P, it0 % P.nitems, I0, J0);
    }
    double acc[kWideItems][4];
#pragma unroll
    for (int c = 0; c < kWideItems; ++c)
      acc[c][0] = acc[c][1] = acc[c][2] = acc[c][3] = 0.0;
    // the block's U fragments, staged once when they fit
    const double* Ub = U0 + (size_t)B.kbase * P.nfrag * 64;
    if (MODE != kLse && P.su) {
      double* s_u = reinterpret_cast<double*>(wsm + P.off_u);
      for (int j = tid; j < B.nkb * P.nfrag * 64; j += kWideThreads)
        s_u[j] = Ub[j];
      Ub = s_u;
    }
    double* s_lp = reinterpret_cast<double*>(wsm + P.off_lp);
    if (MODE != kLse)
      for (int j = tid; j < B.nkb; j += kWideThreads)
        s_lp[j] = (double)lp[B.kbase + j];
    __syncthreads();

    // the x tile i -> raw buffer: cp.async of the 16-byte chunks, the
    // buffer offset by the span's misalignment so that both sides are
    // congruent mod 16; the head and tail elements and the mask through
    // registers, stored when the tile is converted
    float m_reg = 0.f;
    uint32_t pend = 0;
    int pend_at = -1;
    auto issue = [&](int i) {
      const int p0 = i * tp;
      const int valid = wmin(tp, T - p0);
      if constexpr (!XG) {
        const unsigned char* gsrc =
            reinterpret_cast<const unsigned char*>(xn + (size_t)p0 * D);
        const int bytes = valid * D * esize;
        const int mis = (int)(reinterpret_cast<uintptr_t>(gsrc) & 15);
        unsigned char* dst = s_raw + (i & 1) * P.raw + mis;
        const int head = wmin(bytes, (16 - mis) & 15);
        const int body = (bytes - head) / 16;
        for (int j = tid; j < body; j += kWideThreads)
          cp_async16(dst + head + 16 * j, gsrc + head + 16 * j);
        asm volatile("cp.async.commit_group;\n" ::);
        const int tail = bytes - head - 16 * body;
        pend_at = -1;
        if (tid < head / esize) {
          pend_at = (i & 1) * P.raw + mis + tid * esize;
        } else if (tid >= 8 && tid - 8 < tail / esize) {
          pend_at = (i & 1) * P.raw + mis + head + 16 * body +
                    (tid - 8) * esize;
        }
        if (pend_at >= 0) {
          const unsigned char* gp =
              gsrc + (pend_at - (i & 1) * P.raw - mis);
          pend = esize == 4 ? __ldg(reinterpret_cast<const uint32_t*>(gp))
                            : (uint32_t)__ldg(
                                  reinterpret_cast<const unsigned short*>(gp));
        }
        m_reg = tid < valid ? to_f32(mn[p0 + tid]) : 0.f;
      }
    };
    if (ntiles > 0) issue(0);
    for (int i = 0; i < ntiles; ++i) {
      const int p0 = i * tp;
      const int valid = wmin(tp, T - p0);
      WideX<Tin, XG> X{s_xt, P.xs, xn + (size_t)p0 * D, valid, D};
      if constexpr (!XG) {
        asm volatile("cp.async.wait_all;\n" ::: "memory");
        if (pend_at >= 0) {
          if (esize == 4)
            *reinterpret_cast<uint32_t*>(s_raw + pend_at) = pend;
          else
            *reinterpret_cast<unsigned short*>(s_raw + pend_at) =
                (unsigned short)pend;
        }
        if (tid < tp) s_m[tid] = m_reg;
        __syncthreads();   // the raw tile is in; the last tile is done
        // x' = (x, 1, 0, ...) in f64: warp w converts points w, w + 8, ...
        const unsigned char* gsrc =
            reinterpret_cast<const unsigned char*>(xn + (size_t)p0 * D);
        const int mis = (int)(reinterpret_cast<uintptr_t>(gsrc) & 15);
        const Tin* raw =
            reinterpret_cast<const Tin*>(s_raw + (i & 1) * P.raw + mis);
        // (four points by 64 columns a step, the loads first)
        const int wx = 16 * P.nI;
        for (int pw = warp; pw < tp; pw += 4 * kWideWarps) {
          for (int cb = 0; cb < wx; cb += 64) {
            float v[4][2];
#pragma unroll
            for (int j = 0; j < 4; ++j)
#pragma unroll
              for (int h = 0; h < 2; ++h) {
                const int pp = pw + j * kWideWarps, c = cb + lane + 32 * h;
                v[j][h] = (c < D && pp < valid) ? to_f32(raw[pp * D + c])
                                                : 0.f;
              }
#pragma unroll
            for (int j = 0; j < 4; ++j)
#pragma unroll
              for (int h = 0; h < 2; ++h) {
                const int pp = pw + j * kWideWarps, c = cb + lane + 32 * h;
                if (pp < tp && c < wx)
                  s_xt[pp * P.xs + c] = c == D ? 1.0 : (double)v[j][h];
              }
          }
        }
        __syncthreads();   // the f64 tile is in; its raw buffer is free
        if (i + 1 < ntiles) issue(i + 1);
      }

      if constexpr (MODE == kLse) {
        // every component in chunks of kq: q, then the online max and
        // denominator of each point (tpp threads a point, components
        // kk = sh, sh + tpp, ...; butterflies give every lane the same)
        double mx = -INFINITY;
        float den = 0.f;
        for (int c0 = 0; c0 < K; c0 += P.kq) {
          const int nc = wmin(P.kq, K - c0);
          wide_quad<Tin, XG>(P, X, U0 + (size_t)c0 * P.nfrag * 64, nc, s_q,
                             warp, lane);
          __syncthreads();
          double cm = -INFINITY;
          for (int kk = sh; kk < nc; kk += tpp) {
            const double lr = (double)lp[c0 + kk] - 0.5 * s_q[kk * tp + sp];
            s_q[kk * tp + sp] = lr;
            cm = fmax(cm, lr);
          }
          for (int o = 1; o < tpp; o <<= 1) cm = fmax(cm, wide_shfl(cm, o));
          const double mnew = fmax(mx, cm);
          float part = 0.f;
          for (int kk = sh; kk < nc; kk += tpp)
            part += expf((float)(s_q[kk * tp + sp] - mnew));
          for (int o = 1; o < tpp; o <<= 1)
            part += __shfl_xor_sync(0xffffffffu, part, o);
          den = den * expf((float)(mx - mnew)) + part;
          mx = mnew;
          __syncthreads();   // s_q is free for the next chunk
        }
        if (sh == 0 && sp < valid) {
          a.lse_mx[(size_t)n * T + p0 + sp] = mx;
          a.lse_den[(size_t)n * T + p0 + sp] = den;
        }
      } else {
        wide_quad<Tin, XG>(P, X, Ub, B.nkb, s_q, warp, lane);
        __syncthreads();   // q of every point and component is in
        // r of each point and component, in place of q (as f64)
        {
          const int pg = p0 + sp;
          float m;
          if constexpr (XG)
            m = sp < valid ? to_f32(mn[pg]) : 0.f;
          else
            m = s_m[sp];
          double mx;
          float den;
          if (MODE == kFused) {
            mx = -INFINITY;
            for (int kk = sh; kk < B.nkb; kk += tpp) {
              const double lr = s_lp[kk] - 0.5 * s_q[kk * tp + sp];
              s_q[kk * tp + sp] = lr;
              mx = fmax(mx, lr);
            }
            for (int o = 1; o < tpp; o <<= 1) mx = fmax(mx, wide_shfl(mx, o));
            den = 0.f;
            for (int kk = sh; kk < B.nkb; kk += tpp) {
              const float e = expf((float)(s_q[kk * tp + sp] - mx));
              s_q[kk * tp + sp] = (double)e;
              den += e;
            }
            for (int o = 1; o < tpp; o <<= 1)
              den += __shfl_xor_sync(0xffffffffu, den, o);
          } else {
            mx = sp < valid ? a.lse_mx[(size_t)n * T + pg] : 0.0;
            den = sp < valid ? a.lse_den[(size_t)n * T + pg] : 1.f;
            for (int kk = sh; kk < B.nkb; kk += tpp)
              s_q[kk * tp + sp] = (double)expf(
                  (float)(s_lp[kk] - 0.5 * s_q[kk * tp + sp] - mx));
          }
          // s_q holds e = exp(log rho - max) (exact in f64)
          for (int kk = sh; kk < B.nkb; kk += tpp) {
            const float r =
                sp < valid ? (float)s_q[kk * tp + sp] / den * m : 0.f;
            s_q[kk * tp + sp] = (double)r;
            if (a.r_out != nullptr && B.first && sp < valid)
              a.r_out[((size_t)n * T + pg) * K + B.kbase + kk] = r;
          }
        }
        __syncthreads();   // r is in
        // the statistics: per k-step (4 points, lane t's point 4 st + t)
        // the warp's items in order; A = r x'[rows 16 I ..] is formed
        // when (component, I) changes, B = x'[columns 8 J ..]
        switch (len) {
#define WIDE_STATS(LL)                                                    \
  case LL:                                                                \
    wide_stats_tile<LL, Tin, XG>(P, X, s_q, gi * spg, (gi + 1) * spg, t, \
                                 g, kl0, I0, J0, acc);                    \
    break;
          WIDE_STATS(1) WIDE_STATS(2) WIDE_STATS(3) WIDE_STATS(4)
          WIDE_STATS(5) WIDE_STATS(6) WIDE_STATS(7) WIDE_STATS(8)
          WIDE_STATS(9)
#undef WIDE_STATS
          default:
            break;
        }
      }
      if constexpr (XG) __syncthreads();   // s_q is free for the next tile
    }

    if constexpr (MODE != kLse) {
      // the point groups' partial sums, added in group order, then the
      // entries (i <= j < Dq) of each item written to s64
      __syncthreads();
      double* red = reinterpret_cast<double*>(wsm);
      if (len > 0) {
#pragma unroll
        for (int c = 0; c < kWideItems; ++c) {
          if (c < len) {
            double* o = red + ((chunk * G + gi) * kWideItems + c) * 128;
            o[g * 8 + 2 * t] = acc[c][0];
            o[g * 8 + 2 * t + 1] = acc[c][1];
            o[(g + 8) * 8 + 2 * t] = acc[c][2];
            o[(g + 8) * 8 + 2 * t + 1] = acc[c][3];
          }
        }
      }
      __syncthreads();
      for (int idx = tid; idx < nbi * 128; idx += kWideThreads) {
        const int it = B.lo + idx / 128, e = idx % 128;
        const int ch = (it - B.lo) / csz, c = (it - B.lo) % csz;
        double v = red[((ch * G) * kWideItems + c) * 128 + e];
        for (int gg = 1; gg < G; ++gg)
          v += red[((ch * G + gg) * kWideItems + c) * 128 + e];
        int I, J;
        wide_item(P, it % P.nitems, I, J);
        const int ri = 16 * I + e / 8, cj = 8 * J + e % 8;
        if (ri <= cj && cj < P.Dq)
          a.s64[((size_t)n * K + it / P.nitems) * P.ntri +
                (long long)ri * P.Dq - (long long)ri * (ri - 1) / 2 +
                (cj - ri)] = v;
      }
      __syncthreads();   // the next y reuses shared memory
    }
  }
}

// U_k of every (node, component): M = [[Wn, -v], [-v^T, cc]] with
// v = (Wn + Wn^T) s / 2 + b and cc = s^T Wn s + 2 s.b + c in f64 (so that
// x'^T M x' = y^T Wn y - 2 y.b + c for y = x - s), folded onto the blocks
// on and above the 8 x 8 diagonal (M_ij + M_ji above it), written in
// fragment order: fragment (J, s), s <= J, holds rows 8 s .. 8 s + 7 of
// columns 8 J .. 8 J + 7, lane 4 g + t rows 8 s + t and 8 s + t + 4 of
// column 8 J + g, adjacent.
__global__ void __launch_bounds__(256) gmm_estep_wide_prep_kernel(
    const float* __restrict__ Wn, const float* __restrict__ b,
    const float* __restrict__ c, const float* __restrict__ shift,
    double* __restrict__ v, double* __restrict__ ufrag, long long NK, int D,
    WidePlan P) {
  __shared__ double s_part[256];
  __shared__ double s_cc;
  for (long long pair = blockIdx.x; pair < NK; pair += gridDim.x) {
    const float* W = Wn + pair * D * D;
    const float* sk = shift != nullptr ? shift + pair * D : nullptr;
    double* vk = v + pair * D;
    double part = 0.0;
    for (int d = threadIdx.x; d < D; d += 256) {
      double acc = 0.0, sw = 0.0;
      for (int e = 0; e < D; ++e) {
        const double se = sk != nullptr ? (double)sk[e] : 0.0;
        const double wde = W[(size_t)d * D + e], wed = W[(size_t)e * D + d];
        acc = fma(wde + wed, se, acc);
        sw = fma(wde, se, sw);
      }
      const double sd = sk != nullptr ? (double)sk[d] : 0.0;
      const double bd = b[pair * D + d];
      vk[d] = 0.5 * acc + bd;
      part = fma(sd, sw + 2.0 * bd, part);
    }
    s_part[threadIdx.x] = part;
    __syncthreads();
    if (threadIdx.x == 0) {
      // threads past D hold exact zeros: the chain stops at D
      double cc = (double)c[pair];
      for (int i = 0; i < wmin(D, 256); ++i) cc += s_part[i];
      s_cc = cc;
    }
    __syncthreads();   // cc and v (global) are visible to the block
    const double cc = s_cc;
    double* uk = ufrag + pair * P.nfrag * 64;
    for (int idx = threadIdx.x; idx < P.nfrag * 64; idx += 256) {
      int f = idx >> 6, J = 0;
      while (f > J) {
        f -= J + 1;
        ++J;
      }
      const int l = (idx >> 1) & 31;
      const int i = 8 * f + (l & 3) + 4 * (idx & 1), j = 8 * J + (l >> 2);
      double u = 0.0;
      if (i < P.Dq && j < P.Dq) {
        auto M = [&](int r, int q) -> double {
          if (r < D && q < D) return (double)W[(size_t)r * D + q];
          if (r == D && q == D) return cc;
          return -vk[r == D ? q : r];
        };
        u = i / 8 < j / 8 ? M(i, j) + M(j, i) : M(i, j);
      }
      uk[idx] = u;
    }
    __syncthreads();   // s_part and s_cc are free
  }
}

// The statistics of each (node, component) from the upper triangle S of
// sum_t r x' x'^T (f64): R = S(D, D), sum_x = S(., D) - R s, sum_xx =
// S(i, j) - s_i Sx_j - Sx_i s_j + R s_i s_j with (i, j) = (min, max) (so
// that it is symmetric bit for bit), times rep, as f32 rows.
__global__ void __launch_bounds__(256) gmm_estep_wide_emit_kernel(
    const double* __restrict__ s64, const float* __restrict__ shift,
    float* __restrict__ stats, long long NK, int K, int D, float rep,
    int ntri) {
  const int Dq = D + 1;
  const int rows = K + K * D + K;
  auto tri = [&](int i, int j) {
    return (long long)i * Dq - (long long)i * (i - 1) / 2 + (j - i);
  };
  for (long long pair = blockIdx.x; pair < NK; pair += gridDim.x) {
    const long long n = pair / K;
    const int k = (int)(pair % K);
    const double* S = s64 + pair * ntri;
    const float* sk = shift != nullptr ? shift + pair * D : nullptr;
    const double R = S[tri(D, D)];
    float* out = stats + n * rows * D;
    const double r64 = (double)rep;
    for (int idx = threadIdx.x; idx < D + D * D + D; idx += 256) {
      if (idx < D) {
        const double s = sk != nullptr ? (double)sk[idx] : 0.0;
        out[(size_t)k * D + idx] = (float)((S[tri(idx, D)] - R * s) * r64);
      } else if (idx < D + D * D) {
        const int q = idx - D, d = q / D, e = q % D;
        const int i = wmin(d, e), j = wmax(d, e);
        const double si = sk != nullptr ? (double)sk[i] : 0.0;
        const double sj = sk != nullptr ? (double)sk[j] : 0.0;
        const double val = S[tri(i, j)] - si * S[tri(j, D)] -
                           S[tri(i, D)] * sj + R * si * sj;
        out[((size_t)K + (size_t)k * D + d) * D + e] = (float)(val * r64);
      } else {
        const int e = idx - D - D * D;
        out[((size_t)K + (size_t)K * D + k) * D + e] =
            e == 0 ? (float)(R * r64) : 0.f;
      }
    }
  }
}

// the workspace: U fragments, v, the statistics' upper triangles and, when
// a node takes several blocks, the softmax terms; each part 256-aligned
struct WideWork {
  size_t ufrag, v, s64, mx, den, total;
};

__host__ __device__ inline size_t wide_align(size_t b) {
  return (b + 255) / 256 * 256;
}

inline WideWork wide_work(long long N, long long T, int K, int D,
                          const WidePlan& P) {
  WideWork w;
  const long long NK = N * K;
  size_t o = 0;
  w.ufrag = o;
  o += wide_align((size_t)NK * P.nfrag * 64 * 8);
  w.v = o;
  o += wide_align((size_t)NK * D * 8);
  w.s64 = o;
  o += wide_align((size_t)NK * P.ntri * 8);
  w.mx = o;
  o += P.nby > 1 ? wide_align((size_t)N * T * 8) : 0;
  w.den = o;
  o += P.nby > 1 ? wide_align((size_t)N * T * 4) : 0;
  w.total = o;
  return w;
}

template <typename Tin, int MODE>
cudaError_t launch_wide_main(const WideArgs& a, const WidePlan& P, int N,
                             cudaStream_t stream) {
  auto kern = P.xg ? gmm_estep_wide_kernel<Tin, MODE, true>
                   : gmm_estep_wide_kernel<Tin, MODE, false>;
  if (P.smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, P.smem);
    if (e != cudaSuccess) return e;
  }
  const dim3 grid(N, MODE == kSplit ? wmin(P.nby, 65535) : 1);
  kern<<<grid, kWideThreads, P.smem, stream>>>(a, P);
  return cudaGetLastError();
}

template <typename Tin>
cudaError_t launch_wide(const void* x, const void* mask,
                        const void* log_prior, const void* Wn, const void* b,
                        const void* c, const void* shift, void* r,
                        void* stats, void* work, int N, int T, int K, int D,
                        float rep, cudaStream_t stream) {
  const WidePlan P = wide_plan(K, D, (int)sizeof(Tin));
  const WideWork w = wide_work(N, T, K, D, P);
  unsigned char* base = static_cast<unsigned char*>(work);
  const long long NK = (long long)N * K;
  const int blocks = (int)(NK < (1 << 20) ? NK : (1 << 20));
  double* ufrag = reinterpret_cast<double*>(base + w.ufrag);
  double* s64 = reinterpret_cast<double*>(base + w.s64);
  gmm_estep_wide_prep_kernel<<<blocks, 256, 0, stream>>>(
      static_cast<const float*>(Wn), static_cast<const float*>(b),
      static_cast<const float*>(c), static_cast<const float*>(shift),
      reinterpret_cast<double*>(base + w.v), ufrag, NK, D, P);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  WideArgs a{x, mask, static_cast<const float*>(log_prior), ufrag,
             reinterpret_cast<double*>(base + w.mx),
             reinterpret_cast<float*>(base + w.den), static_cast<float*>(r),
             s64, T, K, D};
  if (P.nby == 1) {
    e = launch_wide_main<Tin, kFused>(a, P, N, stream);
  } else {
    e = launch_wide_main<Tin, kLse>(a, P, N, stream);
    if (e == cudaSuccess) e = launch_wide_main<Tin, kSplit>(a, P, N, stream);
  }
  if (e != cudaSuccess) return e;
  gmm_estep_wide_emit_kernel<<<blocks, 256, 0, stream>>>(
      s64, static_cast<const float*>(shift), static_cast<float*>(stats), NK,
      K, D, rep, P.ntri);
  return cudaGetLastError();
}


// ===========================================================================
// Shared-memory path: D <= 8, the (K, D) past the register budget
// ===========================================================================
// repro_torch/kernels/gmm_estep.py mirrors these (SHARED_THREADS,
// SHARED_STEP, SHARED_RT, shared_cbmax) and checks its plan against
// gmm_estep_shared_plan.
constexpr int kSmThreads = 256;
constexpr int kSmWarps = kSmThreads / 32;
constexpr int kSmStep = 16;   // points a warp takes at a time
constexpr int kSmRt = 20;     // row stride (floats) of a warp's r transpose

// component blocks of 8 whose statistics a warp holds in registers: the
// kernel instances take 1 or this many
__host__ __device__ constexpr int sm_cbmax(int D) { return D <= 4 ? 4 : 2; }

// x' = (x, 1) and its features phi = the upper triangle of x' x'^T, row
// by row (feature (i, j), i <= j <= D, at i (D + 1) - i (i - 1) / 2 +
// j - i; the last, (D, D), is 1): F of them, NS k-steps of 8 (log rho,
// m16n8k8), NF row blocks of 16 (the statistics, m16n8k16), XS = 16 NF + 4
// doubles a row of a warp's phi tile
template <int D>
struct SmShape {
  static constexpr int F = (D + 1) * (D + 2) / 2;
  static constexpr int NS = (F + 7) / 8;
  static constexpr int NF = (F + 15) / 16;
  static constexpr int XS = 16 * NF + 4;
};

// The shared path's plan at (K, D), x's element size and block_t (points
// staged a tile): ncb component blocks of 8; an instance holding cbm of
// them a warp (1, or sm_cbmax(D) when ncb > 1); when ncb > cbm the node
// takes an lse pass and npass statistics passes of cbm blocks, else one
// fused pass.  Shared memory: the u fragments of every block, then a
// region (the warps' phi tiles, r transposes and, when cbm > 1, log rho
// of their blocks, two raw x tiles, two mask tiles) reused at the end of
// a pass for the warps' statistics.
struct SmPlan {
  int F, NS, NF, XS, ncb, cbm, chunked, npass, raw;
  int off_u, off_phi, off_rt, off_lr, off_raw, off_m, smem;
};

__host__ __device__ inline SmPlan sm_plan(int K, int D, int esize,
                                          int block_t) {
  SmPlan P;
  P.F = (D + 1) * (D + 2) / 2;
  P.NS = (P.F + 7) / 8;
  P.NF = (P.F + 15) / 16;
  P.XS = 16 * P.NF + 4;
  P.ncb = (K + 7) / 8;
  P.cbm = P.ncb <= 1 ? 1 : sm_cbmax(D);
  P.chunked = P.ncb > P.cbm;
  P.npass = (P.ncb + P.cbm - 1) / P.cbm;
  P.raw = (block_t * D * esize + 15) / 16 * 16 + 16;
  int o = 0;
  P.off_u = o;
  o += P.ncb * P.NS * 512;
  const int region = o;
  P.off_phi = o;
  o += kSmWarps * (kSmStep * P.XS + 4) * 8;
  P.off_rt = o;
  o += kSmWarps * (P.cbm * 8 * kSmRt + kSmStep) * 4;
  P.off_lr = o;
  o += P.cbm > 1 ? kSmWarps * P.cbm * 128 * 8 : 0;
  P.off_raw = o;
  o += 2 * P.raw;
  P.off_m = o;
  o += 2 * block_t * 4;
  P.smem = wmax(o, region + kSmWarps * P.cbm * P.NF * 128 * 8);
  return P;
}

// row p (< 16) of a warp's phi tile starts at p XS + p / 4 doubles: with
// XS = 4 mod 16 the conversion's stores (a point a lane), log rho's
// fragment loads (rows g, g + 8, columns 8 s + t) and the statistics'
// (rows t + 4 q, columns 16 fb + g) all fall in distinct banks, and every
// column offset is a constant
__host__ __device__ inline int sm_row(int p, int XS) {
  return p * XS + (p >> 2);
}

struct SmArgs {
  const void* x;
  const void* mask;
  const float *log_prior, *Wn, *b, *c, *shift;
  float* r_out;     // (N, T, K) or null
  float* stats;     // (N, K + K D + K, D)
  double* lse_mx;   // (N, T) the points' largest log rho (chunked)
  float* lse_den;   // (N, T) their softmax denominators (chunked)
  int T, K, block_t;
  float rep;
};

// u_k . phi(x) = log rho of component k: feature (i, j) of u_k is
// -(M_ij + M_ji) / 2 above the diagonal and -M_ii / 2 on it, for M =
// [[Wn, -v], [-v^T, cc]], v = (Wn + Wn^T) s / 2 + b, cc = s^T Wn s + 2 s.b
// + c, plus log_prior at (D, D); in f64 (the expanded form cancels in f32)
template <int D>
__device__ double sm_u(const SmArgs& a, int n, int k, int f) {
  int i = 0, row = D + 1;
  while (f >= row) {
    f -= row;
    ++i;
    --row;
  }
  const int j = i + f;
  const size_t nk = (size_t)n * a.K + k;
  const float* W = a.Wn + nk * D * D;
  const float* bk = a.b + nk * D;
  const float* s = a.shift != nullptr ? a.shift + nk * D : nullptr;
  if (j < D)
    return i == j ? -0.5 * (double)W[i * D + i]
                  : -0.5 * ((double)W[i * D + j] + (double)W[j * D + i]);
  if (i < D) {
    double v = 0.0;
    if (s != nullptr)
      for (int e = 0; e < D; ++e)
        v = fma(0.5 * ((double)W[i * D + e] + (double)W[e * D + i]),
                (double)s[e], v);
    return v + (double)bk[i];
  }
  double cc = (double)a.c[nk];
  if (s != nullptr)
    for (int d = 0; d < D; ++d) {
      double sw = 0.0;
      for (int e = 0; e < D; ++e)
        sw = fma((double)W[d * D + e], (double)s[e], sw);
      cc = fma((double)s[d], sw + 2.0 * (double)bk[d], cc);
    }
  return (double)a.log_prior[nk] - 0.5 * cc;
}

// log rho of the 16 points of a warp's phi tile and the 8 components of
// block cb: m16n8k8 products of A = phi (points x features) by B = u (the
// block's fragments in shared memory), NS k-steps in order.  lr[e] is
// point g + 8 (e >> 1), component 8 cb + 2 t + (e & 1); past K, -inf.
template <int D>
__device__ __forceinline__ void sm_log_rho(const double* s_phi,
                                           const double* s_u, int cb, int K,
                                           int lane, double (&lr)[4]) {
  using S = SmShape<D>;
  const int g = lane >> 2, t = lane & 3;
  const double* r0 = s_phi + sm_row(g, S::XS) + t;
  const double* r8 = s_phi + sm_row(g + 8, S::XS) + t;
  const double* u = s_u + (size_t)cb * S::NS * 64 + 2 * lane;
  lr[0] = lr[1] = lr[2] = lr[3] = 0.0;
#pragma unroll
  for (int s = 0; s < S::NS; ++s) {
    double af[4];
    af[0] = r0[8 * s];
    af[1] = r8[8 * s];
    if (8 * s + 4 < S::F) {
      af[2] = r0[8 * s + 4];
      af[3] = r8[8 * s + 4];
    } else {
      af[2] = af[3] = 0.0;
    }
    const double2 b = *reinterpret_cast<const double2*>(u + s * 64);
    dmma8(lr, af, b.x, b.y);
  }
  if (8 * (cb + 1) > K)   // the last block: part padding
#pragma unroll
    for (int e = 0; e < 4; ++e)
      if (8 * cb + 2 * t + (e & 1) >= K) lr[e] = -INFINITY;
}

__device__ __forceinline__ double sm_max(double a, double b) {
  return a > b ? a : b;
}

// the online softmax terms (running max m, denominator d) after value v
__device__ __forceinline__ void sm_online(double& m, float& d, double v) {
  if (v > m) {
    d = d * expf((float)(m - v)) + 1.f;
    m = v;
  } else {
    d += expf((float)(v - m));
  }
}

// One block of kSmWarps warps a node.  The node's points come in tiles of
// block_t (cp.async into a double buffer, one barrier a tile); warp w
// takes the tile's 16-point steps w, w + 8, ...: it converts its points
// to phi rows in its own f64 tile, forms log rho once a point and
// component on the FP64 tensor cores, the softmax in registers, passes r
// through a small transpose in shared memory, and adds sum_t r_tk phi(x_t)
// (m16n8k16: A = phi^T, features x points; B = r, points x components)
// into statistics fragments held across all of the node's tiles.  At the
// end of a pass the warps' statistics are added in warp order and
// emitted, centred on the shift in f64.  When the node's component blocks
// exceed the instance's CBM, an lse pass first writes each point's
// largest log rho and softmax denominator (online over the blocks) and
// each statistics pass takes CBM blocks.
template <int D, typename Tin, int CBM>
__global__ void __launch_bounds__(kSmThreads, D <= 4 ? 2 : 1)
    gmm_estep_smem_kernel(SmArgs a, SmPlan P) {
  using S = SmShape<D>;
  extern __shared__ __align__(16) unsigned char ssm[];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int n = blockIdx.x;
  const int T = a.T, K = a.K, bt = a.block_t;
  const Tin* xn = static_cast<const Tin*>(a.x) + (size_t)n * T * D;
  const Tin* mn = static_cast<const Tin*>(a.mask) + (size_t)n * T;
  double* s_u = reinterpret_cast<double*>(ssm + P.off_u);
  double* s_phi = reinterpret_cast<double*>(ssm + P.off_phi) +
                  warp * (kSmStep * S::XS + 4);
  // a warp's softmax area: e of its blocks (component rows, point
  // columns), then each point's mask / denominator; and, when it holds
  // several blocks, their log rho (fragment order)
  float* s_rt = reinterpret_cast<float*>(ssm + P.off_rt) +
                warp * (CBM * 8 * kSmRt + kSmStep);
  float* s_inv = s_rt + CBM * 8 * kSmRt;
  double* s_lr = reinterpret_cast<double*>(ssm + P.off_lr) + warp * CBM * 128;
  unsigned char* s_raw = ssm + P.off_raw;
  float* s_m = reinterpret_cast<float*>(ssm + P.off_m);
  double* red = reinterpret_cast<double*>(ssm + P.off_phi);
  const int ntiles = (T + bt - 1) / bt;
  const int esize = (int)sizeof(Tin);
  // an lse pass and passes of CBM blocks (never when a warp holds one)
  const bool chunked = CBM > 1 && P.chunked;

  // u in fragment order: block cb, k-step s, lane 4 g + t holds features
  // 8 s + t and 8 s + t + 4 of component 8 cb + g (zero past K and F)
  for (int idx = tid; idx < P.ncb * S::NS * 64; idx += kSmThreads) {
    const int cb = idx / (S::NS * 64), rem = idx % (S::NS * 64);
    const int l = (rem >> 1) & 31;
    const int k = 8 * cb + (l >> 2);
    const int f = 8 * (rem / 64) + (l & 3) + 4 * (rem & 1);
    s_u[idx] = (k < K && f < S::F) ? sm_u<D>(a, n, k, f) : 0.0;
  }

  // the x tile i -> raw buffer i & 1, as the wide path: cp.async of the
  // 16-byte chunks (both sides congruent mod 16), the head and tail
  // elements and the mask through registers, stored after the wait
  float m_reg[4];
  uint32_t pend = 0;
  int pend_at = -1;
  auto issue = [&](int i) {
    const int p0 = i * bt;
    const int valid = wmin(bt, T - p0);
    const unsigned char* gsrc =
        reinterpret_cast<const unsigned char*>(xn + (size_t)p0 * D);
    const int bytes = valid * D * esize;
    const int mis = (int)(reinterpret_cast<uintptr_t>(gsrc) & 15);
    unsigned char* dst = s_raw + (i & 1) * P.raw + mis;
    const int head = wmin(bytes, (16 - mis) & 15);
    const int body = (bytes - head) / 16;
    for (int j = tid; j < body; j += kSmThreads)
      cp_async16(dst + head + 16 * j, gsrc + head + 16 * j);
    asm volatile("cp.async.commit_group;\n" ::);
    const int tail = bytes - head - 16 * body;
    pend_at = -1;
    if (tid < head / esize) {
      pend_at = (i & 1) * P.raw + mis + tid * esize;
    } else if (tid >= 8 && tid - 8 < tail / esize) {
      pend_at = (i & 1) * P.raw + mis + head + 16 * body + (tid - 8) * esize;
    }
    if (pend_at >= 0) {
      const unsigned char* gp = gsrc + (pend_at - (i & 1) * P.raw - mis);
      pend = esize == 4
                 ? __ldg(reinterpret_cast<const uint32_t*>(gp))
                 : (uint32_t)__ldg(reinterpret_cast<const unsigned short*>(gp));
    }
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int p = tid + kSmThreads * q;
      m_reg[q] = p < valid ? to_f32(mn[p0 + p]) : 0.f;
    }
  };

  for (int pass = chunked ? -1 : 0; pass < P.npass; ++pass) {
    const int cb0 = pass < 0 ? 0 : pass * CBM;
    const int ncp = pass < 0 ? P.ncb : wmin(CBM, P.ncb - cb0);
    __syncthreads();   // u is in; the last pass's emit is done with red
    // this warp's phi rows (the columns of features past F stay zero)
    for (int i = lane; i < kSmStep * S::XS + 4; i += 32) s_phi[i] = 0.0;
    double acc[CBM][S::NF][4];
#pragma unroll
    for (int cb = 0; cb < CBM; ++cb)
#pragma unroll
      for (int fb = 0; fb < S::NF; ++fb)
        acc[cb][fb][0] = acc[cb][fb][1] = acc[cb][fb][2] = acc[cb][fb][3] =
            0.0;
    if (ntiles > 0) issue(0);
    for (int i = 0; i < ntiles; ++i) {
      asm volatile("cp.async.wait_all;\n" ::: "memory");
      if (pend_at >= 0) {
        if (esize == 4)
          *reinterpret_cast<uint32_t*>(s_raw + pend_at) = pend;
        else
          *reinterpret_cast<unsigned short*>(s_raw + pend_at) =
              (unsigned short)pend;
      }
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int p = tid + kSmThreads * q;
        if (p < bt) s_m[(i & 1) * bt + p] = m_reg[q];
      }
      __syncthreads();   // tile i is in; every warp is done with tile i - 1
      if (i + 1 < ntiles) issue(i + 1);
      const int p0 = i * bt, valid = wmin(bt, T - p0);
      const int mis =
          (int)(reinterpret_cast<uintptr_t>(xn + (size_t)p0 * D) & 15);
      const Tin* raw =
          reinterpret_cast<const Tin*>(s_raw + (i & 1) * P.raw + mis);
      const float* msk = s_m + (i & 1) * bt;
      for (int j = warp; j * kSmStep < valid; j += kSmWarps) {
        const int pl = j * kSmStep;   // the step's first point in the tile
        const int nv = valid - pl;    // the step's points before T
        const size_t pg = (size_t)n * T + p0 + pl;
        // phi of the step's points: lane p < 16 converts point p (exact
        // products of f32 values in f64)
        __syncwarp();
        if (lane < kSmStep) {
          double xv[D + 1];
#pragma unroll
          for (int d = 0; d < D; ++d)
            xv[d] = lane < nv ? (double)to_f32(raw[(pl + lane) * D + d])
                              : 0.0;
          xv[D] = 1.0;
          double* row = s_phi + sm_row(lane, S::XS);
          int f = 0;
#pragma unroll
          for (int ii = 0; ii <= D; ++ii)
#pragma unroll
            for (int jj = ii; jj <= D; ++jj, ++f) row[f] = xv[ii] * xv[jj];
        }
        __syncwarp();
        if (chunked && pass < 0) {
          // the lse pass: every block, online in each lane, then over the
          // four lanes of a point (t)
          double m0 = -INFINITY, m1 = -INFINITY;
          float d0 = 0.f, d1 = 0.f;
          for (int cb = 0; cb < P.ncb; ++cb) {
            double lr[4];
            sm_log_rho<D>(s_phi, s_u, cb, K, lane, lr);
#pragma unroll
            for (int e = 0; e < 4; ++e)
              if (8 * cb + 2 * t + (e & 1) < K) {
                if (e < 2)
                  sm_online(m0, d0, lr[e]);
                else
                  sm_online(m1, d1, lr[e]);
              }
          }
#pragma unroll
          for (int o = 1; o < 4; o <<= 1) {
            const double om0 = wide_shfl(m0, o), om1 = wide_shfl(m1, o);
            const float od0 = __shfl_xor_sync(0xffffffffu, d0, o);
            const float od1 = __shfl_xor_sync(0xffffffffu, d1, o);
            const double M0 = sm_max(m0, om0), M1 = sm_max(m1, om1);
            d0 = d0 * expf((float)(m0 - M0)) + od0 * expf((float)(om0 - M0));
            d1 = d1 * expf((float)(m1 - M1)) + od1 * expf((float)(om1 - M1));
            m0 = M0;
            m1 = M1;
          }
          if (g < nv) {
            a.lse_mx[pg + g] = m0;
            a.lse_den[pg + g] = d0;
          }
          if (g + 8 < nv) {
            a.lse_mx[pg + g + 8] = m1;
            a.lse_den[pg + g + 8] = d1;
          }
          continue;
        }
        // each point's largest log rho over the blocks (chunked: over all
        // components, the lse pass's), then e = exp(log rho - max) into
        // the warp's transpose with the lane's share of the denominator;
        // a warp holding several blocks keeps their log rho in its shared
        // memory meanwhile, not in registers
        double mx0 = 0.0, mx1 = 0.0;
        double lr[4];
        if (chunked) {
          if (g < nv) mx0 = a.lse_mx[pg + g];
          if (g + 8 < nv) mx1 = a.lse_mx[pg + g + 8];
        } else {
          mx0 = mx1 = -INFINITY;
#pragma unroll
          for (int cb = 0; cb < CBM; ++cb) {
            if (cb < ncp) {
              sm_log_rho<D>(s_phi, s_u, cb0 + cb, K, lane, lr);
              mx0 = sm_max(mx0, sm_max(lr[0], lr[1]));
              mx1 = sm_max(mx1, sm_max(lr[2], lr[3]));
              if (CBM > 1)
#pragma unroll
                for (int e = 0; e < 4; ++e)
                  s_lr[(cb * 4 + e) * 32 + lane] = lr[e];
            }
          }
          mx0 = sm_max(mx0, wide_shfl(mx0, 1));
          mx0 = sm_max(mx0, wide_shfl(mx0, 2));
          mx1 = sm_max(mx1, wide_shfl(mx1, 1));
          mx1 = sm_max(mx1, wide_shfl(mx1, 2));
        }
        float sd0 = 0.f, sd1 = 0.f;
#pragma unroll
        for (int cb = 0; cb < CBM; ++cb) {
          if (cb < ncp) {
            if (chunked) {
              sm_log_rho<D>(s_phi, s_u, cb0 + cb, K, lane, lr);
            } else if (CBM > 1) {
#pragma unroll
              for (int e = 0; e < 4; ++e)
                lr[e] = s_lr[(cb * 4 + e) * 32 + lane];
            }
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const float ev = expf((float)(lr[e] - (e < 2 ? mx0 : mx1)));
              s_rt[(cb * 8 + 2 * t + (e & 1)) * kSmRt + g + 8 * (e >> 1)] =
                  ev;
              if (e < 2)
                sd0 += ev;
              else
                sd1 += ev;
            }
          }
        }
        // mask / denominator of each point (chunked: the lse pass's)
        float den0 = 1.f, den1 = 1.f;
        if (chunked) {
          if (g < nv) den0 = a.lse_den[pg + g];
          if (g + 8 < nv) den1 = a.lse_den[pg + g + 8];
        } else {
          sd0 += __shfl_xor_sync(0xffffffffu, sd0, 1);
          sd0 += __shfl_xor_sync(0xffffffffu, sd0, 2);
          sd1 += __shfl_xor_sync(0xffffffffu, sd1, 1);
          sd1 += __shfl_xor_sync(0xffffffffu, sd1, 2);
          den0 = sd0;
          den1 = sd1;
        }
        if (t == 0) {
          s_inv[g] = __fdividef(msk[pl + g], den0);
          s_inv[g + 8] = __fdividef(msk[pl + g + 8], den1);
        }
        __syncwarp();
        // r of points t + 4 q (B's rows) and component 8 cb + g (its
        // column), formed where a product needs it
        const float* rt = s_rt + g * kSmRt + t;
        const float* iv = s_inv + t;
        if (a.r_out != nullptr) {
#pragma unroll
          for (int cb = 0; cb < CBM; ++cb)
#pragma unroll
            for (int q = 0; q < 4; ++q) {
              const int k = 8 * (cb0 + cb) + g, p = t + 4 * q;
              if (cb < ncp && p < nv && k < K)
                a.r_out[(pg + p) * K + k] =
                    rt[cb * 8 * kSmRt + 4 * q] * iv[4 * q];
            }
        }
        // the statistics: A = phi^T (features 16 fb + g and + 8 of points
        // t + 4 q), B = r
#pragma unroll
        for (int fb = 0; fb < S::NF; ++fb) {
          double a2[8];
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            const double* row = s_phi + sm_row(t + 4 * q, S::XS) + g;
            a2[2 * q] = row[16 * fb];
            a2[2 * q + 1] = 16 * fb + 8 < S::F ? row[16 * fb + 8] : 0.0;
          }
#pragma unroll
          for (int cb = 0; cb < CBM; ++cb) {
            if (cb < ncp) {
              double rb[4];
#pragma unroll
              for (int q = 0; q < 4; ++q)
                rb[q] = (double)(rt[cb * 8 * kSmRt + 4 * q] * iv[4 * q]);
              dmma16(acc[cb][fb], a2, rb);
            }
          }
        }
      }
    }
    if (pass < 0) continue;

    // the warps' statistics added in warp order: entry (cb, fb, e, lane)
    // is feature 16 fb + g + 8 (e >> 1) of component 8 cb + 2 t + (e & 1)
    __syncthreads();   // every warp is done with the pass's tiles
    const int per = S::NF * 128;
#pragma unroll
    for (int cb = 0; cb < CBM; ++cb)
      if (cb < ncp)
#pragma unroll
        for (int fb = 0; fb < S::NF; ++fb)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            red[(warp * CBM + cb) * per + fb * 128 + e * 32 + lane] =
                acc[cb][fb][e];
    __syncthreads();
    for (int idx = tid; idx < ncp * per; idx += kSmThreads) {
      const int cb = idx / per, rem = idx % per;
      double v = red[cb * per + rem];
      for (int w = 1; w < kSmWarps; ++w) v += red[(w * CBM + cb) * per + rem];
      red[cb * per + rem] = v;
    }
    __syncthreads();
    // emit the pass's components, centred on the shift in f64, times rep
    auto Sv = [&](int kl, int i, int j) {   // S_k(i, j), i <= j <= D
      const int f = i * (D + 1) - i * (i - 1) / 2 + (j - i);
      const int kk = kl & 7, fr = f & 15;
      return red[(kl >> 3) * per + (f >> 4) * 128 +
                 (2 * (fr >> 3) + (kk & 1)) * 32 + 4 * (fr & 7) + (kk >> 1)];
    };
    const int rows = K + K * D + K;
    float* out = a.stats + (size_t)n * rows * D;
    const int k0 = 8 * cb0, nk = wmin(K, 8 * (cb0 + ncp)) - k0;
    const int per_k = D + D * D + D;
    const double rep = (double)a.rep;
    for (int idx = tid; idx < nk * per_k; idx += kSmThreads) {
      const int kl = idx / per_k, o = idx % per_k, k = k0 + kl;
      const float* sk =
          a.shift != nullptr ? a.shift + ((size_t)n * K + k) * D : nullptr;
      const double R = Sv(kl, D, D);
      if (o < D) {
        const double s = sk != nullptr ? (double)sk[o] : 0.0;
        out[(size_t)k * D + o] = (float)((Sv(kl, o, D) - R * s) * rep);
      } else if (o < D + D * D) {
        const int q = o - D, d = q / D, e = q % D;
        const int i = wmin(d, e), j = wmax(d, e);
        const double si = sk != nullptr ? (double)sk[i] : 0.0;
        const double sj = sk != nullptr ? (double)sk[j] : 0.0;
        const double val = Sv(kl, i, j) - si * Sv(kl, j, D) -
                           Sv(kl, i, D) * sj + R * si * sj;
        out[((size_t)K + (size_t)k * D + d) * D + e] = (float)(val * rep);
      } else {
        const int e = o - D - D * D;
        out[((size_t)K + (size_t)K * D + k) * D + e] =
            e == 0 ? (float)(R * rep) : 0.f;
      }
    }
  }
}

template <int D, typename Tin, int CBM>
cudaError_t launch_smem_inst(const SmArgs& a, const SmPlan& P, int N,
                             cudaStream_t stream) {
  auto kern = gmm_estep_smem_kernel<D, Tin, CBM>;
  if (P.smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, P.smem);
    if (e != cudaSuccess) return e;
  }
  kern<<<N, kSmThreads, P.smem, stream>>>(a, P);
  return cudaGetLastError();
}

// bytes of the shared path's device workspace: the lse pass's terms when a
// node's components take several passes (256-aligned parts), else none
inline size_t sm_work_bytes(long long N, long long T, const SmPlan& P) {
  return P.chunked ? wide_align((size_t)N * T * 8) +
                         wide_align((size_t)N * T * 4)
                   : 0;
}

template <int D, typename Tin>
cudaError_t launch_smem(const void* x, const void* mask,
                        const void* log_prior, const void* Wn, const void* b,
                        const void* c, const void* shift, void* r, void* stats,
                        void* work, int N, int T, int K, int block_t,
                        float rep, int smem_bytes, cudaStream_t stream) {
  const SmPlan P = sm_plan(K, D, (int)sizeof(Tin), block_t);
  if (P.smem != smem_bytes || P.smem > kWideSmem ||
      (P.chunked && work == nullptr))
    return cudaErrorInvalidValue;
  unsigned char* base = static_cast<unsigned char*>(work);
  SmArgs a{x, mask, static_cast<const float*>(log_prior),
           static_cast<const float*>(Wn), static_cast<const float*>(b),
           static_cast<const float*>(c), static_cast<const float*>(shift),
           static_cast<float*>(r), static_cast<float*>(stats),
           P.chunked ? reinterpret_cast<double*>(base) : nullptr,
           P.chunked ? reinterpret_cast<float*>(
                           base + wide_align((size_t)N * T * 8))
                     : nullptr,
           T, K, block_t, rep};
  if (P.cbm == 1) return launch_smem_inst<D, Tin, 1>(a, P, N, stream);
  return launch_smem_inst<D, Tin, sm_cbmax(D)>(a, P, N, stream);
}


template <int D, typename Tin>
cudaError_t launch(int variant, const void* x, const void* mask,
                   const void* log_prior, const void* Wn, const void* b,
                   const void* c, const void* shift, void* r, void* stats,
                   void* work, int N, int T, int K, int block_t, float rep,
                   int smem_bytes, int vec, cudaStream_t stream) {
  if (variant == 0) {
    if constexpr (RegShape<D>::KMAX > 0) {
      if (K > RegShape<D>::KMAX) return cudaErrorInvalidValue;
      gmm_estep_regs_kernel<D, Tin><<<N, kThreads, 0, stream>>>(
          static_cast<const Tin*>(x), static_cast<const Tin*>(mask),
          static_cast<const float*>(log_prior), static_cast<const float*>(Wn),
          static_cast<const float*>(b), static_cast<const float*>(c),
          static_cast<const float*>(shift), static_cast<float*>(r),
          static_cast<float*>(stats), T, K, rep, vec);
      return cudaGetLastError();
    }
    return cudaErrorInvalidValue;
  }
  return launch_smem<D, Tin>(x, mask, log_prior, Wn, b, c, shift, r, stats,
                             work, N, T, K, block_t, rep, smem_bytes, stream);
}

}  // namespace

// Plain C entry point (bound with ctypes).  x and mask are f32 (x_bf16 = 0)
// or bf16 (x_bf16 = 1); every other array is f32; shift and r may be null.
// variant 0 launches gmm_estep_regs_kernel (K <= gmm_estep_reg_kmax(D);
// `vec` = 1 allows its vector loads: T % 4 == 0 and x, mask 16-byte
// aligned), variant 1 gmm_estep_smem_kernel (block_t points a tile;
// smem_bytes must be its plan's, gmm_estep_shared_plan; `work` a device
// workspace of gmm_estep_shared_workspace_bytes when that is not 0),
// variant 2 the wide path (any K and D; block_t and smem_bytes unused;
// `work` is a device workspace of gmm_estep_wide_workspace_bytes).  The
// caller validates shapes, allocates the outputs and passes the stream.
// Returns the cudaError_t of the launches (0 = success).
extern "C" int gmm_estep_nodes_launch(
    const void* x, const void* mask, const void* log_prior, const void* Wn,
    const void* b, const void* c, const void* shift, void* r, void* stats,
    int N, int T, int K, int D, int block_t, float rep, int x_bf16,
    int smem_bytes, int variant, int vec, void* stream, void* work) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (variant == 2)
    return x_bf16 ? (int)launch_wide<__nv_bfloat16>(
                        x, mask, log_prior, Wn, b, c, shift, r, stats, work,
                        N, T, K, D, rep, s)
                  : (int)launch_wide<float>(x, mask, log_prior, Wn, b, c,
                                            shift, r, stats, work, N, T, K,
                                            D, rep, s);
#define GMM_CASE(DD)                                                        \
  case DD:                                                                  \
    return x_bf16 ? (int)launch<DD, __nv_bfloat16>(                         \
                        variant, x, mask, log_prior, Wn, b, c, shift, r,    \
                        stats, work, N, T, K, block_t, rep, smem_bytes,     \
                        vec, s)                                             \
                  : (int)launch<DD, float>(variant, x, mask, log_prior, Wn, \
                                           b, c, shift, r, stats, work, N,  \
                                           T, K, block_t, rep, smem_bytes,  \
                                           vec, s);
  switch (D) {
    GMM_CASE(1)
    GMM_CASE(2)
    GMM_CASE(3)
    GMM_CASE(4)
    GMM_CASE(5)
    GMM_CASE(6)
    GMM_CASE(7)
    GMM_CASE(8)
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef GMM_CASE
}

// The register path's largest K at dimension D (0 for an unsupported D);
// the wrapper checks its own dispatch rule against it.
extern "C" int gmm_estep_reg_kmax(int D) {
  switch (D) {
    case 1: return RegShape<1>::KMAX;
    case 2: return RegShape<2>::KMAX;
    case 3: return RegShape<3>::KMAX;
    case 4: return RegShape<4>::KMAX;
    case 5: return RegShape<5>::KMAX;
    case 6: return RegShape<6>::KMAX;
    case 7: return RegShape<7>::KMAX;
    case 8: return RegShape<8>::KMAX;
    default: return 0;
  }
}

// The wide path's plan at (K, D, x_bf16) as 9 ints: points a tile, 1 when
// x is read from global memory (no tile fits), blocks a node, components a
// block (0: a component takes nsplit blocks), nsplit, statistics items a
// component, U fragments a component, 1 when a block's U fragments are
// staged in shared memory, dynamic shared memory in bytes; the
// wrapper checks its own plan (wide_plan) against it.
extern "C" void gmm_estep_wide_plan(int K, int D, int x_bf16, int* out) {
  const WidePlan P = wide_plan(K, D, x_bf16 ? 2 : 4);
  const int v[9] = {P.tp, P.xg, P.nby, P.kb, P.nsplit, P.nitems, P.nfrag,
                    P.su, P.smem};
  for (int i = 0; i < 9; ++i) out[i] = v[i];
}

// Bytes of the wide path's device workspace for one call.
extern "C" long long gmm_estep_wide_workspace_bytes(int N, int T, int K,
                                                    int D, int x_bf16) {
  return (long long)wide_work(N, T, K, D, wide_plan(K, D, x_bf16 ? 2 : 4))
      .total;
}

// The shared path's plan at (K, D, x_bf16, block_t) as 6 ints: component
// blocks of 8, blocks a warp holds (the instance), 1 when the node takes an
// lse pass, statistics passes, phi row stride, dynamic shared memory in
// bytes; the wrapper checks its own plan (shared_plan) against it.
extern "C" void gmm_estep_shared_plan(int K, int D, int x_bf16, int block_t,
                                      int* out) {
  const SmPlan P = sm_plan(K, D, x_bf16 ? 2 : 4, block_t);
  const int v[6] = {P.ncb, P.cbm, P.chunked, P.npass, P.XS, P.smem};
  for (int i = 0; i < 6; ++i) out[i] = v[i];
}

// Bytes of the shared path's device workspace for one call.
extern "C" long long gmm_estep_shared_workspace_bytes(int N, int T, int K,
                                                      int D) {
  return (long long)sm_work_bytes(N, T, sm_plan(K, D, 4, 128));
}
