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
// against 0.6 GB: operations bind (~0.46 ms at 67 TFLOP/s f32).
//
// Three kernels; the wrapper (kernels/gmm_estep.py::kernel_variant) picks
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
// * gmm_estep_smem_kernel, for larger K * D (up to the shared-memory
//   limit): one block per node, K a runtime loop with log rho recomputed
//   per pass, per tile a warp butterfly per statistic added into the
//   warp's slot in shared memory, the warp slots summed in warp order at
//   the end.  The first design, kept for the shapes the register path does
//   not take, for D <= 8 and up to its shared memory at block_t = 512.
// * gmm_estep_wide_kernel, for everything else (the paper's real-data
//   tables run D = 34 and D = 52): D is a runtime value.  One block of
//   kWideThreads = 256 per node; a tile of kWideTile = 64 points sits
//   transposed in shared memory.  Per tile and component, Wn_k and the
//   centred tile Y_k are staged in shared memory in f64 and the quadratic
//   form runs as the Pallas kernel's tile product Z = Y_k Wn_k (items of
//   one point x 4 columns, f64 FMA on the CUDA cores) followed by the row
//   dot with Y_k; log rho and its differences to the point's largest are
//   formed in f64, exp and r in f32 (at D = 52 an f32 log rho, a sum of
//   D^2 products ~1e3, is off by ~1e-4 and moves r near ties past
//   tests/test_kernels.py's bars, as the plain version's own f32 rounding
//   does; the f64 products make the kernel ~1.3x slower at D = 34);
//   then the statistics, f32 products and sums, as 4 x 4 blocks of
//   sum_t r y' y'^T with y' = (y, 1, 0, ...), upper-triangle blocks only,
//   so that sum_xx,
//   sum_x (the column of the 1) and R (its corner) come from one product.
//   Each statistics item (point group, component, block) belongs to one
//   thread and lives in shared memory across the node's tiles, which add
//   their sums into it one tile at a time (short f32 chains); when there
//   are fewer items than threads, a tile's points are split into up to 16
//   groups (a function of (K, D)) whose partial sums are added in group
//   order at the end.  Its shared memory (gmm_estep_wide_smem_bytes)
//   bounds the shapes it takes (`supported` in the wrapper).  A simple
//   design on the CUDA cores (TF32 tensor cores would likely miss the
//   sum_xx bars).
//
// Determinism: no atomics.  The association order of every statistic
// depends on the point index and the compile-time constants (kThreads,
// kGroup; block_t on the shared path; kWideTile and the groups, a
// function of (K, D), on the wide path), never on T: points at or
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
// Shared-memory path
// ===========================================================================
// points per thread per tile; repro_torch/kernels/gmm_estep.py mirrors it
constexpr int kPts = 4;
constexpr int kMaxThreads = 256;

// y = x - s_k, component k's coordinates of a point
template <int D>
__device__ __forceinline__ void centre(const float (&x)[D], const float* sk,
                                       float (&y)[D]) {
#pragma unroll
  for (int d = 0; d < D; ++d) y[d] = x[d] - sk[d];
}

template <int D, typename Tin>
__global__ void __launch_bounds__(kMaxThreads) gmm_estep_smem_kernel(
    const Tin* __restrict__ x, const Tin* __restrict__ mask,
    const float* __restrict__ log_prior, const float* __restrict__ Wn,
    const float* __restrict__ b, const float* __restrict__ c,
    const float* __restrict__ shift, float* __restrict__ r_out,
    float* __restrict__ stats, int T, int K, int block_t, float rep) {
  // per component: R, sum_x (D), upper triangle of sum_xx (D(D+1)/2)
  constexpr int SK = 1 + D + D * (D + 1) / 2;
  extern __shared__ float smem[];
  const int n = blockIdx.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int nthreads = blockDim.x;
  const int nwarps = nthreads >> 5;
  const int S = K * SK;
  float* s_lp = smem;
  float* s_c = s_lp + K;
  float* s_b = s_c + K;
  float* s_w = s_b + K * D;
  float* s_s = s_w + K * D * D;    // per-component shift (K*D)
  float* s_acc = s_s + K * D;      // nwarps slots of S floats

  for (int i = tid; i < K; i += nthreads) {
    s_lp[i] = log_prior[(size_t)n * K + i];
    s_c[i] = c[(size_t)n * K + i];
  }
  for (int i = tid; i < K * D; i += nthreads) {
    s_b[i] = b[(size_t)n * K * D + i];
    s_s[i] = shift != nullptr ? shift[(size_t)n * K * D + i] : 0.f;
  }
  for (int i = tid; i < K * D * D; i += nthreads)
    s_w[i] = Wn[(size_t)n * K * D * D + i];
  for (int i = tid; i < nwarps * S; i += nthreads) s_acc[i] = 0.f;
  __syncthreads();

  const Tin* xn = x + (size_t)n * T * D;
  const Tin* mn = mask + (size_t)n * T;
  float* acc = s_acc + (tid >> 5) * S;
  const int ntiles = (T + block_t - 1) / block_t;

  for (int tile = 0; tile < ntiles; ++tile) {
    float xv[kPts][D];
    float mv[kPts];
    int pt[kPts];
#pragma unroll
    for (int j = 0; j < kPts; ++j) {
      const int p = tile * block_t + j * nthreads + tid;
      const bool in = p < T;
      pt[j] = p;
#pragma unroll
      for (int d = 0; d < D; ++d)
        xv[j][d] = in ? to_f32(xn[(size_t)p * D + d]) : 0.f;
      mv[j] = in ? to_f32(mn[p]) : 0.f;
    }
    // softmax over components: max, then the denominator
    float mx[kPts], den[kPts];
#pragma unroll
    for (int j = 0; j < kPts; ++j) {
      mx[j] = -INFINITY;
      den[j] = 0.f;
    }
    float yv[kPts][D];
    for (int k = 0; k < K; ++k) {
#pragma unroll
      for (int j = 0; j < kPts; ++j) {
        centre<D>(xv[j], s_s + k * D, yv[j]);
        mx[j] = fmaxf(mx[j], log_rho<D>(s_w + k * D * D, s_b + k * D,
                                        s_lp[k], s_c[k], yv[j]));
      }
    }
    for (int k = 0; k < K; ++k) {
#pragma unroll
      for (int j = 0; j < kPts; ++j) {
        centre<D>(xv[j], s_s + k * D, yv[j]);
        den[j] += expf(log_rho<D>(s_w + k * D * D, s_b + k * D, s_lp[k],
                                  s_c[k], yv[j]) - mx[j]);
      }
    }
    for (int k = 0; k < K; ++k) {
      float rk[kPts];
#pragma unroll
      for (int j = 0; j < kPts; ++j) {
        centre<D>(xv[j], s_s + k * D, yv[j]);
        rk[j] = expf(log_rho<D>(s_w + k * D * D, s_b + k * D, s_lp[k],
                                s_c[k], yv[j]) - mx[j]) / den[j] * mv[j];
        if (r_out != nullptr && pt[j] < T)
          r_out[((size_t)n * T + pt[j]) * K + k] = rk[j];
      }
      // statistic s of component k lives at acc[k*SK + s]; after the
      // butterfly every lane holds the warp total, lane s%32 adds it
      float* a = acc + k * SK;
      int s = 0;
      float v = 0.f;
#pragma unroll
      for (int j = 0; j < kPts; ++j) v += rk[j];
      v = warp_sum(v);
      if (lane == ((k * SK + s) & 31)) a[s] += v;
      ++s;
#pragma unroll
      for (int d = 0; d < D; ++d, ++s) {
        v = 0.f;
#pragma unroll
        for (int j = 0; j < kPts; ++j) v += rk[j] * yv[j][d];
        v = warp_sum(v);
        if (lane == ((k * SK + s) & 31)) a[s] += v;
      }
#pragma unroll
      for (int d = 0; d < D; ++d) {
#pragma unroll
        for (int e = d; e < D; ++e, ++s) {
          v = 0.f;
#pragma unroll
          for (int j = 0; j < kPts; ++j) v += (rk[j] * yv[j][d]) * yv[j][e];
          v = warp_sum(v);
          if (lane == ((k * SK + s) & 31)) a[s] += v;
        }
      }
    }
  }
  __syncthreads();

  // fixed-order sum across warps into slot 0 (thread s owns statistic s)
  for (int s = tid; s < S; s += nthreads) {
    float tot = s_acc[s];
    for (int w = 1; w < nwarps; ++w) tot += s_acc[w * S + s];
    s_acc[s] = tot;
  }
  __syncthreads();

  const int rows = K + K * D + K;
  float* out = stats + (size_t)n * rows * D;
  for (int o = tid; o < rows * D; o += nthreads) {
    const int row = o / D, col = o % D;
    float val;
    if (row < K) {
      val = s_acc[row * SK + 1 + col];
    } else if (row < K + K * D) {
      const int k = (row - K) / D, d = (row - K) % D;
      const int i = d < col ? d : col, j = d < col ? col : d;
      val = s_acc[k * SK + 1 + D + i * D - i * (i - 1) / 2 + (j - i)];
    } else {
      val = col == 0 ? s_acc[(row - K - K * D) * SK] : 0.f;
    }
    out[o] = val * rep;
  }
}


// ===========================================================================
// Wide path: any D, and the (K, D) shapes the two paths above do not take
// ===========================================================================
// threads per block, points per tile, most point groups of the statistics
// phase; repro_torch/kernels/gmm_estep.py mirrors them (WIDE_THREADS,
// WIDE_TILE, WIDE_MAX_GROUPS) and checks its shared-memory size against
// gmm_estep_wide_smem_bytes
constexpr int kWideThreads = 256;
constexpr int kWideTile = 64;
constexpr int kWideMaxGroups = 16;
// row stride of the transposed point tile: odd, so that threads reading
// consecutive points, or consecutive coordinates of one point, hit
// distinct banks
constexpr int kWideTS = kWideTile + 1;

// Sizes and shared-memory offsets (in floats) of one wide-path block.
// The statistics are 4 x 4 blocks of the (Dp x Dp) matrix sum_t r y' y'^T,
// y' = (y, 1, 0, ...): its upper-triangle blocks hold sum_xx, the column
// of the constant 1 holds sum_x and its corner R.
struct WideLayout {
  int Dp;      // D + 1 rounded up to a multiple of 4
  int nb;      // 4 x 4 blocks a side, Dp / 4
  int nbt;     // blocks of the upper triangle, nb (nb + 1) / 2
  int nbq;     // 4-column blocks of Wn_k, ceil(D / 4)
  int ws;      // row stride of the staged Wn_k, 4 nbq
  int groups;  // point groups a tile's statistics are split into
  int items;   // statistics items (group, component, block), 16 floats each
  int acc, w, xt, yd, pq, pc, lr, s, b, lp, c, m, total;
};

__host__ __device__ inline WideLayout wide_layout(int K, int D) {
  WideLayout L;
  L.Dp = (D + 4) / 4 * 4;
  L.nb = L.Dp / 4;
  L.nbt = L.nb * (L.nb + 1) / 2;
  L.nbq = (D + 3) / 4;
  L.ws = 4 * L.nbq;
  int g = 1;   // the most groups (a power of two) that keep items <= threads
  while (g < kWideMaxGroups && 2 * g * K * L.nbt <= kWideThreads) g *= 2;
  L.groups = g;
  L.items = g * K * L.nbt;
  // offsets in floats; every f64 array starts on a 16-byte boundary
  int o = 0;
  L.acc = o; o += 16 * L.items;           // statistics items
  L.w = o;   o += 2 * D * L.ws;           // Wn_k in f64, columns to ws
  L.xt = o;  o += L.Dp * kWideTS;         // the tile, transposed: [d][t]
  L.yd = o;  o += 2 * D * kWideTile;      // Y_k in f64: [d][t]
  L.pq = o;  o += 2 * L.nbq * kWideTile;  // y'Wn_k y per column block, f64
  L.pc = o;  o += 2 * L.nbq * kWideTile;  // y.b_k per column block, f64
  L.lr = o;  o += 2 * K * kWideTile;      // log rho in f64, then r: [k][t]
  L.s = o;   o += K * L.Dp;               // shift, zero-padded to Dp
  L.b = o;   o += K * D;
  L.lp = o;  o += K;
  L.c = o;   o += K;
  L.m = o;   o += kWideTile;          // the tile's mask
  L.total = o;
  return L;
}

template <typename Tin>
__global__ void __launch_bounds__(kWideThreads) gmm_estep_wide_kernel(
    const Tin* __restrict__ x, const Tin* __restrict__ mask,
    const float* __restrict__ log_prior, const float* __restrict__ Wn,
    const float* __restrict__ b, const float* __restrict__ c,
    const float* __restrict__ shift, float* __restrict__ r_out,
    float* __restrict__ stats, int T, int K, int D, float rep) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const WideLayout L = wide_layout(K, D);
  float* s_acc = smem + L.acc;
  double* s_w = reinterpret_cast<double*>(smem + L.w);
  float* s_xt = smem + L.xt;
  double* s_yd = reinterpret_cast<double*>(smem + L.yd);
  double* s_pq = reinterpret_cast<double*>(smem + L.pq);
  double* s_pc = reinterpret_cast<double*>(smem + L.pc);
  // log rho of (k, t) in f64; the softmax then writes r into the first
  // float of the same 8 bytes, which only its own thread reads
  double* s_lr = reinterpret_cast<double*>(smem + L.lr);
  float* s_r = smem + L.lr;
  float* s_s = smem + L.s;
  float* s_b = smem + L.b;
  float* s_lp = smem + L.lp;
  float* s_c = smem + L.c;
  float* s_m = smem + L.m;
  const int n = blockIdx.x;
  const int tid = threadIdx.x;
  const size_t nK = (size_t)n * K;

  for (int i = tid; i < 16 * L.items; i += kWideThreads) s_acc[i] = 0.f;
  for (int i = tid; i < K * L.Dp; i += kWideThreads) {
    const int k = i / L.Dp, d = i % L.Dp;
    s_s[i] = (d < D && shift != nullptr) ? shift[(nK + k) * D + d] : 0.f;
  }
  for (int i = tid; i < K * D; i += kWideThreads) s_b[i] = b[nK * D + i];
  for (int i = tid; i < K; i += kWideThreads) {
    s_lp[i] = log_prior[nK + i];
    s_c[i] = c[nK + i];
  }
  // rows D .. Dp - 1 of the tile: the constant 1, then zeros (the tile
  // loads write rows < D only)
  for (int i = tid; i < (L.Dp - D) * kWideTS; i += kWideThreads)
    s_xt[D * kWideTS + i] = i < kWideTS ? 1.f : 0.f;

  const Tin* xn = x + (size_t)n * T * D;
  const Tin* mn = mask + (size_t)n * T;
  const int ntiles = (T + kWideTile - 1) / kWideTile;
  const int tp = kWideTile / L.groups;    // points of a group in a tile
  const int ws2 = L.ws / 2;               // double2s a row of Wn_k
  const double2* w2 = reinterpret_cast<const double2*>(s_w);

  for (int tile = 0; tile < ntiles; ++tile) {
    const int p0 = tile * kWideTile;
    __syncthreads();   // the last tile's statistics are done with s_xt, s_r
    // the tile, transposed; points at or past T read as x = 0, mask = 0
    for (int i = tid; i < kWideTile * D; i += kWideThreads) {
      const int t = i / D, d = i % D;
      const int p = p0 + t;
      s_xt[d * kWideTS + t] = p < T ? to_f32(xn[(size_t)p * D + d]) : 0.f;
    }
    for (int t = tid; t < kWideTile; t += kWideThreads)
      s_m[t] = p0 + t < T ? to_f32(mn[p0 + t]) : 0.f;

    // log rho in f64, a component at a time: Y_k (the tile centred on
    // s_k) and Wn_k staged in f64; Z = Y_k Wn_k as items of one point x 4
    // columns, then per item the row dot of those columns of Z with y and
    // of y with b_k; the column blocks' partial sums added in block order.
    // In f32 the D^2-term sums round log rho by ~1e-4 at D = 52 (|y' Wn
    // y| ~ 1e3), which moves r near ties past tests/test_kernels.py's
    // bars
    for (int k = 0; k < K; ++k) {
      __syncthreads();   // the tile is in; s_w, s_yd, s_pq, s_pc are free
      for (int i = tid; i < D * L.ws; i += kWideThreads) {
        const int d = i / L.ws, e = i % L.ws;
        s_w[i] = e < D ? (double)Wn[((nK + k) * D + d) * D + e] : 0.0;
      }
      const float* sk = s_s + k * L.Dp;
      for (int i = tid; i < D * kWideTile; i += kWideThreads) {
        const int d = i / kWideTile, t = i % kWideTile;
        s_yd[i] = (double)s_xt[d * kWideTS + t] - (double)sk[d];
      }
      __syncthreads();
      for (int i = tid; i < kWideTile * L.nbq; i += kWideThreads) {
        const int t = i % kWideTile, eb = i / kWideTile;
        double z[4] = {0.0, 0.0, 0.0, 0.0};
        for (int d = 0; d < D; ++d) {
          const double y = s_yd[d * kWideTile + t];
          const double2 wa = w2[d * ws2 + 2 * eb];
          const double2 wb = w2[d * ws2 + 2 * eb + 1];
          z[0] = fma(y, wa.x, z[0]);
          z[1] = fma(y, wa.y, z[1]);
          z[2] = fma(y, wb.x, z[2]);
          z[3] = fma(y, wb.y, z[3]);
        }
        double q = 0.0, cr = 0.0;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int e = 4 * eb + j;
          if (e < D) {
            const double y = s_yd[e * kWideTile + t];
            q = fma(z[j], y, q);
            cr = fma(y, (double)s_b[k * D + e], cr);
          }
        }
        s_pq[eb * kWideTile + t] = q;
        s_pc[eb * kWideTile + t] = cr;
      }
      __syncthreads();
      for (int t = tid; t < kWideTile; t += kWideThreads) {
        double q = 0.0, cr = 0.0;
        for (int eb = 0; eb < L.nbq; ++eb) {
          q += s_pq[eb * kWideTile + t];
          cr += s_pc[eb * kWideTile + t];
        }
        s_lr[k * kWideTile + t] =
            (double)s_lp[k] - 0.5 * (q - 2.0 * cr + (double)s_c[k]);
      }
    }
    __syncthreads();

    // the masked softmax over components: the differences to the point's
    // largest log rho in f64, rounded to f32, then exp and r in f32
    for (int t = tid; t < kWideTile; t += kWideThreads) {
      double mx = -INFINITY;
      for (int k = 0; k < K; ++k) mx = fmax(mx, s_lr[k * kWideTile + t]);
      float den = 0.f;
      for (int k = 0; k < K; ++k)
        den += expf((float)(s_lr[k * kWideTile + t] - mx));
      const bool in = p0 + t < T;
      for (int k = 0; k < K; ++k) {
        const float r =
            expf((float)(s_lr[k * kWideTile + t] - mx)) / den * s_m[t];
        s_r[2 * (k * kWideTile + t)] = r;
        if (r_out != nullptr && in)
          r_out[((size_t)n * T + p0 + t) * K + k] = r;
      }
    }
    __syncthreads();

    // statistics: item w = (group g, component k, block (bi, bj)) sums
    // (r y_d) y_e over its group's points of the tile, in point order,
    // then adds that tile sum into its own 16 floats: two short chains
    // (tp points, then the tiles) instead of one over the node's points,
    // whose f32 rounding grew with T (at T = 4096 sum_x was 0.1 off an
    // f64 evaluation where the plain version's pairwise sums were 1e-3)
    for (int w = tid; w < L.items; w += kWideThreads) {
      const int g = w / (K * L.nbt), kt = w % (K * L.nbt);
      const int k = kt / L.nbt;
      int bi = 0, rem = kt % L.nbt;
      while (rem >= L.nb - bi) {
        rem -= L.nb - bi;
        ++bi;
      }
      const int bj = bi + rem;
      float4* a4 = reinterpret_cast<float4*>(s_acc) + 4 * w;
      float acc[16];
#pragma unroll
      for (int i = 0; i < 16; ++i) acc[i] = 0.f;
      const float* sk = s_s + k * L.Dp;
      float sd[4], se[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        sd[i] = sk[4 * bi + i];
        se[i] = sk[4 * bj + i];
      }
      const float* xd = s_xt + 4 * bi * kWideTS;
      const float* xe = s_xt + 4 * bj * kWideTS;
      const float* rk = s_r + 2 * k * kWideTile;
      for (int t = g * tp; t < (g + 1) * tp; ++t) {
        const float r = rk[2 * t];
        float ry[4], ye[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          ry[i] = r * (xd[i * kWideTS + t] - sd[i]);
          ye[i] = xe[i * kWideTS + t] - se[i];
        }
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j)
            acc[4 * i + j] = fmaf(ry[i], ye[j], acc[4 * i + j]);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float4 v = a4[i];
        a4[i] = make_float4(v.x + acc[4 * i], v.y + acc[4 * i + 1],
                            v.z + acc[4 * i + 2], v.w + acc[4 * i + 3]);
      }
    }
  }
  __syncthreads();

  // the groups' partial sums, added in group order into group 0's items
  const int per_group = 16 * K * L.nbt;
  for (int i = tid; i < per_group; i += kWideThreads) {
    float v = s_acc[i];
    for (int g = 1; g < L.groups; ++g) v += s_acc[g * per_group + i];
    s_acc[i] = v;
  }
  __syncthreads();

  // entry (i, j), i <= j, of component k's matrix: sum_x[k][d] is (d, D),
  // sum_xx[k][d][e] is (min, max) of (d, e), R_k is (D, D)
  const int rows = K + K * D + K;
  float* out = stats + (size_t)n * rows * D;
  for (int o = tid; o < rows * D; o += kWideThreads) {
    const int row = o / D, col = o % D;
    int k, i, j;
    if (row < K) {
      k = row;
      i = col;
      j = D;
    } else if (row < K + K * D) {
      k = (row - K) / D;
      const int d = (row - K) % D;
      i = d < col ? d : col;
      j = d < col ? col : d;
    } else {
      k = row - K - K * D;
      i = D;
      j = D;
    }
    const int bi = i / 4, bj = j / 4;
    const int tri = bi * L.nb - bi * (bi - 1) / 2 + (bj - bi);
    float val = s_acc[(k * L.nbt + tri) * 16 + (i % 4) * 4 + (j % 4)];
    if (row >= K + K * D && col != 0) val = 0.f;
    out[o] = val * rep;
  }
}

template <typename Tin>
cudaError_t launch_wide(const void* x, const void* mask,
                        const void* log_prior, const void* Wn, const void* b,
                        const void* c, const void* shift, void* r,
                        void* stats, int N, int T, int K, int D, float rep,
                        cudaStream_t stream) {
  const int bytes = 4 * wide_layout(K, D).total;
  auto kern = gmm_estep_wide_kernel<Tin>;
  if (bytes > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (e != cudaSuccess) return e;
  }
  kern<<<N, kWideThreads, bytes, stream>>>(
      static_cast<const Tin*>(x), static_cast<const Tin*>(mask),
      static_cast<const float*>(log_prior), static_cast<const float*>(Wn),
      static_cast<const float*>(b), static_cast<const float*>(c),
      static_cast<const float*>(shift), static_cast<float*>(r),
      static_cast<float*>(stats), T, K, D, rep);
  return cudaGetLastError();
}


template <int D, typename Tin>
cudaError_t launch(int variant, const void* x, const void* mask,
                   const void* log_prior, const void* Wn, const void* b,
                   const void* c, const void* shift, void* r, void* stats,
                   int N, int T, int K, int block_t, float rep,
                   int smem_bytes, int vec, cudaStream_t stream) {
  const Tin* xi = static_cast<const Tin*>(x);
  const Tin* mi = static_cast<const Tin*>(mask);
  const float* lp = static_cast<const float*>(log_prior);
  const float* w = static_cast<const float*>(Wn);
  const float* bb = static_cast<const float*>(b);
  const float* cc = static_cast<const float*>(c);
  const float* sh = static_cast<const float*>(shift);
  float* ro = static_cast<float*>(r);
  float* st = static_cast<float*>(stats);
  if (variant == 0) {
    if constexpr (RegShape<D>::KMAX > 0) {
      if (K > RegShape<D>::KMAX) return cudaErrorInvalidValue;
      gmm_estep_regs_kernel<D, Tin><<<N, kThreads, 0, stream>>>(
          xi, mi, lp, w, bb, cc, sh, ro, st, T, K, rep, vec);
      return cudaGetLastError();
    }
    return cudaErrorInvalidValue;
  }
  auto kern = gmm_estep_smem_kernel<D, Tin>;
  if (smem_bytes > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
    if (e != cudaSuccess) return e;
  }
  kern<<<N, block_t / kPts, smem_bytes, stream>>>(xi, mi, lp, w, bb, cc, sh,
                                                  ro, st, T, K, block_t, rep);
  return cudaGetLastError();
}

}  // namespace

// Plain C entry point (bound with ctypes).  x and mask are f32 (x_bf16 = 0)
// or bf16 (x_bf16 = 1); every other array is f32; shift and r may be null.
// variant 0 launches gmm_estep_regs_kernel (K <= gmm_estep_reg_kmax(D);
// `vec` = 1 allows its vector loads: T % 4 == 0 and x, mask 16-byte
// aligned), variant 1 gmm_estep_smem_kernel (block_t, smem_bytes),
// variant 2 gmm_estep_wide_kernel (any D; block_t and smem_bytes unused).  The
// caller validates shapes, allocates the outputs and passes the stream.
// Returns the cudaError_t of the launch (0 = success).
extern "C" int gmm_estep_nodes_launch(
    const void* x, const void* mask, const void* log_prior, const void* Wn,
    const void* b, const void* c, const void* shift, void* r, void* stats,
    int N, int T, int K, int D, int block_t, float rep, int x_bf16,
    int smem_bytes, int variant, int vec, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (variant == 2)
    return x_bf16 ? (int)launch_wide<__nv_bfloat16>(
                        x, mask, log_prior, Wn, b, c, shift, r, stats, N, T,
                        K, D, rep, s)
                  : (int)launch_wide<float>(x, mask, log_prior, Wn, b, c,
                                            shift, r, stats, N, T, K, D, rep,
                                            s);
#define GMM_CASE(DD)                                                        \
  case DD:                                                                  \
    return x_bf16 ? (int)launch<DD, __nv_bfloat16>(                         \
                        variant, x, mask, log_prior, Wn, b, c, shift, r,    \
                        stats, N, T, K, block_t, rep, smem_bytes, vec, s)   \
                  : (int)launch<DD, float>(variant, x, mask, log_prior, Wn, \
                                           b, c, shift, r, stats, N, T, K,  \
                                           block_t, rep, smem_bytes, vec,   \
                                           s);
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

// Dynamic shared memory of one wide-path block at (K, D), in bytes; the
// wrapper checks its own formula (wide_smem_bytes) against it.
extern "C" int gmm_estep_wide_smem_bytes(int K, int D) {
  return 4 * wide_layout(K, D).total;
}
