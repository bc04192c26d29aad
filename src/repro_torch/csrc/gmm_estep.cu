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
// Two kernels; the wrapper (kernels/gmm_estep.py::kernel_variant) picks one
// by (K, D) alone, never by T or N:
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
//   not take.
//
// Determinism: no atomics.  The association order of every statistic
// depends on the point index and the compile-time constants (kThreads,
// kGroup; block_t on the shared path), never on T: points at or
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
// aligned), variant 1 gmm_estep_smem_kernel (block_t, smem_bytes).  The
// caller validates shapes, allocates the outputs and passes the stream.
// Returns the cudaError_t of the launch (0 = success).
extern "C" int gmm_estep_nodes_launch(
    const void* x, const void* mask, const void* log_prior, const void* Wn,
    const void* b, const void* c, const void* shift, void* r, void* stats,
    int N, int T, int K, int D, int block_t, float rep, int x_bf16,
    int smem_bytes, int variant, int vec, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
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
