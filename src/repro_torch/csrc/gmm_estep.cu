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
// What bounds it on the H100: memory.  At the main-path shape (N=1000
// nodes, T=4096 points, K=3, D=2, f32 x, no r) it reads x plus mask, 12 B a
// point, about 49 MB (the per-node terms are negligible) and writes 84 KB:
// about 15 us at 3.35 TB/s.  The arithmetic is about 100 FLOP a point,
// 0.42 GFLOP, about 6 us at 67 TFLOP/s f32.  The design answers that with
// one pass over x and nothing but the statistics written: x and mask are
// read once, r is written only when asked for, and the statistics never
// leave shared memory until the single emit.
//
// Design (simple first): one thread block per node.  The node's Wn, b, c,
// log_prior and shift are staged in shared memory.  Threads walk the node's
// points in tiles of block_t = kPts * blockDim points; thread i takes points
// tile*block_t + j*blockDim + i, j < kPts.  Each thread computes its
// points' K log-rho values, max, softmax and mask (recomputing log rho per
// pass instead of keeping K values in registers, so K is a runtime value).
// Per component, the kPts points of a thread are summed in registers, the
// warp's 32 partial sums are reduced with a __shfl_xor_sync butterfly, and
// the result is added into the warp's slot in shared memory.  After the last
// tile the warp slots are summed in warp order, scaled, and written once.
//
// Determinism: no atomics.  The association order of every statistic is a
// function of block_t and blockDim only, never of T: points at or past T
// read as x = 0, mask = 0 and contribute exact zeros, exactly like trailing
// mask-zero padding in memory.  Stats for x and for x with zero rows
// appended are bit-identical, and two launches on the same inputs are too.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
//        -Xcompiler -fPIC (repro_torch/kernels/build.py); called via ctypes.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>

namespace {

// points per thread per tile; repro_torch/kernels/gmm_estep.py mirrors it
constexpr int kPts = 4;
constexpr int kMaxThreads = 256;

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

// y = x - s_k, component k's coordinates of a point
template <int D>
__device__ __forceinline__ void centre(const float (&x)[D], const float* sk,
                                       float (&y)[D]) {
#pragma unroll
  for (int d = 0; d < D; ++d) y[d] = x[d] - sk[d];
}

template <int D, typename Tin>
__global__ void __launch_bounds__(kMaxThreads) gmm_estep_nodes_kernel(
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
cudaError_t launch(const void* x, const void* mask, const void* log_prior,
                   const void* Wn, const void* b, const void* c,
                   const void* shift, void* r, void* stats, int N, int T,
                   int K, int block_t, float rep, int smem_bytes,
                   cudaStream_t stream) {
  auto kern = gmm_estep_nodes_kernel<D, Tin>;
  if (smem_bytes > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
    if (e != cudaSuccess) return e;
  }
  kern<<<N, block_t / kPts, smem_bytes, stream>>>(
      static_cast<const Tin*>(x), static_cast<const Tin*>(mask),
      static_cast<const float*>(log_prior), static_cast<const float*>(Wn),
      static_cast<const float*>(b), static_cast<const float*>(c),
      static_cast<const float*>(shift), static_cast<float*>(r),
      static_cast<float*>(stats), T, K, block_t, rep);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_dtype(int x_bf16, const void* x, const void* mask,
                         const void* log_prior, const void* Wn, const void* b,
                         const void* c, const void* shift, void* r,
                         void* stats, int N, int T, int K, int block_t,
                         float rep, int smem_bytes, cudaStream_t stream) {
  if (x_bf16)
    return launch<D, __nv_bfloat16>(x, mask, log_prior, Wn, b, c, shift, r,
                                    stats, N, T, K, block_t, rep, smem_bytes,
                                    stream);
  return launch<D, float>(x, mask, log_prior, Wn, b, c, shift, r, stats, N, T,
                          K, block_t, rep, smem_bytes, stream);
}

}  // namespace

// Plain C entry point (bound with ctypes).  x and mask are f32 (x_bf16 = 0)
// or bf16 (x_bf16 = 1); every other array is f32; shift and r may be null.
// The caller validates shapes, allocates the outputs and passes the stream.
// Returns the cudaError_t of the launch (0 = success).
extern "C" int gmm_estep_nodes_launch(
    const void* x, const void* mask, const void* log_prior, const void* Wn,
    const void* b, const void* c, const void* shift, void* r, void* stats,
    int N, int T, int K, int D, int block_t, float rep, int x_bf16,
    int smem_bytes, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define GMM_CASE(DD)                                                        \
  case DD:                                                                  \
    return (int)launch_dtype<DD>(x_bf16, x, mask, log_prior, Wn, b, c,      \
                                 shift, r, stats, N, T, K, block_t, rep,    \
                                 smem_bytes, s);
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
