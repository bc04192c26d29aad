// Blocked online-softmax (flash) attention for Hopper, GQA layout.
//
// Replaces the Pallas TPU kernel src/repro/kernels/flash_attention.py::
// flash_attention (body _kernel; GQA wrapper src/repro/kernels/ops.py::
// flash_attention).  For batch b, query head hq and query row i:
//
//   s_ij  = scale * q_i . k_j            (j masked: -1e30, the TPU's value)
//   o_i   = sum_j softmax_j(s_i.) v_j    (f32 running max m, sum l, acc)
//
// with k and v taken from kv head hkv = hq / (Hq / Hkv): the kernel indexes
// the shared kv head, it never materialises the GQA repeat.  Masks: keys at
// or past S; causal (j <= i); sliding window (j > i - window).  The final
// division is acc / max(l, 1e-30), so a row with nothing unmasked gives
// what the TPU kernel gives.
//
// Layout: q (B, S, Hq, HD), k/v (B, S, Hkv, HD), o (B, S, Hq, HD), all
// contiguous, f32 or bf16 (one instance each); products and softmax in f32.
//
// What bounds it on the H100: operations.  At the Yi-6B prefill of
// chip_smoke.py (B=4, S=2048, Hq=32, Hkv=4, HD=128, bf16, causal) the work
// is 4 * B * Hq * HD * S(S+1)/2 = 137.5 GFLOP, 0.139 ms at 989 TFLOP/s on
// the bf16 tensor cores, against 75.5 MB of q, k, v and o (22.5 us at
// 3.35 TB/s).  This first design runs on the f32 CUDA cores (67 TFLOP/s,
// so >= 2.05 ms even at their peak): it is the simple, right kernel; wgmma
// tiles fed by TMA are later work (ROADMAP Queue 2).
//
// Design: one block of 256 threads per (64-row query tile, hq, b).  The
// query tile is staged once in shared memory, transposed (Qs[d][row]); the
// block walks the 64-key tiles from the first one the window reaches (0
// without a window) to the causal diagonal, as the TPU kernel's
// pl.when(reachable) does, so a sliding window costs O(S * W).  Per tile:
// K is staged transposed (Ks[d][key], odd stride: no bank conflicts) and V
// row-major; thread (tr, tc) = (tid / 16, tid % 16) owns query rows
// 4tr..4tr+3 and keys tc + 16j of the 64 x 64 score tile, and output
// columns tc + 16j of the 64 x HD accumulator, so the row statistics m and
// l live in the registers of the 16 threads that share the rows (reduced
// with __shfl_xor_sync inside the 16-lane group).  P goes through shared
// memory (Ps[key][row]) for the P V product.  Rows and keys past S are
// bounds-checked, not padded in memory.  No atomics: every sum has a fixed
// order, so two launches on the same inputs are bit-identical.
//
// Shared memory: 4 * (HD * 68 + HD * 65 + 64 * HD + 64 * 68) bytes, 118,272
// at HD = 128 (the launch opts in above 48 KB).
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
//        -Xcompiler -fPIC (repro_torch/kernels/build.py); called via ctypes.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kBQ = 64;              // query rows per block
constexpr int kBK = 64;              // keys per tile
constexpr int kThreads = 256;        // 16 row groups x 16 column lanes
constexpr int kQStride = kBQ + 4;    // Qs[d][row], float4-aligned rows
constexpr int kKStride = kBK + 1;    // Ks[d][key], odd: conflict-free
constexpr int kPStride = kBQ + 4;    // Ps[key][row], float4-aligned rows
constexpr float kNegInf = -1e30f;    // the TPU kernel's mask value

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

// reductions inside the 16-lane group that shares a block of query rows
__device__ __forceinline__ float group_max(float v) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}
__device__ __forceinline__ float group_sum(float v) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

constexpr int smem_floats(int hd) {
  return hd * kQStride + hd * kKStride + kBK * hd + kBK * kPStride;
}

template <int HD, typename T>
__global__ void __launch_bounds__(kThreads)
flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, T* __restrict__ o, int S,
                       int Hq, int Hkv, float scale, int causal,
                       int window) {
  extern __shared__ __align__(16) float smem[];
  float* Qs = smem;                     // HD x kQStride
  float* Ks = Qs + HD * kQStride;       // HD x kKStride
  float* Vs = Ks + HD * kKStride;       // kBK x HD
  float* Ps = Vs + kBK * HD;            // kBK x kPStride

  constexpr int CJ = HD / 16;           // output columns per thread
  const int tid = threadIdx.x;
  const int tr = tid >> 4, tc = tid & 15;
  const int q_start = blockIdx.x * kBQ;
  const int hq = blockIdx.y, b = blockIdx.z;
  const int hkv = hq / (Hq / Hkv);
  const long q_row = (long)Hq * HD;     // elements between positions
  const long kv_row = (long)Hkv * HD;
  const T* qb = q + ((long)b * S * Hq + hq) * HD;
  const T* kb = k + ((long)b * S * Hkv + hkv) * HD;
  const T* vb = v + ((long)b * S * Hkv + hkv) * HD;
  T* ob = o + ((long)b * S * Hq + hq) * HD;

  for (int e = tid; e < kBQ * HD; e += kThreads) {
    const int r = e / HD, d = e % HD, s = q_start + r;
    Qs[d * kQStride + r] = s < S ? to_f32(qb[s * q_row + d]) : 0.f;
  }

  float acc[4][CJ], m[4], l[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < CJ; ++c) acc[i][c] = 0.f;
  }

  // the key tiles some valid row of this block can reach
  const int last_row = min(q_start + kBQ, S) - 1;
  const int n_tiles = (S + kBK - 1) / kBK;
  const int j_hi = causal ? min(n_tiles - 1, last_row / kBK) : n_tiles - 1;
  int j_lo = 0;
  if (window > 0) {
    const int first_key = q_start - window + 1;
    j_lo = first_key > 0 ? first_key / kBK : 0;
  }

  for (int j = j_lo; j <= j_hi; ++j) {
    const int k_start = j * kBK;
    __syncthreads();   // Qs staged / the previous tile's Ks, Vs, Ps read
    for (int e = tid; e < kBK * HD; e += kThreads) {
      const int c = e / HD, d = e % HD, s = k_start + c;
      float kv = 0.f, vv = 0.f;
      if (s < S) {
        kv = to_f32(kb[s * kv_row + d]);
        vv = to_f32(vb[s * kv_row + d]);
      }
      Ks[d * kKStride + c] = kv;
      Vs[c * HD + d] = vv;
    }
    __syncthreads();

    float sc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) sc[i][jj] = 0.f;
#pragma unroll 8
    for (int d = 0; d < HD; ++d) {
      const float4 q4 =
          *reinterpret_cast<const float4*>(&Qs[d * kQStride + tr * 4]);
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        const float kk = Ks[d * kKStride + tc + 16 * jj];
        sc[0][jj] = fmaf(q4.x, kk, sc[0][jj]);
        sc[1][jj] = fmaf(q4.y, kk, sc[1][jj]);
        sc[2][jj] = fmaf(q4.z, kk, sc[2][jj]);
        sc[3][jj] = fmaf(q4.w, kk, sc[3][jj]);
      }
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = q_start + tr * 4 + i;
      float mx = kNegInf;
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        const int col = k_start + tc + 16 * jj;
        bool ok = col < S;
        if (causal) ok = ok && col <= row;
        if (window > 0) ok = ok && col > row - window;
        sc[i][jj] = ok ? sc[i][jj] * scale : kNegInf;
        mx = fmaxf(mx, sc[i][jj]);
      }
      const float m_new = fmaxf(m[i], group_max(mx));
      const float alpha = expf(m[i] - m_new);
      float rs = 0.f;
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        sc[i][jj] = expf(sc[i][jj] - m_new);
        rs += sc[i][jj];
      }
      l[i] = alpha * l[i] + group_sum(rs);
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < CJ; ++c) acc[i][c] *= alpha;
    }
#pragma unroll
    for (int jj = 0; jj < 4; ++jj)
      *reinterpret_cast<float4*>(&Ps[(tc + 16 * jj) * kPStride + tr * 4]) =
          make_float4(sc[0][jj], sc[1][jj], sc[2][jj], sc[3][jj]);
    __syncthreads();

#pragma unroll 4
    for (int c = 0; c < kBK; ++c) {
      const float4 p4 =
          *reinterpret_cast<const float4*>(&Ps[c * kPStride + tr * 4]);
#pragma unroll
      for (int cj = 0; cj < CJ; ++cj) {
        const float vv = Vs[c * HD + tc + 16 * cj];
        acc[0][cj] = fmaf(p4.x, vv, acc[0][cj]);
        acc[1][cj] = fmaf(p4.y, vv, acc[1][cj]);
        acc[2][cj] = fmaf(p4.z, vv, acc[2][cj]);
        acc[3][cj] = fmaf(p4.w, vv, acc[3][cj]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q_start + tr * 4 + i;
    if (row >= S) continue;
    const float denom = fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int cj = 0; cj < CJ; ++cj)
      store(&ob[row * q_row + tc + 16 * cj], acc[i][cj] / denom);
  }
}

template <int HD, typename T>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   int B, int S, int Hq, int Hkv, float scale, int causal,
                   int window, cudaStream_t stream) {
  auto kern = flash_attention_kernel<HD, T>;
  const int smem = smem_floats(HD) * (int)sizeof(float);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return e;
  }
  const dim3 grid((S + kBQ - 1) / kBQ, Hq, B);
  kern<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), S, Hq, Hkv, scale,
      causal, window);
  return cudaGetLastError();
}

template <int HD>
cudaError_t launch_dtype(int bf16, const void* q, const void* k,
                         const void* v, void* o, int B, int S, int Hq,
                         int Hkv, float scale, int causal, int window,
                         cudaStream_t stream) {
  if (bf16)
    return launch<HD, __nv_bfloat16>(q, k, v, o, B, S, Hq, Hkv, scale,
                                     causal, window, stream);
  return launch<HD, float>(q, k, v, o, B, S, Hq, Hkv, scale, causal, window,
                           stream);
}

}  // namespace

// Plain C entry point (bound with ctypes).  q/k/v/o are all f32 (bf16 = 0)
// or all bf16 (bf16 = 1), contiguous, in the layout above; Hq % Hkv == 0.
// The caller validates shapes, allocates o and passes the stream.  Returns
// the cudaError_t of the launch (0 = success).
extern "C" int flash_attention_launch(const void* q, const void* k,
                                      const void* v, void* o, int B, int S,
                                      int Hq, int Hkv, int hd, int bf16,
                                      float scale, int causal, int window,
                                      void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B <= 0 || S <= 0 || Hkv <= 0 || Hq % Hkv != 0)
    return (int)cudaErrorInvalidValue;
  switch (hd) {
    case 16:
      return (int)launch_dtype<16>(bf16, q, k, v, o, B, S, Hq, Hkv, scale,
                                   causal, window, s);
    case 32:
      return (int)launch_dtype<32>(bf16, q, k, v, o, B, S, Hq, Hkv, scale,
                                   causal, window, s);
    case 64:
      return (int)launch_dtype<64>(bf16, q, k, v, o, B, S, Hq, Hkv, scale,
                                   causal, window, s);
    case 128:
      return (int)launch_dtype<128>(bf16, q, k, v, o, B, S, Hq, Hkv, scale,
                                    causal, window, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
