// Mamba-2 SSD chunked scan for Hopper.
//
// Replaces the Pallas TPU kernel src/repro/kernels/ssd_scan.py::ssd_scan
// (body _kernel; wrapper src/repro/kernels/ops.py::ssd_scan).  Per batch b
// and head h, the scalar-decay SSM
//
//   state_t = exp(dt_t A_h) state_{t-1} + dt_t B_t x_t^T     (N x P)
//   y_t     = C_t . state_t
//
// computed chunk by chunk, with the (N, P) state carried across chunks.
// Inside a chunk of L positions, with cum the inclusive cumsum of dt * A:
//
//   y_intra = ((C B^T) o exp(cum_l - cum_l') [l' <= l] o dt_l') @ x
//   y_inter = (C o exp(cum)) @ state
//   state'  = exp(cum_{L-1}) state + (B o dt o exp(cum_{L-1} - cum))^T @ x
//
// the TPU kernel's formulas (ssd_scan.py:140-175), gates masked BEFORE exp.
// Everything is f32 inside; y is written in x's dtype and the final state
// as (B, H, P, N) f32, the TPU wrapper's transpose (ssd_scan.py:233).
//
// Layout: x (B, S, H, P) and y in f32 or bf16; dt (B, S, H) f32; A (H,) f32;
// Bm, Cm (B, S, N) in x's dtype; all contiguous.
//
// The chunk length is a schedule, not the function: the result does not
// depend on it (up to f32 rounding).  The kernel uses its own chunk of
// kL = 64 positions, which keeps the L x L gate matrix (16 KB), the chunk's
// B and C (33 KB each at N = 128) and the state (32 KB at N = 128, P = 64)
// together in shared memory; a ragged last chunk reads as zeros (dt = 0,
// x = B = C = 0), which contributes nothing and leaves cum constant.
//
// What bounds it on the H100: bytes.  At the Mamba-2 370M prefill of
// chip_smoke.py (B=4, S=2048, H=32, P=64, N=128, bf16 x) it reads x
// (33.6 MB), dt, Bm, Cm and writes y (33.6 MB) and the state (4.2 MB):
// 76.6 MB, 22.9 us at 3.35 TB/s.  Its work at kL = 64 (the causal half of
// C B^T and of the intra product, the inter product and the state update)
// is 11.9 GFLOP, 12 us at 989 TFLOP/s on the bf16 tensor cores.  This
// first design runs on the f32 CUDA cores with one output element per
// thread at a time, and only B * H = 128 blocks (one per (b, h): the chunk
// loop is sequential), so it is far from either bound; B and C are shared
// by the heads and every (b, h) block reads them again (from L2).  Sharing
// B/C across heads and tensor-core tiles are later work (ROADMAP Queue 2).
//
// Design: one block of 256 threads per (h, b).  Per chunk: stage x, B, C
// (B and C with an odd row stride N + 1, conflict-free) and dt; warp 0
// scans dt * A (two positions a lane, __shfl_up_sync); the block forms the
// gated L x L matrix M, then y = M x + exp(cum) (C state), then updates the
// state in place (each element by one thread).  No atomics: every sum has a
// fixed order, so two launches on the same inputs are bit-identical.
//
// Shared memory: 4 * (N P + kL P + 2 kL (N + 1) + kL^2 + 4 kL) bytes,
// 132,608 at N = 128, P = 64 (the launch opts in above 48 KB).
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
//        -Xcompiler -fPIC (repro_torch/kernels/build.py); called via ctypes.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kL = 64;          // positions per internal chunk (2 per lane)
constexpr int kThreads = 256;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

int smem_floats(int N, int P) {
  return N * P + kL * P + 2 * kL * (N + 1) + kL * kL + 4 * kL;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
ssd_scan_kernel(const T* __restrict__ x, const float* __restrict__ dt,
                const float* __restrict__ A, const T* __restrict__ Bm,
                const T* __restrict__ Cm, T* __restrict__ y,
                float* __restrict__ hout, int S, int H, int P, int N) {
  extern __shared__ __align__(16) float smem[];
  const int NS = N + 1;                 // odd row stride of Bs / Cs
  float* st = smem;                     // state, N x P
  float* xs = st + N * P;               // kL x P
  float* Bs = xs + kL * P;              // kL x NS
  float* Cs = Bs + kL * NS;             // kL x NS
  float* Ms = Cs + kL * NS;             // kL x kL gated C B^T
  float* cum = Ms + kL * kL;            // kL
  float* dts = cum + kL;                // kL
  float* ein = dts + kL;                // kL: exp(cum_l)
  float* wl = ein + kL;                 // kL: dt_l exp(cum_last - cum_l)

  const int tid = threadIdx.x;
  const int h = blockIdx.x, b = blockIdx.y;
  const float a = A[h];
  const long xrow = (long)H * P;        // elements between positions
  const T* xb = x + (long)b * S * xrow + (long)h * P;
  T* yb = y + (long)b * S * xrow + (long)h * P;
  const float* dtb = dt + (long)b * S * H + h;
  const T* Bb = Bm + (long)b * S * N;
  const T* Cb = Cm + (long)b * S * N;

  for (int e = tid; e < N * P; e += kThreads) st[e] = 0.f;

  for (int c0 = 0; c0 < S; c0 += kL) {
    const int len = min(kL, S - c0);
    __syncthreads();   // the previous chunk's readers are done
    for (int e = tid; e < kL * P; e += kThreads) {
      const int l = e / P, p = e % P;
      xs[e] = l < len ? to_f32(xb[(c0 + l) * xrow + p]) : 0.f;
    }
    for (int e = tid; e < kL * N; e += kThreads) {
      const int l = e / N, n = e % N;
      const bool in = l < len;
      const long g = (long)(c0 + l) * N + n;
      Bs[l * NS + n] = in ? to_f32(Bb[g]) : 0.f;
      Cs[l * NS + n] = in ? to_f32(Cb[g]) : 0.f;
    }
    if (tid < kL) dts[tid] = tid < len ? dtb[(long)(c0 + tid) * H] : 0.f;
    __syncthreads();

    if (tid < 32) {    // inclusive cumsum of dt * A, two positions a lane
      const float a0 = dts[2 * tid] * a, a1 = dts[2 * tid + 1] * a;
      float run = a0 + a1;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const float t = __shfl_up_sync(0xffffffffu, run, off);
        if (tid >= off) run += t;
      }
      float before = __shfl_up_sync(0xffffffffu, run, 1);
      if (tid == 0) before = 0.f;
      cum[2 * tid] = before + a0;
      cum[2 * tid + 1] = before + a0 + a1;
    }
    __syncthreads();
    const float c_last = cum[kL - 1];
    if (tid < kL) {
      ein[tid] = expf(cum[tid]);
      wl[tid] = dts[tid] * expf(c_last - cum[tid]);
    }
    for (int e = tid; e < kL * kL; e += kThreads) {
      const int l = e / kL, lp = e % kL;
      float mv = 0.f;
      if (lp <= l) {   // mask before exp: only l' <= l is ever exponentiated
        float dot = 0.f;
        for (int n = 0; n < N; ++n)
          dot = fmaf(Cs[l * NS + n], Bs[lp * NS + n], dot);
        mv = dot * expf(cum[l] - cum[lp]) * dts[lp];
      }
      Ms[e] = mv;
    }
    __syncthreads();

    for (int e = tid; e < kL * P; e += kThreads) {
      const int l = e / P, p = e % P;
      if (l >= len) continue;
      float yi = 0.f, yo = 0.f;
      for (int lp = 0; lp <= l; ++lp)
        yi = fmaf(Ms[l * kL + lp], xs[lp * P + p], yi);
      for (int n = 0; n < N; ++n)
        yo = fmaf(Cs[l * NS + n], st[n * P + p], yo);
      store(&yb[(c0 + l) * xrow + p], yi + ein[l] * yo);
    }
    __syncthreads();   // y read the state before this chunk's update

    const float decay = expf(c_last);
    for (int e = tid; e < N * P; e += kThreads) {
      const int n = e / P, p = e % P;
      float s = 0.f;
      for (int l = 0; l < len; ++l)
        s = fmaf(Bs[l * NS + n] * wl[l], xs[l * P + p], s);
      st[e] = decay * st[e] + s;
    }
  }
  __syncthreads();
  float* hb = hout + ((long)b * H + h) * P * N;
  for (int e = tid; e < P * N; e += kThreads) {
    const int p = e / N, n = e % N;
    hb[e] = st[n * P + p];
  }
}

template <typename T>
cudaError_t launch(const void* x, const void* dt, const void* A,
                   const void* Bm, const void* Cm, void* y, void* hout, int B,
                   int S, int H, int P, int N, cudaStream_t stream) {
  auto kern = ssd_scan_kernel<T>;
  const int smem = smem_floats(N, P) * (int)sizeof(float);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return e;
  }
  kern<<<dim3(H, B), kThreads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const float*>(dt),
      static_cast<const float*>(A), static_cast<const T*>(Bm),
      static_cast<const T*>(Cm), static_cast<T*>(y),
      static_cast<float*>(hout), S, H, P, N);
  return cudaGetLastError();
}

}  // namespace

// Plain C entry point (bound with ctypes).  x, Bm, Cm and y are all f32
// (bf16 = 0) or all bf16 (bf16 = 1); dt, A and hout are f32; all
// contiguous, in the layout above.  The caller validates shapes, allocates
// y and hout and passes the stream.  Returns the cudaError_t of the launch
// (0 = success).
extern "C" int ssd_scan_launch(const void* x, const void* dt, const void* A,
                               const void* Bm, const void* Cm, void* y,
                               void* hout, int B, int S, int H, int P, int N,
                               int bf16, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B <= 0 || S <= 0 || H <= 0 || P <= 0 || N <= 0)
    return (int)cudaErrorInvalidValue;
  if (bf16)
    return (int)launch<__nv_bfloat16>(x, dt, A, Bm, Cm, y, hout, B, S, H, P,
                                      N, s);
  return (int)launch<float>(x, dt, A, Bm, Cm, y, hout, B, S, H, P, N, s);
}
