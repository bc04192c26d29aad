// Mamba-2 SSD chunked scan for Hopper.
//
// Replaces the Pallas TPU kernel src/repro/kernels/ssd_scan.py::ssd_scan
// (body _kernel; wrapper src/repro/kernels/ops.py::ssd_scan).  Per batch b
// and head h, the scalar-decay SSM
//
//   state_t = exp(dt_t A_h) state_{t-1} + dt_t B_t x_t^T     (N x P)
//   y_t     = C_t . state_t
//
// computed chunk by chunk.  Inside a chunk of L positions, with cum the
// inclusive cumsum of dt * A_h:
//
//   y_intra = ((C B^T) o exp(cum_l - cum_l') [l' <= l] o dt_l') @ x
//   y_inter = (C o exp(cum)) @ h_prev
//   S_c     = (B o dt o exp(cum_{L-1} - cum))^T @ x,
//   h_c     = exp(cum_{L-1}) h_{c-1} + S_c
//
// the TPU kernel's formulas (ssd_scan.py:140-175), gates masked BEFORE exp.
// Everything is f32 inside; y is written in x's dtype and the final state
// as (B, H, P, N) f32, the TPU wrapper's transpose (ssd_scan.py:233).
//
// Layout: x (B, S, H, P) and y in f32 or bf16; dt (B, S, H) f32; A (H,) f32;
// Bm, Cm (B, S, N) in x's dtype; all contiguous; N and P multiples of 4,
// P <= 64 (Mamba-2's head dim is 64).
//
// What bounds it on the H100: bytes.  At the Mamba-2 370M prefill of
// chip_smoke.py (B=4, S=2048, H=32, P=64, N=128, bf16 x) it must read x
// (33.6 MB), dt, Bm, Cm and write y (33.6 MB) and the state (4.2 MB):
// 76.6 MB, 22.9 us at 3.35 TB/s.  Its work at L = 64 (the causal half of
// C B^T and of the intra product, the inter product and the chunk states)
// is 11.9 GFLOP, 12 us at 989 TFLOP/s on the bf16 tensor cores; on the f32
// CUDA cores, where every product with an f32 gate or state stays, it is
// 0.18 ms at their 67 TFLOP/s peak.
//
// Design: Mamba-2's own GPU schedule, three kernels launched in order by
// the one entry point, with the chunk L = 64 (the result does not depend
// on it beyond f32 rounding; a ragged last chunk reads as zeros: dt = 0,
// x = B = C = 0, which contributes nothing and leaves cum constant):
//  (a) ssd_states_kernel, grid (chunk, b, group of 8 heads), fully
//      parallel (4,096 (b, chunk, head) items at the Mamba-2 shape): B of
//      the chunk staged once for the group; each head's x and dt fetched
//      into registers while the previous head computes; per head the
//      dt * A cumsum (a warp scan), then S_c = (B o w)^T x with 4 x 4
//      register tiles, written to an f32 scratch (B, n_chunks, H, N, P),
//      and cum_{L-1} to a second scratch (B, n_chunks, H).  The wrapper
//      allocates both (torch.empty): 134,217,728 + 16,384 bytes at the
//      Mamba-2 shape.
//  (b) ssd_pass_kernel, grid (N P / 1024, b * H): the only sequential
//      part, elementwise over N x P in float4s: walks the chunks (8
//      chunks' loads in flight at once), writes the state entering each
//      chunk over its S_c in place, and the final state to hout.
//  (c) ssd_chunk_scan_kernel, grid (chunk, b, group of 8 heads), fully
//      parallel: C and B of the chunk staged once, transposed (a
//      thread's loads in flight together); G = C B^T
//      (L x L) formed once for the group's heads and kept in registers (a
//      4 x 4 tile a thread); per head the gated M = G o gates o dt goes
//      to shared memory, h_prev arrives by cp.async (overlapping the
//      staging of x and the gates), and y = M x + exp(cum) (C h_prev)
//      with 4 x 4 register tiles, M's zero upper triangle skipped.
// All products are f32 FMA on the CUDA cores (the bf16 tensor cores would
// have to round a gated operand or the state).  The scratch moves 4 x
// 134 MB ((a) writes, (b) reads and writes, (c) reads: 0.16 ms at
// 3.35 TB/s); with the f32 FMA that, not the 77 MB of inputs and outputs,
// is what bounds this design.
//
// Shared memory: (a) 4 (L N + L P + 3 L) = 49,920 bytes and (c)
// 4 (N L + max(N L, N P) + L^2 + L P + 3 L) = 99,072 bytes at N = 128,
// P = 64 (two blocks an SM; the launch opts in above 48 KB).  Registers a
// thread (ptxas -v, chip_smoke.py's build line), bf16 / f32 x: (a) 77 /
// 99, (b) 56, (c) 127 / 128 (the f32 instance spills 4 bytes).
// On the H100 at the Mamba-2 shape: 0.55 ms for the three passes (PERF.md).
//
// Left on the table: G on the tensor cores (its operands are the bf16
// inputs, so the products would be exact); the scratch round trip (a
// fused states-and-pass kernel with a decoupled look-back would save
// ~0.1 ms); B and C are staged once a block, not double-buffered.
//
// No atomics: every sum has a fixed order, so two launches on the same
// inputs are bit-identical.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
//        -Xcompiler -fPIC (repro_torch/kernels/build.py); called via ctypes.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

#include "hopper.cuh"

namespace {

constexpr int kL = 64;          // positions per chunk (2 per lane of a warp)
constexpr int kThreads = 256;
constexpr int kHG = 8;          // heads per block in passes (a) and (c)
constexpr int kPassBatch = 8;   // chunks a thread of pass (b) loads at once

// Inclusive cumsum of dt * a over the chunk, by warp 0 (two positions a
// lane, __shfl_up_sync).  Rounded adds and multiplies only (no
// contraction), so passes (a) and (c) compute the same cum bit for bit.
__device__ __forceinline__ void chunk_cumsum(const float* dts, float a,
                                             float* cum, int lane) {
  const float a0 = __fmul_rn(dts[2 * lane], a);
  const float a1 = __fmul_rn(dts[2 * lane + 1], a);
  float run = __fadd_rn(a0, a1);
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const float t = __shfl_up_sync(0xffffffffu, run, off);
    if (lane >= off) run = __fadd_rn(run, t);
  }
  float before = __shfl_up_sync(0xffffffffu, run, 1);
  if (lane == 0) before = 0.f;
  cum[2 * lane] = __fadd_rn(before, a0);
  cum[2 * lane + 1] = __fadd_rn(cum[2 * lane], a1);
}

// Four consecutive elements of T as one load (8 bytes of bf16, 16 of f32)
template <typename T> struct Vec4;
template <> struct Vec4<float> { using raw = float4; };
template <> struct Vec4<__nv_bfloat16> { using raw = uint2; };

__device__ __forceinline__ float4 zero4(float4) {
  return make_float4(0.f, 0.f, 0.f, 0.f);
}
__device__ __forceinline__ uint2 zero4(uint2) { return make_uint2(0u, 0u); }
__device__ __forceinline__ float4 to_f32x4(float4 v) { return v; }
__device__ __forceinline__ float4 to_f32x4(uint2 u) {
  const float2 lo =
      __bfloat1622float2(*reinterpret_cast<__nv_bfloat162*>(&u.x));
  const float2 hi =
      __bfloat1622float2(*reinterpret_cast<__nv_bfloat162*>(&u.y));
  return make_float4(lo.x, lo.y, hi.x, hi.y);
}
template <typename T>
__device__ __forceinline__ typename Vec4<T>::raw load4(const T* p) {
  return *reinterpret_cast<const typename Vec4<T>::raw*>(p);
}
__device__ __forceinline__ void store4(float* p, float4 v) {
  *reinterpret_cast<float4*>(p) = v;
}
__device__ __forceinline__ void store4(__nv_bfloat16* p, float4 v) {
  __nv_bfloat162 lo = __floats2bfloat162_rn(v.x, v.y);
  __nv_bfloat162 hi = __floats2bfloat162_rn(v.z, v.w);
  *reinterpret_cast<uint2*>(p) = make_uint2(
      *reinterpret_cast<uint32_t*>(&lo), *reinterpret_cast<uint32_t*>(&hi));
}

// One head's x (kL x P) and dt over the chunk, fetched into registers
// while the previous head computes (kXV vectors a thread: P <= 64), then
// put into shared memory as f32.  Positions past S read as zeros.
constexpr int kXV = 4;
template <typename T>
struct XFetch {
  typename Vec4<T>::raw v[kXV];
  float dt;

  __device__ __forceinline__ void fetch(const T* x, const float* dtp, int b,
                                        int S, int H, int P, int h, int c0,
                                        int len, int tid) {
    const long xrow = (long)H * P;
    const T* xb = x + ((long)b * S + c0) * xrow + (long)h * P;
    const int nv = kL * P / 4;
#pragma unroll
    for (int i = 0; i < kXV; ++i) {
      const int e = 4 * (tid + i * kThreads), l = e / P, p = e % P;
      v[i] = e < 4 * nv && l < len ? load4(xb + l * xrow + p) : zero4(v[i]);
    }
    dt = tid < len ? dtp[((long)b * S + c0 + tid) * H + h] : 0.f;
  }
  __device__ __forceinline__ void put(float* xs, float* dts, int P,
                                      int tid) const {
#pragma unroll
    for (int i = 0; i < kXV; ++i) {
      const int e = 4 * (tid + i * kThreads);
      if (e < kL * P)
        *reinterpret_cast<float4*>(&xs[e]) = to_f32x4(v[i]);
    }
    if (tid < kL) dts[tid] = dt;
  }
};

// Stage the chunk's rows of an (S, N) matrix of T (B or C of batch b) as
// f32 in shared memory, row-major dst[l][n] or transposed dst[n][l]; a
// thread's loads (8 vectors a round) are in flight together.
template <bool kTransposed, typename T>
__device__ __forceinline__ void stage_bc(const T* src, float* dst, int b,
                                         int S, int N, int c0, int len,
                                         int tid) {
  constexpr int kBatch = 8;
  const int nv = kL * N / 4;
  const T* sb = src + ((long)b * S + c0) * N;
  for (int v0 = tid; v0 < nv; v0 += kBatch * kThreads) {
    typename Vec4<T>::raw r[kBatch];
#pragma unroll
    for (int i = 0; i < kBatch; ++i) {
      const int v = v0 + i * kThreads;
      const int l = kTransposed ? v % kL : 4 * v / N;
      const int n = kTransposed ? 4 * (v / kL) : 4 * v % N;
      r[i] = v < nv && l < len ? load4(sb + l * N + n) : zero4(r[i]);
    }
#pragma unroll
    for (int i = 0; i < kBatch; ++i) {
      const int v = v0 + i * kThreads;
      if (v >= nv) break;
      const float4 f = to_f32x4(r[i]);
      if (kTransposed) {     // consecutive threads: consecutive l
        const int l = v % kL, n = 4 * (v / kL);
        dst[(n + 0) * kL + l] = f.x;
        dst[(n + 1) * kL + l] = f.y;
        dst[(n + 2) * kL + l] = f.z;
        dst[(n + 3) * kL + l] = f.w;
      } else {
        *reinterpret_cast<float4*>(&dst[4 * v]) = f;
      }
    }
  }
}

int states_smem_floats(int N, int P) { return kL * N + kL * P + 3 * kL; }
int scan_smem_floats(int N, int P) {
  return N * kL + (N * kL > N * P ? N * kL : N * P) + kL * kL + kL * P +
         3 * kL;
}

// (a) chunk states: for each (b, chunk, head) S_c = (B o w)^T x (N x P),
// w_l = dt_l exp(cum_last - cum_l); and cum_last.  Grid (chunk, b, head
// group); B staged once for the group's heads.
template <typename T>
__global__ void __launch_bounds__(kThreads)
ssd_states_kernel(const T* __restrict__ x, const float* __restrict__ dt,
                  const float* __restrict__ A, const T* __restrict__ Bm,
                  float* __restrict__ states, float* __restrict__ cum_last,
                  int S, int H, int P, int N) {
  extern __shared__ __align__(16) float smem[];
  float* Bs = smem;                  // kL x N
  float* xw = Bs + kL * N;           // kL x P: x, then w_l x_l
  float* dts = xw + kL * P;
  float* cum = dts + kL;
  float* wl = cum + kL;

  const int tid = threadIdx.x;
  const int c = blockIdx.x, b = blockIdx.y, h0 = blockIdx.z * kHG;
  const int h_end = min(h0 + kHG, H);
  const int nc = gridDim.x;
  const int c0 = c * kL, len = min(kL, S - c0);
  XFetch<T> next;
  next.fetch(x, dt, b, S, H, P, h0, c0, len, tid);
  stage_bc<false>(Bm, Bs, b, S, N, c0, len, tid);
  const int P4 = P / 4, units = (N / 4) * P4;
  for (int h = h0; h < h_end; ++h) {
    __syncthreads();   // Bs staged; the previous head's readers are done
    next.put(xw, dts, P, tid);
    if (h + 1 < h_end) next.fetch(x, dt, b, S, H, P, h + 1, c0, len, tid);
    __syncthreads();
    if (tid < 32) chunk_cumsum(dts, A[h], cum, tid);
    __syncthreads();
    const float c_last = cum[kL - 1];
    if (tid < kL) wl[tid] = dts[tid] * expf(c_last - cum[tid]);
    if (tid == 0) cum_last[((long)b * nc + c) * H + h] = c_last;
    __syncthreads();
    for (int e = tid; e < kL * P; e += kThreads) xw[e] = wl[e / P] * xw[e];
    __syncthreads();
    float* out = states + (((long)b * nc + c) * H + h) * N * P;
    for (int u = tid; u < units; u += kThreads) {
      const int n = 4 * (u / P4), p = 4 * (u % P4);
      float acc[4][4] = {};
#pragma unroll 4
      for (int l = 0; l < kL; ++l) {
        const float4 b4 = *reinterpret_cast<const float4*>(&Bs[l * N + n]);
        const float4 x4 = *reinterpret_cast<const float4*>(&xw[l * P + p]);
        const float bv[4] = {b4.x, b4.y, b4.z, b4.w};
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          acc[i][0] = fmaf(bv[i], x4.x, acc[i][0]);
          acc[i][1] = fmaf(bv[i], x4.y, acc[i][1]);
          acc[i][2] = fmaf(bv[i], x4.z, acc[i][2]);
          acc[i][3] = fmaf(bv[i], x4.w, acc[i][3]);
        }
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
        *reinterpret_cast<float4*>(&out[(n + i) * P + p]) =
            make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
    }
  }
}

// (b) state passing, sequential over the chunks, elementwise over N x P:
// h_c = exp(cum_last_c) h_{c-1} + S_c.  Overwrites each S_c with the state
// entering chunk c, and writes the final state as hout (B, H, P, N).
__global__ void __launch_bounds__(kThreads)
ssd_pass_kernel(float* __restrict__ states,
                const float* __restrict__ cum_last, float* __restrict__ hout,
                int nc, int H, int P, int N) {
  const int bh = blockIdx.y, b = bh / H, h = bh % H;
  const int i4 = blockIdx.x * kThreads + threadIdx.x;
  if (i4 >= N * P / 4) return;
  float4 hc = make_float4(0.f, 0.f, 0.f, 0.f);
  // kPassBatch chunks' loads in flight at once: the chain runs through hc
  // only, not through memory
  for (int c0 = 0; c0 < nc; c0 += kPassBatch) {
    float4 s[kPassBatch];
    float d[kPassBatch];
#pragma unroll
    for (int i = 0; i < kPassBatch; ++i) {
      if (c0 + i >= nc) break;
      const long base = ((long)b * nc + c0 + i) * H + h;
      s[i] = reinterpret_cast<const float4*>(states + base * N * P)[i4];
      d[i] = cum_last[base];
    }
#pragma unroll
    for (int i = 0; i < kPassBatch; ++i) {
      if (c0 + i >= nc) break;
      const long base = ((long)b * nc + c0 + i) * H + h;
      reinterpret_cast<float4*>(states + base * N * P)[i4] = hc;
      const float e = expf(d[i]);
      hc.x = __fadd_rn(__fmul_rn(e, hc.x), s[i].x);
      hc.y = __fadd_rn(__fmul_rn(e, hc.y), s[i].y);
      hc.z = __fadd_rn(__fmul_rn(e, hc.z), s[i].z);
      hc.w = __fadd_rn(__fmul_rn(e, hc.w), s[i].w);
    }
  }
  const int n = (4 * i4) / P, p = (4 * i4) % P;
  float* hb = hout + ((long)b * H + h) * P * N;
  hb[(p + 0) * N + n] = hc.x;
  hb[(p + 1) * N + n] = hc.y;
  hb[(p + 2) * N + n] = hc.z;
  hb[(p + 3) * N + n] = hc.w;
}

// (c) chunk scan: G = C B^T once per (b, chunk) for the group's heads,
// then per head y = exp(cum_l) (C h_prev) + (G o exp(cum_l - cum_l')
// [l' <= l] o dt_l') x.  Grid (chunk, b, head group).
template <typename T>
__global__ void __launch_bounds__(kThreads, 2)
ssd_chunk_scan_kernel(const T* __restrict__ x, const float* __restrict__ dt,
                      const float* __restrict__ A, const T* __restrict__ Bm,
                      const T* __restrict__ Cm,
                      const float* __restrict__ states, T* __restrict__ y,
                      int S, int H, int P, int N) {
  extern __shared__ __align__(16) float smem[];
  float* Ct = smem;                           // N x kL (C transposed)
  float* Bt = Ct + N * kL;                    // N x kL, then ...
  float* hs = Bt;                             // ... N x P: h_prev
  float* Mt = Bt + (N * kL > N * P ? N * kL : N * P);   // kL x kL: M^T
  float* xs = Mt + kL * kL;                   // kL x P
  float* dts = xs + kL * P;
  float* cum = dts + kL;
  float* ein = cum + kL;                      // exp(cum_l)

  const int tid = threadIdx.x;
  const int c = blockIdx.x, b = blockIdx.y, h0 = blockIdx.z * kHG;
  const int h_end = min(h0 + kHG, H);
  const int nc = gridDim.x;
  const int c0 = c * kL, len = min(kL, S - c0);
  const long xrow = (long)H * P;

  XFetch<T> next;
  next.fetch(x, dt, b, S, H, P, h0, c0, len, tid);
  stage_bc<true>(Cm, Ct, b, S, N, c0, len, tid);
  stage_bc<true>(Bm, Bt, b, S, N, c0, len, tid);
  __syncthreads();
  // G = C B^T, the 4 x 4 tile (rows 4ty.., columns 4tx..) of this thread,
  // kept in registers for every head; tiles above the diagonal are zero
  const int ty = tid / 16, tx = tid % 16;
  float g[4][4] = {};
  if (tx <= ty) {
#pragma unroll 4
    for (int n = 0; n < N; ++n) {
      const float4 c4 = *reinterpret_cast<const float4*>(&Ct[n * kL + 4 * ty]);
      const float4 b4 = *reinterpret_cast<const float4*>(&Bt[n * kL + 4 * tx]);
      const float cv[4] = {c4.x, c4.y, c4.z, c4.w};
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        g[i][0] = fmaf(cv[i], b4.x, g[i][0]);
        g[i][1] = fmaf(cv[i], b4.y, g[i][1]);
        g[i][2] = fmaf(cv[i], b4.z, g[i][2]);
        g[i][3] = fmaf(cv[i], b4.w, g[i][3]);
      }
    }
  }

  const int P4 = P / 4, units = (kL / 4) * P4;
  for (int h = h0; h < h_end; ++h) {
    __syncthreads();   // G read Bt; the previous head's readers are done
    // h_prev (the state entering this chunk) by cp.async, while x and dt
    // go to shared memory and the next head's are fetched
    const float* hsrc = states + (((long)b * nc + c) * H + h) * N * P;
    for (int e = tid; e < N * P / 4; e += kThreads)
      hopper::cp_async16(&hs[4 * e], &hsrc[4 * e]);
    hopper::cp_async_commit();
    next.put(xs, dts, P, tid);
    if (h + 1 < h_end) next.fetch(x, dt, b, S, H, P, h + 1, c0, len, tid);
    __syncthreads();
    if (tid < 32) chunk_cumsum(dts, A[h], cum, tid);
    __syncthreads();
    if (tid < kL) ein[tid] = expf(cum[tid]);
    // M^T[l'][l] = G[l][l'] exp(cum_l - cum_l') dt_l' for l' <= l; the
    // mask comes before the exp, so no masked gate is ever exponentiated
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int l = 4 * ty + i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int lp = 4 * tx + j;
        Mt[lp * kL + l] =
            lp <= l ? g[i][j] * expf(cum[l] - cum[lp]) * dts[lp] : 0.f;
      }
    }
    hopper::cp_async_wait_all();
    __syncthreads();

    T* yb = y + ((long)b * S + c0) * xrow + (long)h * P;
    for (int u = tid; u < units; u += kThreads) {
      const int r = 4 * (u / P4), p = 4 * (u % P4);
      float acc[4][4] = {};
      // inter: exp(cum_l) (C h_prev)
#pragma unroll 4
      for (int n = 0; n < N; ++n) {
        const float4 c4 = *reinterpret_cast<const float4*>(&Ct[n * kL + r]);
        const float4 h4 = *reinterpret_cast<const float4*>(&hs[n * P + p]);
        const float cv[4] = {c4.x, c4.y, c4.z, c4.w};
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          acc[i][0] = fmaf(cv[i], h4.x, acc[i][0]);
          acc[i][1] = fmaf(cv[i], h4.y, acc[i][1]);
          acc[i][2] = fmaf(cv[i], h4.z, acc[i][2]);
          acc[i][3] = fmaf(cv[i], h4.w, acc[i][3]);
        }
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int q = 0; q < 4; ++q) acc[i][q] *= ein[r + i];
      // intra: + M x (M is lower triangular)
      for (int k = 0; k < r + 4; ++k) {
        const float4 m4 = *reinterpret_cast<const float4*>(&Mt[k * kL + r]);
        const float4 x4 = *reinterpret_cast<const float4*>(&xs[k * P + p]);
        const float mv[4] = {m4.x, m4.y, m4.z, m4.w};
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          acc[i][0] = fmaf(mv[i], x4.x, acc[i][0]);
          acc[i][1] = fmaf(mv[i], x4.y, acc[i][1]);
          acc[i][2] = fmaf(mv[i], x4.z, acc[i][2]);
          acc[i][3] = fmaf(mv[i], x4.w, acc[i][3]);
        }
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
        if (r + i < len)
          store4(&yb[(r + i) * xrow + p],
                 make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]));
    }
  }
}

template <typename T>
cudaError_t launch(const void* x, const void* dt, const void* A,
                   const void* Bm, const void* Cm, void* y, void* hout,
                   void* states, void* cum_last, int B, int S, int H, int P,
                   int N, cudaStream_t stream) {
  const int nc = (S + kL - 1) / kL;
  const dim3 grid(nc, B, (H + kHG - 1) / kHG);
  const int smem_a = states_smem_floats(N, P) * (int)sizeof(float);
  const int smem_c = scan_smem_floats(N, P) * (int)sizeof(float);
  auto ka = ssd_states_kernel<T>;
  auto kc = ssd_chunk_scan_kernel<T>;
  cudaError_t e = cudaFuncSetAttribute(
      ka, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_a);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(kc, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem_c);
  if (e != cudaSuccess) return e;
  ka<<<grid, kThreads, smem_a, stream>>>(
      static_cast<const T*>(x), static_cast<const float*>(dt),
      static_cast<const float*>(A), static_cast<const T*>(Bm),
      static_cast<float*>(states), static_cast<float*>(cum_last), S, H, P,
      N);
  if ((e = cudaGetLastError()) != cudaSuccess) return e;
  ssd_pass_kernel<<<dim3((N * P / 4 + kThreads - 1) / kThreads, B * H),
                    kThreads, 0, stream>>>(
      static_cast<float*>(states), static_cast<const float*>(cum_last),
      static_cast<float*>(hout), nc, H, P, N);
  if ((e = cudaGetLastError()) != cudaSuccess) return e;
  kc<<<grid, kThreads, smem_c, stream>>>(
      static_cast<const T*>(x), static_cast<const float*>(dt),
      static_cast<const float*>(A), static_cast<const T*>(Bm),
      static_cast<const T*>(Cm), static_cast<const float*>(states),
      static_cast<T*>(y), S, H, P, N);
  return cudaGetLastError();
}

}  // namespace

// Plain C entry point (bound with ctypes).  x, Bm, Cm and y are all f32
// (bf16 = 0) or all bf16 (bf16 = 1); dt, A, hout and the two scratch
// buffers are f32; all contiguous, in the layout above; N and P multiples
// of 4, P <= 64.  `states` holds B * ceil(S / 64) * H * N * P floats and
// `cum_last` B * ceil(S / 64) * H.  The caller validates shapes,
// allocates y, hout and the scratch and passes the stream.  Launches the
// three passes in order on the stream; returns the first cudaError_t (0 =
// success).
extern "C" int ssd_scan_launch(const void* x, const void* dt, const void* A,
                               const void* Bm, const void* Cm, void* y,
                               void* hout, void* states, void* cum_last,
                               int B, int S, int H, int P, int N, int bf16,
                               void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B <= 0 || S <= 0 || H <= 0 || P <= 0 || N <= 0 || P % 4 || N % 4 ||
      kL * P > 4 * kXV * kThreads)
    return (int)cudaErrorInvalidValue;
  if (bf16)
    return (int)launch<__nv_bfloat16>(x, dt, A, Bm, Cm, y, hout, states,
                                      cum_last, B, S, H, P, N, s);
  return (int)launch<float>(x, dt, A, Bm, Cm, y, hout, states, cum_last, B,
                            S, H, P, N, s);
}
