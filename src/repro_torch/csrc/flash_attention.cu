// Blocked online-softmax (flash) attention for Hopper, GQA layout.
//
// Replaces the Pallas TPU kernel src/repro/kernels/flash_attention.py::
// flash_attention (body _kernel; GQA wrapper src/repro/kernels/ops.py::
// flash_attention).  For batch b, query head hq and query row i:
//
//   s_ij  = scale * q_i . k_j            (j masked: -1e30, the TPU's value)
//   o_i   = sum_j softmax_j(s_i.) v_j    (f32 running max m, sum l, acc)
//
// with k and v taken from kv head hkv = hq / (Hq / Hkv): the kernels index
// the shared kv head, they never materialise the GQA repeat.  Masks: keys
// at or past S; causal (j <= i); sliding window (j > i - window).  The
// final division is acc / max(l, 1e-30), so a row with nothing unmasked
// gives what the TPU kernel gives.  Key tiles that no row of a query tile
// reaches (above the causal diagonal, left of the window) are skipped.
//
// Layout: q (B, S, Hq, HD), k/v (B, S, Hkv, HD), o (B, S, Hq, HD), all
// contiguous, all bf16 or all f32; HD in {16, 32, 64, 128, 256} (256:
// RecurrentGemma-2B's MQA layers).
//
// What bounds it on the H100: operations.  At the Yi-6B prefill of
// chip_smoke.py (B=4, S=2048, Hq=32, Hkv=4, HD=128, bf16, causal) the work
// is 4 * B * Hq * HD * S(S+1)/2 = 137.5 GFLOP, 0.139 ms at 989 TFLOP/s on
// the bf16 tensor cores, against 75.5 MB of q, k, v and o (22.5 us at
// 3.35 TB/s).
//
// bf16: the tensor-core kernel (flash_wgmma_kernel<HD>).  One block of
// 288 threads per (128-row query tile, hq, b): two consumer warpgroups own
// 64 query rows each, one producer warp issues the loads.  At HD 256 a
// block takes 64 query rows and its two warpgroups split the output
// columns (Geo's note: the whole accumulator spilled).
//  * Loads: TMA (cp.async.bulk.tensor, 4-d tensor maps over (HD, H, S, B)
//    built host-side through the runtime's driver entry point) into a ring
//    of two K/V stages completed on mbarriers ("full", with the bytes
//    expected; "empty", one arrival per consumer warp).  Boxes past S are
//    zero-filled by the TMA unit; keys past S are masked.  The tiles use
//    the widest swizzle that fits a row (128 B; 64 B at HD 32; 32 B at
//    HD 16), the one the wgmma descriptors name.
//  * Products: S = Q K^T as wgmma m64n64k16 with Q and K from shared
//    memory (K-major); P V as wgmma m64nNk16 with P converted to bf16 in
//    registers (the S accumulator's layout is the A fragment's) and V from
//    shared memory as the MN-major ("transposed") B operand, N = 64 (two
//    instructions at HD 128), 32 or 16.  f32 accumulators.
//  * Softmax: f32 in registers, in log2 units (scale * log2 e folded in,
//    ex2.approx), row max by quad shuffles, the row sum kept per thread and
//    reduced over the quad once at the end.  Masks at -1e30, only on tiles
//    that need one.
//  * Schedule: blocks late in the causal triangle go first (the linear
//    block index runs the query tiles backwards) and the query heads of a
//    kv head are neighbours, so their K/V tiles are read from L2.
//  * Shared memory: 2 query tiles (1 at HD 256) + 2 stages x (K, V) tiles
//    of 64 x HD bf16 + barriers + 1 KB alignment slack (99,368 bytes at HD
//    128, 164,904 at HD 256; one block an SM).  Registers (ptxas -v,
//    chip_smoke.py's build line): 157 a thread at HD 128 (117, 96, 80 at
//    HD 64, 32, 16), no spills.
//  * On the H100 at the Yi-6B shape: 0.439 ms, 313 TFLOP/s, 3.2x the
//    operations bound (PERF.md).
//  * Left on the table: softmax and the two products of one warpgroup do
//    not overlap (the other warpgroup's fill the gap), no intra-warpgroup
//    ping-pong, no setmaxnreg, the output is written from registers.
//
// f32: the CUDA-core kernel of the first port (flash_simt_kernel<HD>), kept
// because TF32 tensor cores would not meet the f32 bar of 2e-5.  It runs
// only in the f32 checks, never in the bf16 prefill.  One block of 256
// threads per (64-row query tile, hq, b); Q and K staged transposed in
// shared memory, V row-major; each thread owns 4 query rows x 4 keys of
// the score tile and 4 rows x HD/16 columns of the accumulator; row
// statistics by 16-lane shuffles; P through shared memory.  118,272 bytes
// of shared memory and 99 registers a thread at HD 128.
//
// No atomics anywhere: every sum has a fixed order, so two launches on the
// same inputs are bit-identical.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
//        -Xcompiler -fPIC (repro_torch/kernels/build.py); called via ctypes.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

#include "hopper.cuh"

namespace {

constexpr float kNegInf = -1e30f;    // the TPU kernel's mask value

namespace simt {

constexpr int kBQ = 64;              // query rows per block
constexpr int kBK = 64;              // keys per tile
constexpr int kThreads = 256;        // 16 row groups x 16 column lanes
constexpr int kQStride = kBQ + 4;    // Qs[d][row], float4-aligned rows
constexpr int kKStride = kBK + 1;    // Ks[d][key], odd: conflict-free
constexpr int kPStride = kBQ + 4;    // Ps[key][row], float4-aligned rows

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
flash_simt_kernel(const T* __restrict__ q, const T* __restrict__ k,
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

template <int HD>
cudaError_t launch(const float* q, const float* k, const float* v, float* o,
                   int B, int S, int Hq, int Hkv, float scale, int causal,
                   int window, cudaStream_t stream) {
  auto kern = flash_simt_kernel<HD, float>;
  const int smem = smem_floats(HD) * (int)sizeof(float);
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return e;
  const dim3 grid((S + kBQ - 1) / kBQ, Hq, B);
  kern<<<grid, kThreads, smem, stream>>>(q, k, v, o, S, Hq, Hkv, scale,
                                         causal, window);
  return cudaGetLastError();
}

}  // namespace simt

namespace wg {

using namespace hopper;

constexpr int kWQ = 64;          // query rows per consumer warpgroup
constexpr int kBK = 64;          // keys per tile
constexpr int kStages = 2;       // K/V ring depth
constexpr int kConsumers = 256;  // two consumer warpgroups
constexpr int kThreads = kConsumers + 32;   // + one producer warp
constexpr float kLog2e = 1.4426950408889634f;

// Tile geometry for head dim HD: a tile of R rows is stored as NA swizzle
// atoms of R rows x AC columns (SW bytes a row), atom after atom, exactly
// as the TMA box {AC, 1, R, 1} with the SW-byte swizzle writes it.
//
// Up to HD 128 a block holds NQ = 2 query tiles, one per consumer
// warpgroup, and each warpgroup accumulates all HD output columns.  At HD
// 256 a 64 x 256 f32 accumulator is 128 registers a thread, and with the
// score tile that spilled (ptxas: 168 registers a thread, the most a
// 288-thread block of warpgroups gets, and 1 KB of spill stores).  So
// there the block holds NQ = 1 query tile and the two warpgroups split the
// output columns: both form the same scores (the same instructions on the
// same tiles, so the same bits) and each multiplies P by its own half of
// V, NACC = NA / 2 atoms.  Q K^T runs twice, 1.5x the products of one pass.
template <int HD>
struct Geo {
  static constexpr int SW = HD * 2 < 128 ? HD * 2 : 128;
  static constexpr int AC = SW / 2;
  static constexpr int NA = HD / AC;
  static constexpr uint32_t SWZ = SW == 128 ? kSw128 : SW == 64 ? kSw64
                                                                : kSw32;
  static constexpr int NQ = HD > 128 ? 1 : 2;      // query tiles a block
  static constexpr int BQ = 64 * NQ;               // query rows a block
  static constexpr int NACC = NA / (3 - NQ);       // atoms a warpgroup owns
  static constexpr int TILE = 64 * HD * 2;          // one 64-row tile, bytes
  static constexpr int Q_OFF = 0;                   // NQ query tiles
  static constexpr int K_OFF = NQ * TILE;           // kStages K tiles
  static constexpr int V_OFF = K_OFF + kStages * TILE;
  static constexpr int BAR_OFF = V_OFF + kStages * TILE;
  static constexpr int SMEM = BAR_OFF + 8 * (1 + 2 * kStages) + 1024;
};

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&h);
}

// the key tiles [lo, hi] that some valid row of [r0, r0 + rows) reaches
__device__ __forceinline__ void tile_range(int r0, int rows, int S,
                                           int causal, int window, int& lo,
                                           int& hi) {
  const int n_tiles = (S + kBK - 1) / kBK;
  const int last = min(r0 + rows, S) - 1;
  hi = causal ? min(n_tiles - 1, last / kBK) : n_tiles - 1;
  lo = 0;
  if (window > 0) {
    const int first_key = r0 - window + 1;
    lo = first_key > 0 ? first_key / kBK : 0;
  }
  if (last < r0) hi = lo - 1;      // no valid row: no tile
}

template <int HD>
__global__ void __launch_bounds__(kThreads, 1)
flash_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                   const __grid_constant__ CUtensorMap tk,
                   const __grid_constant__ CUtensorMap tv,
                   __nv_bfloat16* __restrict__ o, int B, int S, int Hq,
                   int Hkv, float scale, int causal, int window) {
  using G = Geo<HD>;
  extern __shared__ uint8_t smem_raw[];
  // the swizzle atoms repeat every 1024 bytes: align the tiles to that
  uint8_t* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint8_t* Qs = smem + G::Q_OFF;
  uint8_t* Ks = smem + G::K_OFF;
  uint8_t* Vs = smem + G::V_OFF;
  uint64_t* q_full = reinterpret_cast<uint64_t*>(smem + G::BAR_OFF);
  uint64_t* full = q_full + 1;
  uint64_t* empty = full + kStages;

  // heavy query tiles (late in the causal triangle) first; the query heads
  // of one kv head next to each other, so their K/V tiles meet in L2
  const int per_tile = Hq * B;
  const int n_qt = (S + G::BQ - 1) / G::BQ;
  const int qt = n_qt - 1 - (int)(blockIdx.x / per_tile);
  const int rem = blockIdx.x % per_tile;
  const int b = rem / Hq, hq = rem % Hq;
  const int hkv = hq / (Hq / Hkv);
  const int q0 = qt * G::BQ;
  int j_lo, j_hi;
  tile_range(q0, G::BQ, S, causal, window, j_lo, j_hi);

  const int tid = threadIdx.x;
  if (tid == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], kConsumers / 32);    // one arrival per warp
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (tid >= kConsumers) {       // the producer warp: one thread issues TMA
    if (tid != kConsumers) return;
    mbar_arrive_expect_tx(q_full, G::NQ * G::TILE);
    for (int g = 0; g < G::NQ; ++g)
      for (int a = 0; a < G::NA; ++a)
        tma_load_4d(Qs + g * G::TILE + a * 64 * G::SW, &tq, q_full,
                    a * G::AC, hq, q0 + g * kWQ, b);
    for (int j = j_lo, it = 0; j <= j_hi; ++j, ++it) {
      const int s = it % kStages;
      mbar_wait(&empty[s], ((it / kStages) & 1) ^ 1);
      mbar_arrive_expect_tx(&full[s], 2 * G::TILE);
      for (int a = 0; a < G::NA; ++a) {
        tma_load_4d(Ks + s * G::TILE + a * 64 * G::SW, &tk, &full[s],
                    a * G::AC, hkv, j * kBK, b);
        tma_load_4d(Vs + s * G::TILE + a * 64 * G::SW, &tv, &full[s],
                    a * G::AC, hkv, j * kBK, b);
      }
    }
    return;
  }

  // ---- consumer warpgroup g: query rows wq0 .. wq0 + 63, output atoms
  // a0 .. a0 + NACC - 1 ----
  const int g = tid / 128, warp = (tid % 128) / 32, lane = tid % 32;
  const int quad = lane % 4;
  const int qg = G::NQ == 2 ? g : 0;              // this warpgroup's Q tile
  const int a0 = G::NQ == 2 ? 0 : g * G::NACC;    // its first output atom
  const int wq0 = q0 + qg * kWQ;
  int w_lo, w_hi;
  tile_range(wq0, kWQ, S, causal, window, w_lo, w_hi);
  const int row0 = wq0 + 16 * warp + lane / 4;     // and row0 + 8
  const float sl = scale * kLog2e;                  // logits in log2 units
  const uint8_t* Qg = Qs + qg * G::TILE;

  float acc[G::NACC][G::AC / 2];
#pragma unroll
  for (int a = 0; a < G::NACC; ++a)
#pragma unroll
    for (int i = 0; i < G::AC / 2; ++i) acc[a][i] = 0.f;
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};

  mbar_wait(q_full, 0);
  for (int j = j_lo, it = 0; j <= j_hi; ++j, ++it) {
    const int s = it % kStages;
    mbar_wait(&full[s], (it / kStages) & 1);
    if (j >= w_lo && j <= w_hi) {
      const uint8_t* Kt = Ks + s * G::TILE;
      const uint8_t* Vt = Vs + s * G::TILE;
      // S = Q K^T on the tensor cores, 16 head dims a step
      float sc[32];
#pragma unroll
      for (int i = 0; i < 32; ++i) sc[i] = 0.f;
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk) {
        const int a = kk * 16 / G::AC, off = (kk * 16 % G::AC) * 2;
        wgmma_ss_m64n64k16(
            sc, make_desc(Qg + a * 64 * G::SW + off, 8 * G::SW, G::SWZ),
            make_desc(Kt + a * 64 * G::SW + off, 8 * G::SW, G::SWZ),
            kk > 0);
      }
      wgmma_commit();
      wgmma_wait0();
      fence_regs(sc);

      // online softmax in f32, log2 units; masks at -1e30
      const int k0 = j * kBK;
      const bool need_mask = (causal && k0 + kBK - 1 > wq0) ||
                             k0 + kBK > S ||
                             (window > 0 && k0 <= wq0 + kWQ - 1 - window);
      uint32_t p[4][4];
#pragma unroll
      for (int ri = 0; ri < 2; ++ri) {
        const int row = row0 + 8 * ri;
        float mx = kNegInf;
#pragma unroll
        for (int c = 0; c < 8; ++c)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            float& x = sc[4 * c + 2 * ri + e];
            x *= sl;
            if (need_mask) {
              const int col = k0 + 8 * c + 2 * quad + e;
              bool ok = col < S;
              if (causal) ok = ok && col <= row;
              if (window > 0) ok = ok && col > row - window;
              if (!ok) x = kNegInf;
            }
            mx = fmaxf(mx, x);
          }
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
        const float m_new = fmaxf(m[ri], mx);
        const float alpha = ex2(m[ri] - m_new);
        float rs = 0.f;
#pragma unroll
        for (int c = 0; c < 8; ++c)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            float& x = sc[4 * c + 2 * ri + e];
            x = ex2(x - m_new);
            rs += x;
          }
        l[ri] = alpha * l[ri] + rs;
        m[ri] = m_new;
#pragma unroll
        for (int a = 0; a < G::NACC; ++a)
#pragma unroll
          for (int c = 0; c < G::AC / 8; ++c) {
            acc[a][4 * c + 2 * ri] *= alpha;
            acc[a][4 * c + 2 * ri + 1] *= alpha;
          }
      }
      // P in bf16 registers: the A operand of P V, 16 keys a step (the
      // accumulator layout of S is the A-fragment layout of P)
#pragma unroll
      for (int kc = 0; kc < 4; ++kc) {
        p[kc][0] = pack_bf16(sc[8 * kc + 0], sc[8 * kc + 1]);
        p[kc][1] = pack_bf16(sc[8 * kc + 2], sc[8 * kc + 3]);
        p[kc][2] = pack_bf16(sc[8 * kc + 4], sc[8 * kc + 5]);
        p[kc][3] = pack_bf16(sc[8 * kc + 6], sc[8 * kc + 7]);
      }
      // acc += P V: V (keys x HD, HD contiguous) is the MN-major B operand
#pragma unroll
      for (int a = 0; a < G::NACC; ++a) fence_regs(acc[a]);
      wgmma_fence();
#pragma unroll
      for (int kc = 0; kc < 4; ++kc)
#pragma unroll
        for (int a = 0; a < G::NACC; ++a) {
          const uint64_t dv = make_desc(
              Vt + (a0 + a) * 64 * G::SW + 16 * kc * G::SW, 8 * G::SW,
              G::SWZ);
          if constexpr (G::AC == 64)
            wgmma_rs_m64n64k16_tb(acc[a], p[kc], dv);
          else if constexpr (G::AC == 32)
            wgmma_rs_m64n32k16_tb(acc[a], p[kc], dv);
          else
            wgmma_rs_m64n16k16_tb(acc[a], p[kc], dv);
        }
      wgmma_commit();
      wgmma_wait0();
#pragma unroll
      for (int a = 0; a < G::NACC; ++a) fence_regs(acc[a]);
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[s]);   // this warp is done with stage s
  }

  // o = acc / max(l, 1e-30); l summed over the quad in a fixed order
  const long q_row = (long)Hq * HD;
  __nv_bfloat16* ob = o + ((long)b * S * Hq + hq) * HD;
#pragma unroll
  for (int ri = 0; ri < 2; ++ri) {
    float lt = l[ri];
    lt += __shfl_xor_sync(0xffffffffu, lt, 1);
    lt += __shfl_xor_sync(0xffffffffu, lt, 2);
    const int row = row0 + 8 * ri;
    if (row >= S) continue;
    const float denom = fmaxf(lt, 1e-30f);
#pragma unroll
    for (int a = 0; a < G::NACC; ++a)
#pragma unroll
      for (int c = 0; c < G::AC / 8; ++c) {
        const int col = (a0 + a) * G::AC + 8 * c + 2 * quad;
        *reinterpret_cast<__nv_bfloat162*>(&ob[row * q_row + col]) =
            __floats2bfloat162_rn(acc[a][4 * c + 2 * ri] / denom,
                                  acc[a][4 * c + 2 * ri + 1] / denom);
      }
  }
}

// ---- host side: tensor maps and the launch ----
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType,
                                cuuint32_t, void*, const cuuint64_t*,
                                const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave,
                                CUtensorMapSwizzle, CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the driver, found through the runtime (the
// library links no -lcuda)
EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t e = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    cudaError_t e = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                            cudaEnableDefault, &found);
#endif
    if (e == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// (B, S, H, HD) bf16, boxes of {AC columns, 1 head, 64 positions, 1 batch};
// positions past S read as zeros
template <int HD>
bool make_map(CUtensorMap* map, const void* base, int B, int S, int H) {
  using G = Geo<HD>;
  EncodeTiled enc = encode_tiled();
  if (enc == nullptr) return false;
  const cuuint64_t dims[4] = {(cuuint64_t)HD, (cuuint64_t)H, (cuuint64_t)S,
                              (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)HD * 2, (cuuint64_t)H * HD * 2,
                                 (cuuint64_t)S * H * HD * 2};
  const cuuint32_t box[4] = {(cuuint32_t)G::AC, 1, 64, 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  const CUtensorMapSwizzle sw =
      G::SW == 128 ? CU_TENSOR_MAP_SWIZZLE_128B
                   : G::SW == 64 ? CU_TENSOR_MAP_SWIZZLE_64B
                                 : CU_TENSOR_MAP_SWIZZLE_32B;
  return enc(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
             const_cast<void*>(base), dims, strides, box, elem,
             CU_TENSOR_MAP_INTERLEAVE_NONE, sw,
             CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int HD>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   int B, int S, int Hq, int Hkv, float scale, int causal,
                   int window, cudaStream_t stream) {
  CUtensorMap tq, tk, tv;
  if (!make_map<HD>(&tq, q, B, S, Hq) || !make_map<HD>(&tk, k, B, S, Hkv) ||
      !make_map<HD>(&tv, v, B, S, Hkv))
    return cudaErrorInvalidValue;
  auto kern = flash_wgmma_kernel<HD>;
  const int smem = Geo<HD>::SMEM;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return e;
  const long blocks = (long)((S + Geo<HD>::BQ - 1) / Geo<HD>::BQ) * Hq * B;
  kern<<<(unsigned)blocks, kThreads, smem, stream>>>(
      tq, tk, tv, static_cast<__nv_bfloat16*>(o), B, S, Hq, Hkv, scale,
      causal, window);
  return cudaGetLastError();
}

}  // namespace wg

template <int HD>
cudaError_t launch_dtype(int bf16, const void* q, const void* k,
                         const void* v, void* o, int B, int S, int Hq,
                         int Hkv, float scale, int causal, int window,
                         cudaStream_t stream) {
  if (bf16)
    return wg::launch<HD>(q, k, v, o, B, S, Hq, Hkv, scale, causal, window,
                          stream);
  return simt::launch<HD>(static_cast<const float*>(q),
                          static_cast<const float*>(k),
                          static_cast<const float*>(v),
                          static_cast<float*>(o), B, S, Hq, Hkv, scale,
                          causal, window, stream);
}

}  // namespace

// Plain C entry point (bound with ctypes).  q/k/v/o are all f32 (bf16 = 0)
// or all bf16 (bf16 = 1), contiguous, in the layout above, bf16 ones
// 16-byte aligned (TMA); Hq % Hkv == 0.  The caller validates shapes,
// allocates o and passes the stream.  Returns the cudaError_t of the
// launch (0 = success; cudaErrorInvalidValue if a tensor map cannot be
// made).
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
    case 256:
      return (int)launch_dtype<256>(bf16, q, k, v, o, B, S, Hq, Hkv, scale,
                                    causal, window, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
