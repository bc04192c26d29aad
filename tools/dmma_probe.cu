// FP64 tensor-core (DMMA) probe for Hopper: checks the register fragment
// layouts that csrc/gmm_estep.cu assumes for mma.sync.aligned .f64 at the
// shapes m8n8k4, m16n8k4, m16n8k8 and m16n8k16 against a host product, and
// measures each shape's throughput (independent products from registers),
// an m16n8k4 chain's latency and rate by warps and chains, and the
// statistics' pattern (products fed by shared-memory loads).
//
//   nvcc -gencode arch=compute_90a,code=sm_90a -O3 -o dmma_probe \
//        tools/dmma_probe.cu && ./dmma_probe
//
// Prints one JSON line per measurement and exits non-zero if a layout is
// wrong.
#include <cuda_runtime.h>
#include <math.h>
#include <stdio.h>
#include <stdlib.h>

// fragment element e of lane l: (row, col) of A (M x K), B (K x N), C (M x N)
// g = l / 4, t = l % 4 (PTX ISA, "Matrix fragments for mma.m16n8k*" .f64)
__host__ __device__ inline void a_rc(int M, int K, int l, int e, int& r,
                                     int& c) {
  const int g = l >> 2, t = l & 3;
  if (M == 8) { r = g; c = t; return; }
  r = g + 8 * (e & 1);
  c = t + 4 * (e >> 1);
}
__host__ __device__ inline void b_rc(int K, int l, int e, int& r, int& c) {
  const int g = l >> 2, t = l & 3;
  r = t + 4 * e;
  c = g;
}
__host__ __device__ inline void c_rc(int M, int l, int e, int& r, int& c) {
  const int g = l >> 2, t = l & 3;
  r = g + 8 * (e >> 1);
  c = 2 * t + (e & 1);
}

template <int M, int K>
__device__ __forceinline__ void mma(double* d, const double* a,
                                    const double* b) {
  if constexpr (M == 8) {
    asm volatile(
        "mma.sync.aligned.m8n8k4.row.col.f64.f64.f64.f64 {%0,%1}, {%2}, "
        "{%3}, {%0,%1};\n"
        : "+d"(d[0]), "+d"(d[1])
        : "d"(a[0]), "d"(b[0]));
  } else if constexpr (K == 4) {
    asm volatile(
        "mma.sync.aligned.m16n8k4.row.col.f64.f64.f64.f64 {%0,%1,%2,%3}, "
        "{%4,%5}, {%6}, {%0,%1,%2,%3};\n"
        : "+d"(d[0]), "+d"(d[1]), "+d"(d[2]), "+d"(d[3])
        : "d"(a[0]), "d"(a[1]), "d"(b[0]));
  } else if constexpr (K == 8) {
    asm volatile(
        "mma.sync.aligned.m16n8k8.row.col.f64.f64.f64.f64 {%0,%1,%2,%3}, "
        "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
        : "+d"(d[0]), "+d"(d[1]), "+d"(d[2]), "+d"(d[3])
        : "d"(a[0]), "d"(a[1]), "d"(a[2]), "d"(a[3]), "d"(b[0]),
          "d"(b[1]));
  } else {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f64.f64.f64.f64 "
        "{%0,%1,%2,%3}, {%4,%5,%6,%7,%8,%9,%10,%11}, {%12,%13,%14,%15}, "
        "{%0,%1,%2,%3};\n"
        : "+d"(d[0]), "+d"(d[1]), "+d"(d[2]), "+d"(d[3])
        : "d"(a[0]), "d"(a[1]), "d"(a[2]), "d"(a[3]), "d"(a[4]),
          "d"(a[5]), "d"(a[6]), "d"(a[7]), "d"(b[0]), "d"(b[1]),
          "d"(b[2]), "d"(b[3]));
  }
}

template <int M, int K>
__global__ void layout_kernel(const double* A, const double* B, double* C) {
  constexpr int NA = M * K / 32, NB = K * 8 / 32, NC = M * 8 / 32;
  const int l = threadIdx.x;
  double a[NA], b[NB], d[NC];
  for (int e = 0; e < NA; ++e) {
    int r, c;
    a_rc(M, K, l, e, r, c);
    a[e] = A[r * K + c];
  }
  for (int e = 0; e < NB; ++e) {
    int r, c;
    b_rc(K, l, e, r, c);
    b[e] = B[r * 8 + c];
  }
  for (int e = 0; e < NC; ++e) d[e] = 0.0;
  mma<M, K>(d, a, b);
  for (int e = 0; e < NC; ++e) {
    int r, c;
    c_rc(M, l, e, r, c);
    C[r * 8 + c] = d[e];
  }
}

constexpr int kChains = 8;
template <int M, int K>
__global__ void rate_kernel(double* out, int iters) {
  constexpr int NA = M * K / 32, NB = K * 8 / 32, NC = M * 8 / 32;
  double a[NA], b[NB], d[kChains][NC];
  for (int e = 0; e < NA; ++e) a[e] = 1e-3 * (threadIdx.x + e);
  for (int e = 0; e < NB; ++e) b[e] = 1e-3 * (threadIdx.x - e);
  for (int j = 0; j < kChains; ++j)
    for (int e = 0; e < NC; ++e) d[j][e] = 0.0;
  for (int i = 0; i < iters; ++i)
#pragma unroll
    for (int j = 0; j < kChains; ++j) mma<M, K>(d[j], a, b);
  double s = 0.0;
  for (int j = 0; j < kChains; ++j)
    for (int e = 0; e < NC; ++e) s += d[j][e];
  if (s == 12345.678) out[0] = s;
}

template <int M, int K>
int probe(const char* name) {
  double hA[16 * 16], hB[16 * 8], hC[16 * 8], want[16 * 8];
  for (int i = 0; i < M * K; ++i) hA[i] = (i * 37 % 101) - 50.0;
  for (int i = 0; i < K * 8; ++i) hB[i] = (i * 53 % 97) - 48.0;
  for (int r = 0; r < M; ++r)
    for (int c = 0; c < 8; ++c) {
      double s = 0.0;
      for (int k = 0; k < K; ++k) s += hA[r * K + k] * hB[k * 8 + c];
      want[r * 8 + c] = s;
    }
  double *dA, *dB, *dC;
  cudaMalloc(&dA, sizeof hA);
  cudaMalloc(&dB, sizeof hB);
  cudaMalloc(&dC, sizeof hC);
  cudaMemcpy(dA, hA, sizeof hA, cudaMemcpyHostToDevice);
  cudaMemcpy(dB, hB, sizeof hB, cudaMemcpyHostToDevice);
  layout_kernel<M, K><<<1, 32>>>(dA, dB, dC);
  cudaError_t err = cudaDeviceSynchronize();
  cudaMemcpy(hC, dC, sizeof hC, cudaMemcpyDeviceToHost);
  double worst = 0.0;
  for (int i = 0; i < M * 8; ++i) worst = fmax(worst, fabs(hC[i] - want[i]));
  // throughput: 132 SMs x 4 blocks x 8 warps, kChains independent products
  const int iters = 4096, blocks = 132 * 4, threads = 256;
  rate_kernel<M, K><<<blocks, threads>>>(dC, 16);
  cudaEvent_t e0, e1;
  cudaEventCreate(&e0);
  cudaEventCreate(&e1);
  cudaEventRecord(e0);
  rate_kernel<M, K><<<blocks, threads>>>(dC, iters);
  cudaEventRecord(e1);
  cudaEventSynchronize(e1);
  float ms = 0.f;
  cudaEventElapsedTime(&ms, e0, e1);
  const double flops =
      2.0 * M * 8 * K * kChains * (double)iters * blocks * (threads / 32);
  printf("{\"shape\": \"%s\", \"cuda_error\": %d, \"layout_max_abs_err\": "
         "%g, \"ms\": %f, \"TFLOPs\": %f}\n",
         name, (int)err, worst, ms, flops / ms / 1e9);
  cudaFree(dA);
  cudaFree(dB);
  cudaFree(dC);
  return (err == cudaSuccess && worst == 0.0) ? 0 : 1;
}

// m16n8k4 throughput with `chains` independent products a warp and
// `warps` warps an SM (one block of `warps` warps on each of 132 SMs), and
// one warp's latency of a dependent chain, in cycles a product
template <int CH>
__global__ void chain_kernel(double* out, int iters, long long* cyc) {
  double a[2] = {1e-3 * threadIdx.x, 2e-3}, b[1] = {1e-3}, d[CH][4];
  for (int j = 0; j < CH; ++j) d[j][0] = d[j][1] = d[j][2] = d[j][3] = 0.0;
  const long long t0 = clock64();
  for (int i = 0; i < iters; ++i)
#pragma unroll
    for (int j = 0; j < CH; ++j) mma<16, 4>(d[j], a, b);
  const long long t1 = clock64();
  double s = 0.0;
  for (int j = 0; j < CH; ++j) s += d[j][0] + d[j][3];
  if (s == 12345.678) out[0] = s;
  if (threadIdx.x == 0 && blockIdx.x == 0) cyc[0] = t1 - t0;
}

template <int CH>
void sweep(double* dC, long long* dcyc) {
  const int iters = 2048;
  for (int warps : {1, 2, 4, 8, 16}) {
    chain_kernel<CH><<<132, 32 * warps>>>(dC, 16, dcyc);
    cudaEvent_t e0, e1;
    cudaEventCreate(&e0);
    cudaEventCreate(&e1);
    cudaEventRecord(e0);
    chain_kernel<CH><<<132, 32 * warps>>>(dC, iters, dcyc);
    cudaEventRecord(e1);
    cudaEventSynchronize(e1);
    if (cudaGetLastError() != cudaSuccess) {   // e.g. too many registers
      printf("{\"m16n8k4_chains\": %d, \"warps_per_sm\": %d, "
             "\"launch\": \"failed\"}\n", CH, warps);
      continue;
    }
    float ms = 0.f;
    cudaEventElapsedTime(&ms, e0, e1);
    long long cyc = 0;
    cudaMemcpy(&cyc, dcyc, sizeof cyc, cudaMemcpyDeviceToHost);
    const double flops = 2.0 * 16 * 8 * 4 * CH * (double)iters * 132 * warps;
    printf("{\"m16n8k4_chains\": %d, \"warps_per_sm\": %d, \"TFLOPs\": %f, "
           "\"cycles_per_product_per_warp\": %f}\n",
           CH, warps, flops / ms / 1e9, (double)cyc / iters / CH);
  }
}

// the statistics' k-step pattern: 9 products into 9 accumulators a step,
// with B (and, every third product, A) loaded from shared memory first
// (LDS = 1) or taken from registers (LDS = 0); 8 warps on each SM
template <int LDS>
__global__ void mix_kernel(double* out, int iters, long long* cyc) {
  __shared__ double sm[64 * 52];
  for (int i = threadIdx.x; i < 64 * 52; i += blockDim.x) sm[i] = 1e-3 * i;
  __syncthreads();
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  double acc[9][4];
  for (int c = 0; c < 9; ++c) acc[c][0] = acc[c][1] = acc[c][2] = acc[c][3] = 0.0;
  double a0 = 1e-3 * lane, a1 = 2e-3, b0 = 3e-3;
  const long long t0 = clock64();
  for (int i = 0; i < iters; ++i) {
    const int p = 4 * (i & 15) + t;
    double b[9];
#pragma unroll
    for (int c = 0; c < 9; ++c) b[c] = LDS ? sm[p * 52 + 8 * (c % 5) + g] : b0;
#pragma unroll
    for (int c = 0; c < 9; ++c) {
      if (LDS && (c == 0 || c == 5 || c == 8)) {
        const double rv = sm[p];
        a0 = sm[p * 52 + 16 * (c / 4) + g] * rv;
        a1 = sm[p * 52 + 16 * (c / 4) + g + 8] * rv;
      }
      double a[2] = {a0, a1}, bb[1] = {b[c]};
      mma<16, 4>(acc[c], a, bb);
    }
  }
  const long long t1 = clock64();
  double s = 0.0;
  for (int c = 0; c < 9; ++c) s += acc[c][0] + acc[c][3];
  if (s == 12345.678) out[0] = s;
  if (threadIdx.x == 0 && blockIdx.x == 0) cyc[0] = t1 - t0;
}

template <int LDS>
void mix(double* dC, long long* dcyc, int warps) {
  const int iters = 1024;
  mix_kernel<LDS><<<132, 32 * warps>>>(dC, 16, dcyc);
  cudaEvent_t e0, e1;
  cudaEventCreate(&e0);
  cudaEventCreate(&e1);
  cudaEventRecord(e0);
  mix_kernel<LDS><<<132, 32 * warps>>>(dC, iters, dcyc);
  cudaEventRecord(e1);
  cudaEventSynchronize(e1);
  if (cudaGetLastError() != cudaSuccess) {   // e.g. too many registers
    printf("{\"mix_lds\": %d, \"warps_per_sm\": %d, \"launch\": "
           "\"failed\"}\n", LDS, warps);
    return;
  }
  float ms = 0.f;
  cudaEventElapsedTime(&ms, e0, e1);
  long long cyc = 0;
  cudaMemcpy(&cyc, dcyc, sizeof cyc, cudaMemcpyDeviceToHost);
  const double flops = 2.0 * 16 * 8 * 4 * 9 * (double)iters * 132 * warps;
  printf("{\"mix_lds\": %d, \"warps_per_sm\": %d, \"TFLOPs\": %f, "
         "\"cycles_per_product_per_warp\": %f}\n",
         LDS, warps, flops / ms / 1e9, (double)cyc / iters / 9);
}

int main() {
  {
    double* dC;
    long long* dcyc;
    cudaMalloc(&dC, 64);
    cudaMalloc(&dcyc, 8);
    for (int w : {4, 8, 16}) {
      mix<0>(dC, dcyc, w);
      mix<1>(dC, dcyc, w);
    }
    cudaFree(dC);
    cudaFree(dcyc);
  }
  {
    double* dC;
    long long* dcyc;
    cudaMalloc(&dC, 64);
    cudaMalloc(&dcyc, 8);
    sweep<1>(dC, dcyc);
    sweep<2>(dC, dcyc);
    sweep<4>(dC, dcyc);
    sweep<8>(dC, dcyc);
    cudaFree(dC);
    cudaFree(dcyc);
  }
  int bad = 0;
  bad += probe<8, 4>("m8n8k4");
  bad += probe<16, 4>("m16n8k4");
  bad += probe<16, 8>("m16n8k8");
  bad += probe<16, 16>("m16n8k16");
  return bad ? 1 : 0;
}
