// The FP64 tensor-core (DMMA) shapes of mma.sync on Hopper: each shape's
// fragment layout, checked against a product on the host, and its rate
// when every warp of 528 blocks of 256 threads issues 8 independent mma a
// step from registers. Kernel K2 (pyscf_isdf_tpu_torch/csrc/robust_k.cu)
// uses the fragment mapping checked here. Build and run on the card:
//
//   nvcc -gencode arch=compute_90a,code=sm_90a -O3 -o k2_dmma_probe tools/k2_dmma_probe.cu
//   ./k2_dmma_probe
#include <cstdio>
#include <cstdlib>
#include <cmath>
#include <cstdint>
#include <cuda_runtime.h>

#define CK(x) do { cudaError_t e = (x); if (e != cudaSuccess) { printf("CUDA error %s at %d\n", cudaGetErrorString(e), __LINE__); exit(1);} } while (0)

__device__ __forceinline__ void mma_884(double* c, const double* a, const double* b) {
  asm volatile("mma.sync.aligned.m8n8k4.row.col.f64.f64.f64.f64 {%0,%1}, {%2}, {%3}, {%0,%1};\n"
               : "+d"(c[0]), "+d"(c[1]) : "d"(a[0]), "d"(b[0]));
}
__device__ __forceinline__ void mma_1684(double* c, const double* a, const double* b) {
  asm volatile("mma.sync.aligned.m16n8k4.row.col.f64.f64.f64.f64 {%0,%1,%2,%3}, {%4,%5}, {%6}, {%0,%1,%2,%3};\n"
               : "+d"(c[0]), "+d"(c[1]), "+d"(c[2]), "+d"(c[3]) : "d"(a[0]), "d"(a[1]), "d"(b[0]));
}
__device__ __forceinline__ void mma_1688(double* c, const double* a, const double* b) {
  asm volatile("mma.sync.aligned.m16n8k8.row.col.f64.f64.f64.f64 {%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
               : "+d"(c[0]), "+d"(c[1]), "+d"(c[2]), "+d"(c[3])
               : "d"(a[0]), "d"(a[1]), "d"(a[2]), "d"(a[3]), "d"(b[0]), "d"(b[1]));
}
__device__ __forceinline__ void mma_16816(double* c, const double* a, const double* b) {
  asm volatile("mma.sync.aligned.m16n8k16.row.col.f64.f64.f64.f64 {%0,%1,%2,%3}, {%4,%5,%6,%7,%8,%9,%10,%11}, {%12,%13,%14,%15}, {%0,%1,%2,%3};\n"
               : "+d"(c[0]), "+d"(c[1]), "+d"(c[2]), "+d"(c[3])
               : "d"(a[0]), "d"(a[1]), "d"(a[2]), "d"(a[3]), "d"(a[4]), "d"(a[5]), "d"(a[6]), "d"(a[7]),
                 "d"(b[0]), "d"(b[1]), "d"(b[2]), "d"(b[3]));
}

// Layout check: A (M x K) row-major, B given as (N x K) row-major (i.e. "col"), C (M x N).
// M = 16 (8 for 884), N = 8, K = 4/8/16. Fragment mapping under test:
//   A: a[i] -> row gid + 8*(i&1), col tig + 4*(i>>1)     (884: row gid, col tig)
//   B: b[i] -> k tig + 4*i, n gid
//   C: c[i] -> row gid + 8*(i>>1), col 2*tig + (i&1)
template <int SHAPE>
__global__ void layout_kernel(const double* A, const double* Bt, double* C) {
  const int lane = threadIdx.x, gid = lane >> 2, tig = lane & 3;
  constexpr int K = SHAPE == 884 ? 4 : SHAPE == 1684 ? 4 : SHAPE == 1688 ? 8 : 16;
  constexpr int NA = SHAPE == 884 ? 1 : SHAPE == 1684 ? 2 : SHAPE == 1688 ? 4 : 8;
  constexpr int NB = K / 4;
  double a[8], b[4], c[4] = {0, 0, 0, 0};
  for (int i = 0; i < NA; ++i) {
    int r = SHAPE == 884 ? gid : gid + 8 * (i & 1);
    int k = SHAPE == 884 ? tig : tig + 4 * (i >> 1);
    a[i] = A[r * K + k];
  }
  for (int i = 0; i < NB; ++i) b[i] = Bt[gid * K + tig + 4 * i];
  if (SHAPE == 884) mma_884(c, a, b);
  if (SHAPE == 1684) mma_1684(c, a, b);
  if (SHAPE == 1688) mma_1688(c, a, b);
  if (SHAPE == 16816) mma_16816(c, a, b);
  const int NC = SHAPE == 884 ? 2 : 4;
  for (int i = 0; i < NC; ++i) C[(gid + 8 * (i >> 1)) * 8 + 2 * tig + (i & 1)] = c[i];
}

template <int SHAPE>
__global__ void rate_kernel(int iters, double* out) {
  double a[8], b[4], c[8][4];
  for (int i = 0; i < 8; ++i) a[i] = 1e-3 * (threadIdx.x + i);
  for (int i = 0; i < 4; ++i) b[i] = 1e-3 * (threadIdx.x - i);
  for (int j = 0; j < 8; ++j) for (int i = 0; i < 4; ++i) c[j][i] = 0;
  for (int it = 0; it < iters; ++it) {
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      if (SHAPE == 884) mma_884(c[j], a, b);
      if (SHAPE == 1684) mma_1684(c[j], a, b);
      if (SHAPE == 1688) mma_1688(c[j], a, b);
      if (SHAPE == 16816) mma_16816(c[j], a, b);
    }
  }
  double s = 0;
  for (int j = 0; j < 8; ++j) for (int i = 0; i < 4; ++i) s += c[j][i];
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
}

__global__ void cpasync_kernel(const double* src, double* dst, int n) {
  __shared__ __align__(16) double s[64];
  int t = threadIdx.x;
  uint32_t sa = static_cast<uint32_t>(__cvta_generic_to_shared(s + 2 * t));
  int bytes = (2 * t < n) ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" :: "r"(sa), "l"(src + 2 * t), "r"(bytes));
  asm volatile("cp.async.commit_group;\n" ::);
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
  __syncthreads();
  dst[2 * t] = s[2 * t];
  dst[2 * t + 1] = s[2 * t + 1];
}

template <int SHAPE>
void run(int iters) {
  constexpr int M = SHAPE == 884 ? 8 : 16;
  constexpr int K = SHAPE == 884 ? 4 : SHAPE == 1684 ? 4 : SHAPE == 1688 ? 8 : 16;
  double hA[16 * 16], hB[8 * 16], hC[16 * 8], ref[16 * 8];
  for (int i = 0; i < M * K; ++i) hA[i] = std::sin(1.0 + i);
  for (int i = 0; i < 8 * K; ++i) hB[i] = std::cos(2.0 + 3 * i);
  for (int m = 0; m < M; ++m) for (int n = 0; n < 8; ++n) {
    double s = 0; for (int k = 0; k < K; ++k) s += hA[m * K + k] * hB[n * K + k]; ref[m * 8 + n] = s; }
  double *dA, *dB, *dC, *dO;
  CK(cudaMalloc(&dA, sizeof hA)); CK(cudaMalloc(&dB, sizeof hB)); CK(cudaMalloc(&dC, sizeof hC));
  CK(cudaMemcpy(dA, hA, sizeof hA, cudaMemcpyHostToDevice));
  CK(cudaMemcpy(dB, hB, sizeof hB, cudaMemcpyHostToDevice));
  CK(cudaMemset(dC, 0, sizeof hC));
  layout_kernel<SHAPE><<<1, 32>>>(dA, dB, dC);
  CK(cudaGetLastError()); CK(cudaDeviceSynchronize());
  CK(cudaMemcpy(hC, dC, sizeof hC, cudaMemcpyDeviceToHost));
  double err = 0;
  for (int i = 0; i < M * 8; ++i) err = fmax(err, fabs(hC[i] - ref[i]));
  const int blocks = 132 * 4, threads = 256;
  CK(cudaMalloc(&dO, blocks * threads * sizeof(double)));
  rate_kernel<SHAPE><<<blocks, threads>>>(10, dO);
  CK(cudaDeviceSynchronize());
  cudaEvent_t e0, e1; cudaEventCreate(&e0); cudaEventCreate(&e1);
  cudaEventRecord(e0);
  rate_kernel<SHAPE><<<blocks, threads>>>(iters, dO);
  cudaEventRecord(e1); CK(cudaEventSynchronize(e1));
  float ms; cudaEventElapsedTime(&ms, e0, e1);
  double flops = 2.0 * M * 8 * K * 8.0 * iters * (blocks * threads / 32.0);
  printf("m%dn8k%d f64: layout max err %.3e, rate %.2f TFLOP/s (%.3f ms)\n", M, K, err, flops / ms / 1e9, ms);
  cudaFree(dA); cudaFree(dB); cudaFree(dC); cudaFree(dO);
}

int main() {
  run<884>(4096);
  run<1684>(4096);
  run<1688>(2048);
  run<16816>(1024);
  double h[64], *d, *o;
  for (int i = 0; i < 64; ++i) h[i] = i;
  CK(cudaMalloc(&d, sizeof h)); CK(cudaMalloc(&o, sizeof h));
  CK(cudaMemcpy(d, h, sizeof h, cudaMemcpyHostToDevice));
  cpasync_kernel<<<1, 32>>>(d, o, 40);
  CK(cudaDeviceSynchronize());
  CK(cudaMemcpy(h, o, sizeof h, cudaMemcpyDeviceToHost));
  printf("cp.async zfill: h[38]=%g h[39]=%g h[40]=%g h[63]=%g (expect 38 39 0 0)\n", h[38], h[39], h[40], h[63]);
  return 0;
}
