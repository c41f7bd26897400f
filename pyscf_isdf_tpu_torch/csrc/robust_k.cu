// Cross term of the robust-fit ISDF exchange.
//
// Replaces the TPU Pallas kernel _kernel of
// pyscf_isdf_tpu/ops/pallas_robust_k.py (launched by robust_k_cross):
//
//   C[P, nu] = sum_g Vxi[P, g] * t[g, P] * aoR[g, nu],
//   t[g, P]  = sum_mu aoR[g, mu] * B[P, mu]
//
// aoR (ng, nao), B (nip, nao), Vxi (nip, ng), all row-major.
// Blocks run in no order, so the TPU's sequential accumulation over g
// becomes a loop over a g slice inside each block. The grid spans
// (P tiles of TP rows) x (nsplit g slices) x (column passes of 256 nu). A
// block keeps its B tile in shared memory, stages TG rows of aoR at a time,
// forms t and z = t * Vxi^T for the TG x TP tile in shared memory (t and z
// never reach device memory) and accumulates its C tile in registers. The
// split partials go to a (nsplit, nip, nao) scratch buffer and a second
// pass sums them in a fixed order, so the result is the same from run to
// run. Plain SIMT FMA tiling; the two products are 4*ng*nip*nao flops, so
// the kernel is compute-bound at the main-path shape.
#include <cuda_runtime.h>
#include <stddef.h>

namespace {

constexpr int kThreads = 256;
constexpr int kTG = 16;                    // grid points staged per step
constexpr int kNJ = 8;                     // nu columns per thread
constexpr int kPassCols = 32 * kNJ;        // nu columns per column pass

template <typename T, int TP>
__global__ void __launch_bounds__(kThreads)
robust_k_cross_kernel(int ng, int nao, int nip, int g_per_split,
                      const T* __restrict__ aoR, const T* __restrict__ B,
                      const T* __restrict__ Vxi, T* __restrict__ partial) {
  constexpr int RP = TP / 8;               // P rows per thread
  const int lda = nao | 1;                 // odd stride: no bank conflicts
  extern __shared__ unsigned char smem_raw[];
  T* sB = reinterpret_cast<T*>(smem_raw);  // (TP, lda)
  T* sA = sB + TP * lda;                   // (TG, lda)
  T* sZ = sA + kTG * lda;                  // (TG, TP + 1)

  const int p0 = blockIdx.x * TP;
  const int split = blockIdx.y;
  const int c0 = blockIdx.z * kPassCols;
  const int tid = threadIdx.x;
  const int tx = tid & 31;
  const int ty = tid >> 5;

  for (int i = tid; i < TP * nao; i += kThreads) {
    const int r = i / nao, c = i - r * nao;
    sB[r * lda + c] = (p0 + r < nip) ? B[static_cast<size_t>(p0 + r) * nao + c] : T(0);
  }

  T acc[RP][kNJ];
#pragma unroll
  for (int i = 0; i < RP; ++i)
#pragma unroll
    for (int j = 0; j < kNJ; ++j) acc[i][j] = T(0);

  const int g_begin = split * g_per_split;
  const int g_end = min(ng, g_begin + g_per_split);
  for (int g0 = g_begin; g0 < g_end; g0 += kTG) {
    __syncthreads();                       // previous sA/sZ fully read
    for (int i = tid; i < kTG * nao; i += kThreads) {
      const int r = i / nao, c = i - r * nao;
      const int g = g0 + r;
      sA[r * lda + c] = (g < g_end) ? aoR[static_cast<size_t>(g) * nao + c] : T(0);
    }
    __syncthreads();
    // z[g, P] = (sum_mu aoR[g, mu] B[P, mu]) * Vxi[P, g]
    for (int o = tid; o < kTG * TP; o += kThreads) {
      const int gl = o % kTG, pl = o / kTG;
      const T* a = sA + gl * lda;
      const T* b = sB + pl * lda;
      T t = T(0);
      for (int mu = 0; mu < nao; ++mu) t = fma(a[mu], b[mu], t);
      const int g = g0 + gl, p = p0 + pl;
      const T v = (g < g_end && p < nip) ? Vxi[static_cast<size_t>(p) * ng + g] : T(0);
      sZ[gl * (TP + 1) + pl] = t * v;
    }
    __syncthreads();
    // C[P, nu] += sum_g z[g, P] aoR[g, nu]
    for (int gl = 0; gl < kTG; ++gl) {
      T a[kNJ];
#pragma unroll
      for (int j = 0; j < kNJ; ++j) {
        const int c = c0 + tx + 32 * j;
        a[j] = (c < nao) ? sA[gl * lda + c] : T(0);
      }
#pragma unroll
      for (int i = 0; i < RP; ++i) {
        const T z = sZ[gl * (TP + 1) + ty + 8 * i];
#pragma unroll
        for (int j = 0; j < kNJ; ++j) acc[i][j] = fma(z, a[j], acc[i][j]);
      }
    }
  }

  T* out = partial + static_cast<size_t>(split) * nip * nao;
#pragma unroll
  for (int i = 0; i < RP; ++i) {
    const int p = p0 + ty + 8 * i;
#pragma unroll
    for (int j = 0; j < kNJ; ++j) {
      const int c = c0 + tx + 32 * j;
      if (p < nip && c < nao) out[static_cast<size_t>(p) * nao + c] = acc[i][j];
    }
  }
}

// out[i] = sum_k partial[k, i], in a fixed order of k.
template <typename T>
__global__ void sum_splits_kernel(int nsplit, size_t n, const T* __restrict__ partial,
                                  T* __restrict__ out) {
  for (size_t i = blockIdx.x * static_cast<size_t>(blockDim.x) + threadIdx.x; i < n;
       i += static_cast<size_t>(gridDim.x) * blockDim.x) {
    T s = T(0);
    for (int k = 0; k < nsplit; ++k) s += partial[static_cast<size_t>(k) * n + i];
    out[i] = s;
  }
}

template <typename T>
size_t smem_bytes(int tp, int nao) {
  const size_t lda = static_cast<size_t>(nao | 1);
  return (tp * lda + kTG * lda + kTG * (tp + 1)) * sizeof(T);
}

template <typename T, int TP>
cudaError_t launch_tp(int ng, int nao, int nip, int nsplit, const T* aoR,
                      const T* B, const T* Vxi, T* partial, cudaStream_t stream) {
  const size_t smem = smem_bytes<T>(TP, nao);
  auto kernel = robust_k_cross_kernel<T, TP>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  int g_per_split = (ng + nsplit - 1) / nsplit;
  g_per_split = (g_per_split + kTG - 1) / kTG * kTG;
  const dim3 grid((nip + TP - 1) / TP, nsplit, (nao + kPassCols - 1) / kPassCols);
  kernel<<<grid, kThreads, smem, stream>>>(ng, nao, nip, g_per_split, aoR, B,
                                           Vxi, partial);
  return cudaGetLastError();
}

template <typename T>
int launch(int ng, int nao, int nip, int nsplit, int tp, const void* aoR,
           const void* B, const void* Vxi, void* partial, void* out,
           void* stream) {
  const T* a = static_cast<const T*>(aoR);
  const T* b = static_cast<const T*>(B);
  const T* v = static_cast<const T*>(Vxi);
  T* part = static_cast<T*>(partial);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (tp == 32) {
    err = launch_tp<T, 32>(ng, nao, nip, nsplit, a, b, v, part, st);
  } else if (tp == 16) {
    err = launch_tp<T, 16>(ng, nao, nip, nsplit, a, b, v, part, st);
  } else {
    err = cudaErrorInvalidValue;
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  const size_t n = static_cast<size_t>(nip) * nao;
  const int blocks = static_cast<int>((n + 255) / 256 < 4096 ? (n + 255) / 256 : 4096);
  sum_splits_kernel<T><<<blocks, 256, 0, st>>>(nsplit, n, part, static_cast<T*>(out));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int robust_k_cross_f64(int ng, int nao, int nip, int nsplit, int tp,
                                  void* aoR, void* B, void* Vxi, void* partial,
                                  void* out, void* stream) {
  return launch<double>(ng, nao, nip, nsplit, tp, aoR, B, Vxi, partial, out, stream);
}

extern "C" int robust_k_cross_f32(int ng, int nao, int nip, int nsplit, int tp,
                                  void* aoR, void* B, void* Vxi, void* partial,
                                  void* out, void* stream) {
  return launch<float>(ng, nao, nip, nsplit, tp, aoR, B, Vxi, partial, out, stream);
}
