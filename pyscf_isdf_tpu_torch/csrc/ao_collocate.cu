// Image-culled crystalline AO collocation (Gamma point, real).
//
// Replaces the TPU Pallas kernel _make_kernel of
// pyscf_isdf_tpu/ops/pallas_ao.py. For shell s of angular momentum L with
// K contractions and P primitives, and grid block b of NB points:
//
//   out[(s*K + k)*M + m, b*NB + i] =
//       sum_{j < counts[s,b]} sum_p coeffs[s,p,k] exp(-exps[s,p] r^2) S_Lm(d)
//   d = (coordsT[:, b*NB + i] - centers[s]) - imgs[s, b, :, j],  M = 2L+1
//
// One CTA per (grid block, shell), one thread per grid point. The CTA loads
// its trip count, its culled image list and the shell's exponents and
// coefficients into shared memory; each thread keeps its K*M sums in
// registers (the kernel is instantiated per L and K) and stores them to the
// transposed (rows, ng_p) layout, so neighbouring threads write neighbouring
// addresses. Bound: the exp evaluations, sum_{s,b} counts[s,b] * NB * P.
#include <cuda_runtime.h>
#include <math.h>

namespace {

__device__ __forceinline__ double gexp(double x) { return exp(x); }
__device__ __forceinline__ float gexp(float x) { return expf(x); }

// Real solid harmonics S_Lm (l <= 3), the reference's component order.
template <typename T, int L>
__device__ __forceinline__ void solid_harmonics(T dx, T dy, T dz, T* ang) {
  if constexpr (L == 0) {
    ang[0] = T(0.28209479177387814);                  // 0.5/sqrt(pi)
  } else if constexpr (L == 1) {
    const T c = T(0.4886025119029199);                // sqrt(3/(4 pi))
    ang[0] = c * dx;
    ang[1] = c * dy;
    ang[2] = c * dz;
  } else if constexpr (L == 2) {
    const T c0 = T(1.0925484305920792);               // sqrt(15/(4 pi))
    const T c1 = T(0.31539156525252005);              // sqrt(5/(16 pi))
    const T c2 = T(0.5462742152960396);               // sqrt(15/(16 pi))
    ang[0] = c0 * dx * dy;
    ang[1] = c0 * dy * dz;
    ang[2] = c1 * (T(2) * dz * dz - dx * dx - dy * dy);
    ang[3] = c0 * dx * dz;
    ang[4] = c2 * (dx * dx - dy * dy);
  } else {
    const T c_3 = T(0.5900435899266435);              // sqrt(35/(32 pi))
    const T c_2 = T(2.890611442640554);               // sqrt(105/(4 pi))
    const T c_1 = T(0.4570457994644658);              // sqrt(21/(32 pi))
    const T c0 = T(0.3731763325901154);               // sqrt(7/(16 pi))
    const T c2 = T(1.445305721320277);                // sqrt(105/(16 pi))
    const T x2 = dx * dx, y2 = dy * dy, z2 = dz * dz;
    ang[0] = c_3 * dy * (T(3) * x2 - y2);
    ang[1] = c_2 * dx * dy * dz;
    ang[2] = c_1 * dy * (T(4) * z2 - x2 - y2);
    ang[3] = c0 * dz * (T(2) * z2 - T(3) * x2 - T(3) * y2);
    ang[4] = c_1 * dx * (T(4) * z2 - x2 - y2);
    ang[5] = c2 * dz * (x2 - y2);
    ang[6] = c_3 * dx * (x2 - T(3) * y2);
  }
}

template <typename T, int L, int K>
__global__ void ao_collocate_kernel(const int* __restrict__ counts,
                                    const T* __restrict__ centers,
                                    const T* __restrict__ exps,
                                    const T* __restrict__ coeffs,
                                    const T* __restrict__ coordsT,
                                    const T* __restrict__ imgs,
                                    T* __restrict__ out,
                                    int P, int nb, int NB, int imax, int ng_p) {
  constexpr int M = 2 * L + 1;
  extern __shared__ unsigned char smem_raw[];
  T* s_img = reinterpret_cast<T*>(smem_raw);   // (3, imax)
  T* s_exp = s_img + 3 * imax;                 // (P,)
  T* s_coef = s_exp + P;                       // (P, K)

  const int b = blockIdx.x;
  const int s = blockIdx.y;
  const int cnt = counts[s * nb + b];
  const T* img = imgs + (static_cast<size_t>(s) * nb + b) * 3 * imax;
  for (int j = threadIdx.x; j < cnt; j += blockDim.x) {
    s_img[j] = img[j];
    s_img[imax + j] = img[imax + j];
    s_img[2 * imax + j] = img[2 * imax + j];
  }
  for (int p = threadIdx.x; p < P; p += blockDim.x) s_exp[p] = exps[s * P + p];
  for (int i = threadIdx.x; i < P * K; i += blockDim.x)
    s_coef[i] = coeffs[s * P * K + i];
  __syncthreads();

  const T cx = centers[3 * s + 0];
  const T cy = centers[3 * s + 1];
  const T cz = centers[3 * s + 2];
  T* out_s = out + static_cast<size_t>(s) * K * M * ng_p;
  for (int g = b * NB + threadIdx.x; g < (b + 1) * NB; g += blockDim.x) {
    const T x = coordsT[g] - cx;
    const T y = coordsT[ng_p + g] - cy;
    const T z = coordsT[2 * ng_p + g] - cz;
    T acc[K * M];
#pragma unroll
    for (int r = 0; r < K * M; ++r) acc[r] = T(0);
    for (int j = 0; j < cnt; ++j) {
      const T dx = x - s_img[j];
      const T dy = y - s_img[imax + j];
      const T dz = z - s_img[2 * imax + j];
      const T r2 = dx * dx + dy * dy + dz * dz;
      T rad[K];
#pragma unroll
      for (int k = 0; k < K; ++k) rad[k] = T(0);
      for (int p = 0; p < P; ++p) {
        const T e = gexp(-s_exp[p] * r2);
#pragma unroll
        for (int k = 0; k < K; ++k) rad[k] += e * s_coef[p * K + k];
      }
      T ang[M];
      solid_harmonics<T, L>(dx, dy, dz, ang);
#pragma unroll
      for (int k = 0; k < K; ++k) {
#pragma unroll
        for (int m = 0; m < M; ++m) acc[k * M + m] += rad[k] * ang[m];
      }
    }
#pragma unroll
    for (int r = 0; r < K * M; ++r)
      out_s[static_cast<size_t>(r) * ng_p + g] = acc[r];
  }
}

template <typename T, int L, int K>
cudaError_t launch_lk(int P, int ns, int nb, int NB, int imax, int ng_p,
                      const int* counts, const T* centers, const T* exps,
                      const T* coeffs, const T* coordsT, const T* imgs, T* out,
                      cudaStream_t stream) {
  const size_t smem = (3 * static_cast<size_t>(imax) + P + P * K) * sizeof(T);
  auto kernel = ao_collocate_kernel<T, L, K>;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  const int threads = NB < 512 ? NB : 512;
  kernel<<<dim3(nb, ns), threads, smem, stream>>>(
      counts, centers, exps, coeffs, coordsT, imgs, out, P, nb, NB, imax, ng_p);
  return cudaGetLastError();
}

template <typename T, int L>
cudaError_t launch_l(int K, int P, int ns, int nb, int NB, int imax, int ng_p,
                     const int* counts, const T* centers, const T* exps,
                     const T* coeffs, const T* coordsT, const T* imgs, T* out,
                     cudaStream_t stream) {
#define PIT_AO_K(KK)                                                        \
  case KK:                                                                  \
    return launch_lk<T, L, KK>(P, ns, nb, NB, imax, ng_p, counts, centers,  \
                               exps, coeffs, coordsT, imgs, out, stream);
  switch (K) {
    PIT_AO_K(1)
    PIT_AO_K(2)
    PIT_AO_K(3)
    PIT_AO_K(4)
    default:
      return cudaErrorInvalidValue;
  }
#undef PIT_AO_K
}

template <typename T>
int launch(int l, int K, int P, int ns, int nb, int NB, int imax, int ng_p,
           const void* counts, const void* centers, const void* exps,
           const void* coeffs, const void* coordsT, const void* imgs, void* out,
           void* stream) {
  const int* c = static_cast<const int*>(counts);
  const T* ce = static_cast<const T*>(centers);
  const T* ex = static_cast<const T*>(exps);
  const T* co = static_cast<const T*>(coeffs);
  const T* xyz = static_cast<const T*>(coordsT);
  const T* im = static_cast<const T*>(imgs);
  T* o = static_cast<T*>(out);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (l) {
    case 0: err = launch_l<T, 0>(K, P, ns, nb, NB, imax, ng_p, c, ce, ex, co, xyz, im, o, st); break;
    case 1: err = launch_l<T, 1>(K, P, ns, nb, NB, imax, ng_p, c, ce, ex, co, xyz, im, o, st); break;
    case 2: err = launch_l<T, 2>(K, P, ns, nb, NB, imax, ng_p, c, ce, ex, co, xyz, im, o, st); break;
    case 3: err = launch_l<T, 3>(K, P, ns, nb, NB, imax, ng_p, c, ce, ex, co, xyz, im, o, st); break;
    default: err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}

}  // namespace

extern "C" int ao_collocate_f64(int l, int K, int P, int ns, int nb, int NB,
                                int imax, int ng_p, void* counts, void* centers,
                                void* exps, void* coeffs, void* coordsT,
                                void* imgs, void* out, void* stream) {
  return launch<double>(l, K, P, ns, nb, NB, imax, ng_p, counts, centers, exps,
                        coeffs, coordsT, imgs, out, stream);
}

extern "C" int ao_collocate_f32(int l, int K, int P, int ns, int nb, int NB,
                                int imax, int ng_p, void* counts, void* centers,
                                void* exps, void* coeffs, void* coordsT,
                                void* imgs, void* out, void* stream) {
  return launch<float>(l, K, P, ns, nb, NB, imax, ng_p, counts, centers, exps,
                       coeffs, coordsT, imgs, out, stream);
}
