// Image-culled crystalline AO collocation (Gamma point, real): kernel K1.
//
// Replaces the TPU Pallas kernel _make_kernel of
// pyscf_isdf_tpu/ops/pallas_ao.py. For shell s of angular momentum L with
// K contractions and P primitives, and slot i of grid block b (NB slots):
//
//   out[(s*K + k)*M + m, dest[b*NB + i]] =
//       sum_{j < counts[s,b]} sum_{p < nprim[s,b,j], -exps[s,p] r^2 >= cuts[s]}
//           coeffs[s,p,k] exp(-exps[s,p] r^2) S_Lm(d)
//   d = (coordsT[:, b*NB + i] - centers[s]) - imgs[s, b, :, j],  M = 2L+1
//
// for each slot with 0 <= dest < ng; every grid point is one block's slot.
//
// What bounds it on the H100: FP64 instructions. There is no tensor-core
// work, and exp(double) is a software sequence of 15 FP64 instructions
// (14 DFMA and a DADD on its in-range path; tools/k1_exp_probe.cu counts
// them from SASS) on 64 FP64 lanes per SM, so the time follows the number
// of exponentials evaluated.
// The host planner (ops/cuda_ao.py) keeps that number near what the inputs
// need: on the uniform grid the blocks are compact 8x8x8 bricks, so each
// (shell, brick) lists few images, and each listed image carries only the
// prefix of the shell's primitives (sorted most diffuse first) whose bound
// over the brick reaches 1e-16; an image with none left is not listed.
// Inside that prefix each thread stops at its point's first primitive with
// -a r^2 below the shell's cut (its term and every later one is below
// 1e-16 there): divergent, but it saves the exponentials of the far side of
// a brick, and measured faster (tools/k1_variants.py).
//
// One CTA of 128 threads per (block, shell), four slots a thread (fewer
// threads a CTA measured faster, tools/k1_variants.py). The CTA loads its
// trip count, image list and per-image primitive counts into shared memory
// with the shell's exponents and coefficients. Every thread of the CTA
// walks the same list with the same primitive counts, so a primitive or
// image the planner drops costs no divergence; only the per-point cut
// diverges. Each thread keeps its K*M sums in registers (the kernel is
// instantiated per L and K) and stores them at its point's flat grid index
// in the transposed (rows, ng) layout; in a full brick a warp holds four
// rows of eight neighbouring points, so its stores are 64-byte runs.
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 128;

__device__ __forceinline__ double gexp(double x) { return exp(x); }
__device__ __forceinline__ float gexp(float x) { return expf(x); }

// Real solid harmonics S_Lm (l <= 4), the reference's component order.
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
  } else if constexpr (L == 3) {
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
  } else {
    const T c_4 = T(2.5033429417967046);              // 3/4 sqrt(35/pi)
    const T c_3 = T(1.7701307697799304);              // 3/4 sqrt(35/(2 pi))
    const T c_2 = T(0.9461746957575601);              // 3/4 sqrt(5/pi)
    const T c_1 = T(0.6690465435572892);              // 3/4 sqrt(5/(2 pi))
    const T c0 = T(0.10578554691520431);              // 3/(16 sqrt(pi))
    const T c2 = T(0.47308734787878004);              // 3/8 sqrt(5/pi)
    const T c4 = T(0.6258357354491761);               // 3/16 sqrt(35/pi)
    const T x2 = dx * dx, y2 = dy * dy, z2 = dz * dz;
    const T r2 = x2 + y2 + z2;
    const T xy = dx * dy, yz = dy * dz, xz = dx * dz;
    const T a = x2 - y2;
    const T b = T(7) * z2 - r2;
    const T c = T(7) * z2 - T(3) * r2;
    const T p = T(3) * x2 - y2;
    const T q = x2 - T(3) * y2;
    ang[0] = c_4 * xy * a;
    ang[1] = c_3 * yz * p;
    ang[2] = c_2 * xy * b;
    ang[3] = c_1 * yz * c;
    ang[4] = c0 * (T(35) * z2 * z2 - T(30) * z2 * r2 + T(3) * r2 * r2);
    ang[5] = c_1 * xz * c;
    ang[6] = c2 * a * b;
    ang[7] = c_3 * xz * q;
    ang[8] = c4 * (x2 * q - y2 * p);
  }
}

template <typename T, int L, int K>
__global__ void __launch_bounds__(kThreads)
ao_collocate_kernel(const int* __restrict__ counts,
                    const int* __restrict__ nprim,
                    const T* __restrict__ cuts,
                    const T* __restrict__ centers,
                    const T* __restrict__ exps,
                    const T* __restrict__ coeffs,
                    const T* __restrict__ coordsT,
                    const int* __restrict__ dest,
                    const T* __restrict__ imgs,
                    T* __restrict__ out,
                    int P, int nb, int NB, int imax, int ng) {
  constexpr int M = 2 * L + 1;
  extern __shared__ unsigned char smem_raw[];
  T* s_img = reinterpret_cast<T*>(smem_raw);             // (3, imax)
  T* s_nexp = s_img + 3 * imax;                          // (P,) -exponents
  T* s_coef = s_nexp + P;                                // (P, K)
  int* s_np = reinterpret_cast<int*>(s_coef + P * K);    // (imax,)

  const int b = blockIdx.x;
  const int s = blockIdx.y;
  const size_t sb = static_cast<size_t>(s) * nb + b;
  const int cnt = min(counts[sb], imax);
  const T* img = imgs + sb * 3 * imax;
  const int* np_sb = nprim + sb * imax;
  for (int j = threadIdx.x; j < cnt; j += blockDim.x) {
    s_img[j] = img[j];
    s_img[imax + j] = img[imax + j];
    s_img[2 * imax + j] = img[2 * imax + j];
    s_np[j] = min(np_sb[j], P);
  }
  for (int p = threadIdx.x; p < P; p += blockDim.x) s_nexp[p] = -exps[s * P + p];
  for (int i = threadIdx.x; i < P * K; i += blockDim.x)
    s_coef[i] = coeffs[s * P * K + i];
  __syncthreads();

  const T cut = cuts[s];
  const T cx = centers[3 * s + 0];
  const T cy = centers[3 * s + 1];
  const T cz = centers[3 * s + 2];
  const size_t ntot = static_cast<size_t>(nb) * NB;
  T* out_s = out + static_cast<size_t>(s) * K * M * ng;
  for (int i = threadIdx.x; i < NB; i += blockDim.x) {
    const size_t g = static_cast<size_t>(b) * NB + i;
    const int dst = dest[g];
    if (dst < 0 || dst >= ng) continue;
    const T x = coordsT[g] - cx;
    const T y = coordsT[ntot + g] - cy;
    const T z = coordsT[2 * ntot + g] - cz;
    T acc[K * M];
#pragma unroll
    for (int r = 0; r < K * M; ++r) acc[r] = T(0);
    for (int j = 0; j < cnt; ++j) {
      const T dx = x - s_img[j];
      const T dy = y - s_img[imax + j];
      const T dz = z - s_img[2 * imax + j];
      const T r2 = dx * dx + dy * dy + dz * dz;
      const int npj = s_np[j];
      T rad[K];
#pragma unroll
      for (int k = 0; k < K; ++k) rad[k] = T(0);
      for (int p = 0; p < npj; ++p) {
        const T arg = s_nexp[p] * r2;
        if (arg < cut) break;
        const T e = gexp(arg);
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
      out_s[static_cast<size_t>(r) * ng + dst] = acc[r];
  }
}

template <typename T, int L, int K>
cudaError_t launch_lk(int P, int ns, int nb, int NB, int imax, int ng,
                      const int* counts, const int* nprim, const T* cuts,
                      const T* centers, const T* exps, const T* coeffs,
                      const T* coordsT,
                      const int* dest, const T* imgs, T* out,
                      cudaStream_t stream) {
  const size_t smem = (3 * static_cast<size_t>(imax) + P + P * K) * sizeof(T)
                      + static_cast<size_t>(imax) * sizeof(int);
  auto kernel = ao_collocate_kernel<T, L, K>;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  const int threads = NB < kThreads ? NB : kThreads;
  kernel<<<dim3(nb, ns), threads, smem, stream>>>(
      counts, nprim, cuts, centers, exps, coeffs, coordsT, dest, imgs, out, P,
      nb, NB, imax, ng);
  return cudaGetLastError();
}

template <typename T, int L>
cudaError_t launch_l(int K, int P, int ns, int nb, int NB, int imax, int ng,
                     const int* counts, const int* nprim, const T* cuts,
                     const T* centers, const T* exps, const T* coeffs,
                     const T* coordsT,
                     const int* dest, const T* imgs, T* out,
                     cudaStream_t stream) {
#define PIT_AO_K(KK)                                                          \
  case KK:                                                                    \
    return launch_lk<T, L, KK>(P, ns, nb, NB, imax, ng, counts, nprim, cuts,  \
                               centers, exps, coeffs, coordsT, dest, imgs,    \
                               out, stream);
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
int launch(int l, int K, int P, int ns, int nb, int NB, int imax, int ng,
           const void* counts, const void* nprim, const void* cuts,
           const void* centers,
           const void* exps, const void* coeffs, const void* coordsT,
           const void* dest, const void* imgs, void* out, void* stream) {
  const int* c = static_cast<const int*>(counts);
  const int* np = static_cast<const int*>(nprim);
  const T* cu = static_cast<const T*>(cuts);
  const T* ce = static_cast<const T*>(centers);
  const T* ex = static_cast<const T*>(exps);
  const T* co = static_cast<const T*>(coeffs);
  const T* xyz = static_cast<const T*>(coordsT);
  const int* d = static_cast<const int*>(dest);
  const T* im = static_cast<const T*>(imgs);
  T* o = static_cast<T*>(out);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (ns <= 0 || nb <= 0 || NB <= 0 || imax <= 0 || P <= 0 || ng < 0 ||
      ns > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err;
  switch (l) {
    case 0: err = launch_l<T, 0>(K, P, ns, nb, NB, imax, ng, c, np, cu, ce, ex, co, xyz, d, im, o, st); break;
    case 1: err = launch_l<T, 1>(K, P, ns, nb, NB, imax, ng, c, np, cu, ce, ex, co, xyz, d, im, o, st); break;
    case 2: err = launch_l<T, 2>(K, P, ns, nb, NB, imax, ng, c, np, cu, ce, ex, co, xyz, d, im, o, st); break;
    case 3: err = launch_l<T, 3>(K, P, ns, nb, NB, imax, ng, c, np, cu, ce, ex, co, xyz, d, im, o, st); break;
    case 4: err = launch_l<T, 4>(K, P, ns, nb, NB, imax, ng, c, np, cu, ce, ex, co, xyz, d, im, o, st); break;
    default: err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}

}  // namespace

extern "C" int ao_collocate_f64(int l, int K, int P, int ns, int nb, int NB,
                                int imax, int ng, void* counts, void* nprim,
                                void* cuts, void* centers, void* exps,
                                void* coeffs,
                                void* coordsT, void* dest, void* imgs,
                                void* out, void* stream) {
  return launch<double>(l, K, P, ns, nb, NB, imax, ng, counts, nprim, cuts, centers,
                        exps, coeffs, coordsT, dest, imgs, out, stream);
}

extern "C" int ao_collocate_f32(int l, int K, int P, int ns, int nb, int NB,
                                int imax, int ng, void* counts, void* nprim,
                                void* cuts, void* centers, void* exps,
                                void* coeffs,
                                void* coordsT, void* dest, void* imgs,
                                void* out, void* stream) {
  return launch<float>(l, K, P, ns, nb, NB, imax, ng, counts, nprim, cuts, centers,
                       exps, coeffs, coordsT, dest, imgs, out, stream);
}
