// Cross term of the robust-fit ISDF exchange (kernel K2).
//
// Replaces the TPU Pallas kernel _kernel of
// pyscf_isdf_tpu/ops/pallas_robust_k.py (launched by robust_k_cross):
//
//   C[P, nu] = sum_g Vxi[P, g] * t[g, P] * aoR[g, nu],
//   t[g, P]  = sum_mu aoR[g, mu] * B[P, mu]
//
// aoR (ng, nao), B (nip, nao), Vxi (nip, ng), all row-major.
//
// What bounds it: 4 ng nip nao operations (3.3e11 at ng 110592, nao 216,
// nip 3456) against 3.3 GB of inputs, so on an H100 it is bound by the
// FP64 tensor cores (67 TFLOP/s dense), not by memory (1 ms). The unfused
// formulation writes t and z = t * Vxi^T to device memory; here they stay
// in registers and shared memory, as on the TPU.
//
// float64: both products on the FP64 tensor cores (DMMA). Hopper has no
// f64 wgmma, so the instruction is mma.sync.aligned.m16n8k8.row.col.f64;
// on the H100 it and the m16n8k4/k16 shapes issue at the full 66 TFLOP/s
// while m8n8k4 reaches half of that (tools/k2_dmma_probe.cu). ldmatrix has
// no 64-bit form, so fragments come from plain 8-byte shared loads
// (lane = 4 gid + tig).
//
//   Grid (P tiles of TP = 64 rows x cs ranks, fastest) x (g slices). A
//   block loads its B tile once, then walks its g slice in chunks of
//   TG = 16 grid points through a ring of S stages, each stage an aoR
//   chunk (TG x width) and a Vxi tile (TP x TG) filled with cp.async (16 B
//   a thread where nao, ng and the pointers allow, else 8 B; rows past the
//   slice are zero-filled). Chunks k+1 .. k+S-1 are in flight while chunk
//   k runs, with three barriers a chunk:
//     1. t^T (TP x TG) = B_tile . aoR_chunk^T: warp w takes the 16 x 16
//        tile w % 4 (two 16 x 8 mma chains) over the even (w < 4) or odd
//        (w >= 4) mma steps of mu; warps 4-7 leave their partials in z's
//        buffer and warps 0-3 add them;
//     2. z = t^T * Vxi tile, in shared memory (TP x TG);
//     3. C_tile (TP x width) += z . aoR_chunk, C in registers for the whole
//        slice: warps 2 along P x 4 along nu, each 32 rows x up to 64
//        columns (16 mma in flight a step).
//   P is fastest in blockIdx, so the P tiles of one g slice run together
//   and each aoR chunk comes from L2 after its first read; Vxi is read once.
//
//   nao beyond 256 (or beyond what fits shared memory): a cluster of cs
//   blocks splits mu = nu into cs ranges of width <= 256 columns. Each rank
//   holds its columns of B and of the aoR chunks, publishes its partial
//   t^T of each chunk in shared memory, and after a cluster barrier every
//   rank adds all ranks' partials in rank order through distributed shared
//   memory (the same z, bit for bit, in every rank) and updates its own
//   columns of C. Nothing is recomputed and C never leaves registers; the
//   cost is one cluster barrier a chunk.
//
//   Shared-memory strides (doubles): ldk = width + 4 for B and aoR, and
//   TG + 4 = 20 for z, are 4 mod 8. A fragment load then puts the 16 lanes
//   of each half-warp on 16 distinct 8-byte banks, both for the row-major
//   reads (address 4 gid + tig) and for the transposed reads of aoR in the
//   second product (address tig ldk + gid). The Vxi tile keeps stride TG
//   (16-byte reads, two-way conflicts on 4 loads a chunk) because padding
//   it would not fit three stages at nao = 216.
//
//   Shared memory per block, 8 (64 ldk + S 16 ldk + S 64 16 + 64 20
//   [+ 2 64 16 in a cluster]) bytes of the 232,448 a block may use; the
//   planner (ops/cuda_robust_k.block_f64) takes the smallest cluster that
//   fits, with three stages where they fit, else two:
//     nao 216 (main path): one block, ldk 220, S 3:
//       112,640 (B) + 3 x 28,160 (aoR) + 3 x 8,192 (Vxi) + 10,240 (z)
//       = 231,936 B, one block of 8 warps per SM;
//     nao 702 (gth-dzvp): cs 3, width 240, ldk 244, S 2:
//       124,928 + 2 x 31,232 + 2 x 8,192 + 10,240 + 16,384 = 230,400 B.
//
// Each g slice writes a partial C to a (nsplit, nip, nao) buffer and a
// second pass sums the partials in a fixed order: no atomics, and two runs
// on the same inputs give the same bits.
//
// float32 stays on the SIMT kernel below: a TF32 mma keeps about three
// decimal digits, short of the 1e-4 relative bar of the float32 path.
#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

#include <cooperative_groups.h>

namespace cg = cooperative_groups;

namespace {

// ---------------------------------------------------------------- float32
// SIMT FMA tiling: B tile and TG rows of aoR in shared memory, C in
// registers (8 nu columns x TP/8 P rows a thread).

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
cudaError_t sum_splits(int nsplit, int nip, int nao, const T* partial, T* out,
                       cudaStream_t stream) {
  const size_t n = static_cast<size_t>(nip) * nao;
  const int blocks = static_cast<int>((n + 255) / 256 < 4096 ? (n + 255) / 256 : 4096);
  sum_splits_kernel<T><<<blocks, 256, 0, stream>>>(nsplit, n, partial, out);
  return cudaGetLastError();
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

// ---------------------------------------------------------------- float64
// DMMA kernel (see the note at the top of the file).

constexpr int kWarps = 8;
constexpr int kDmmaThreads = 32 * kWarps;
constexpr int kSmemLimit = 232448;         // dynamic shared memory a block may use
constexpr int kTP = 64;                    // P rows of a block
constexpr int kTG64 = 16;                  // grid points a chunk
constexpr int kLDZ = kTG64 + 4;            // z stride, 4 mod 8
constexpr int kMaxWidth = 256;             // mu = nu columns of one block
constexpr int kMaxCluster = 8;

// Shared memory of one block, in doubles: B tile, S aoR chunks and Vxi
// tiles, z (which first takes the partials of warps 4-7), and with a
// cluster the two buffers that publish the block's partial t^T.
__host__ __device__ inline int dmma_smem_doubles(int S, int ldk, int cs) {
  return kTP * ldk + S * kTG64 * ldk + S * kTP * kTG64 + kTP * kLDZ +
         (cs > 1 ? 2 * kTP * kTG64 : 0);
}

__device__ __forceinline__ void dmma_16x8x8(double (&c)[4], const double (&a)[4],
                                            const double (&b)[2]) {
  asm(
      "mma.sync.aligned.m16n8k8.row.col.f64.f64.f64.f64 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+d"(c[0]), "+d"(c[1]), "+d"(c[2]), "+d"(c[3])
      : "d"(a[0]), "d"(a[1]), "d"(a[2]), "d"(a[3]), "d"(b[0]), "d"(b[1]));
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// cp.async of 16 or 8 bytes; with valid false nothing is read and the
// destination is zero-filled.
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(smem_u32(dst)), "l"(src), "r"(valid ? 16 : 0));
}
__device__ __forceinline__ void cp_async8(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n"
               :: "r"(smem_u32(dst)), "l"(src), "r"(valid ? 8 : 0));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// Block (P tile, rank) of a cluster of cs blocks, g slice blockIdx.y. The
// rank owns mu = nu columns [rank * width, rank * width + width) of kp.
template <int S, bool CLUSTER>
__global__ void __launch_bounds__(kDmmaThreads, 1)
robust_k_cross_dmma(int ng, int nao, int nip, int g_per_split, int width, int cs,
                    int vec_a, int vec_v, const double* __restrict__ aoR,
                    const double* __restrict__ B, const double* __restrict__ Vxi,
                    double* __restrict__ partial) {
  static_assert(S >= 2, "the ring needs two stages");
  constexpr int TP = kTP, TG = kTG64, LDZ = kLDZ;
  const int kp = (nao + 7) & ~7;           // mu padded to the mma depth
  const int ldk = width + 4;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  double* sB = reinterpret_cast<double*>(smem_raw);   // (TP, ldk)
  double* sA = sB + TP * ldk;                         // S x (TG, ldk)
  double* sV = sA + S * TG * ldk;                     // S x (TP, TG)
  double* sZ = sV + S * TP * TG;                      // (TP, LDZ)
  double* sPub = sZ + TP * LDZ;                       // 2 x (TP, TG), cs > 1

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int gid = lane >> 2, tig = lane & 3;
  const int rank = blockIdx.x % cs;
  const int p0 = blockIdx.x / cs * TP;
  const int col0 = rank * width;
  const int wr = max(0, min(width, kp - col0));       // this rank's columns, 8 | wr
  const int nr = max(0, min(wr, nao - col0));         // of them inside nao
  const int g_begin = blockIdx.y * g_per_split;
  const int g_end = min(ng, g_begin + g_per_split);
  const int nchunks = g_end > g_begin ? (g_end - g_begin + TG - 1) / TG : 0;

  // loaders: the rank's columns of TG rows of aoR, 16 threads a row; the
  // whole Vxi tile, 8 pairs a row
  constexpr int TPR = kDmmaThreads / TG;
  auto load_chunk = [&](int chunk, int stage) {
    const int g0 = g_begin + chunk * TG;
    const int r = tid / TPR;
    const bool row_ok = g0 + r < g_end;
    const double* src = aoR + (row_ok ? static_cast<size_t>(g0 + r) * nao + col0 : 0);
    double* dA = sA + (stage * TG + r) * ldk;
    if (vec_a) {
      for (int c = 2 * (tid % TPR); c < nr; c += 2 * TPR)
        cp_async16(dA + c, src + (row_ok ? c : 0), row_ok);
    } else {
      for (int c = tid % TPR; c < nr; c += TPR)
        cp_async8(dA + c, src + (row_ok ? c : 0), row_ok);
    }
    double* dV = sV + stage * TP * TG;
    if (vec_v) {                           // ng even: a pair never straddles g_end
      for (int i = tid; i < TP * TG / 2; i += kDmmaThreads) {
        const int rv = i / (TG / 2), c = 2 * (i % (TG / 2));
        const bool ok = p0 + rv < nip && g0 + c < g_end;
        cp_async16(dV + rv * TG + c, ok ? Vxi + static_cast<size_t>(p0 + rv) * ng + g0 + c : Vxi, ok);
      }
    } else {
      for (int i = tid; i < TP * TG; i += kDmmaThreads) {
        const int rv = i / TG, c = i % TG;
        const bool ok = p0 + rv < nip && g0 + c < g_end;
        cp_async8(dV + rv * TG + c, ok ? Vxi + static_cast<size_t>(p0 + rv) * ng + g0 + c : Vxi, ok);
      }
    }
  };

#pragma unroll
  for (int s = 0; s < S - 1; ++s) {
    if (s < nchunks) load_chunk(s, s);
    cp_async_commit();
  }
  // B tile, zero past nip and nao; aoR columns past nao stay zero in
  // every stage (cp.async never writes them)
  for (int i = tid; i < TP * ldk; i += kDmmaThreads) {
    const int r = i / ldk, c = i - r * ldk;
    sB[i] = (p0 + r < nip && c < nr) ? B[static_cast<size_t>(p0 + r) * nao + col0 + c] : 0.0;
  }
  const int padw = ldk - nr;
  for (int i = tid; i < S * TG * padw; i += kDmmaThreads) {
    const int r = i / padw;
    sA[r * ldk + nr + (i - r * padw)] = 0.0;
  }

  // first product: warp -> 16 x 16 tile (warp % 4) of t^T, even or odd
  // mma steps of the rank's mu (warp / 4)
  const int mi = warp & 3, ks = warp >> 2;
  // second product: warp -> P rows 32 (warp & 1) .. + 32, ntw 8-column
  // tiles of the rank's nu from j0
  const int wm = warp & 1, wn = warp >> 1;
  const int nt = wr >> 3;
  const int ntw = (nt + 3) / 4;
  const int j0 = wn * ntw;
  const int cnt = max(0, min(ntw, nt - j0));

  double acc[2][8][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.0;

  for (int k = 0; k < nchunks; ++k) {
    // chunk k has landed; every warp is done with chunk k - 1, whose stage
    // takes chunk k + S - 1
    cp_async_wait<S - 2>();
    __syncthreads();
    const int nxt = k + S - 1;
    if (nxt < nchunks) load_chunk(nxt, nxt % S);
    cp_async_commit();
    const int st = k % S;
    const double* A = sA + st * TG * ldk;
    const double* V = sV + st * TP * TG;

    // 1. t^T[P, g] = sum_mu B[P, mu] aoR[g, mu] over the rank's mu: the
    //    warp's two 16 x 8 tiles (g 0-7 and 8-15) are two mma chains
    double t[2][4] = {{0.0, 0.0, 0.0, 0.0}, {0.0, 0.0, 0.0, 0.0}};
    {
      const double* ar = sB + (mi * 16 + gid) * ldk + tig;
      const double* br = A + gid * ldk + tig;
      for (int kk = ks * 8; kk < wr; kk += 16) {
        const double a[4] = {ar[kk], ar[8 * ldk + kk], ar[kk + 4], ar[8 * ldk + kk + 4]};
        const double b0[2] = {br[kk], br[kk + 4]};
        const double b1[2] = {br[8 * ldk + kk], br[8 * ldk + kk + 4]};
        dmma_16x8x8(t[0], a, b0);
        dmma_16x8x8(t[1], a, b1);
      }
    }

    // 2. z = t^T * Vxi tile into sZ. Warps 4-7 leave their partials in sZ
    //    and warps 0-3 add them to their own (each element is read, then
    //    written, by one thread). In a cluster the ranks publish their
    //    sums and every rank adds all of them in rank order.
    const int pr = mi * 16 + gid;
    if (ks == 1) {
#pragma unroll
      for (int n = 0; n < 2; ++n)
#pragma unroll
        for (int h = 0; h < 2; ++h)
          *reinterpret_cast<double2*>(sZ + (pr + 8 * h) * LDZ + 8 * n + 2 * tig) =
              make_double2(t[n][2 * h], t[n][2 * h + 1]);
    }
    __syncthreads();
    double* pub = sPub + (k & 1) * TP * TG;
    if (ks == 0) {
#pragma unroll
      for (int n = 0; n < 2; ++n) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int row = pr + 8 * h, col = 8 * n + 2 * tig;
          const double2 r = *reinterpret_cast<const double2*>(sZ + row * LDZ + col);
          const double2 s = make_double2(t[n][2 * h] + r.x, t[n][2 * h + 1] + r.y);
          if constexpr (!CLUSTER) {
            const double2 v = *reinterpret_cast<const double2*>(V + row * TG + col);
            *reinterpret_cast<double2*>(sZ + row * LDZ + col) = make_double2(s.x * v.x, s.y * v.y);
          } else {
            *reinterpret_cast<double2*>(pub + row * TG + col) = s;
          }
        }
      }
    }
    if constexpr (CLUSTER) {
      // the publish buffers alternate, so a rank that runs ahead to chunk
      // k + 1 never overwrites what another rank still reads for chunk k
      cg::this_cluster().sync();
      for (int i = tid; i < TP * TG / 2; i += kDmmaThreads) {
        double2 s = make_double2(0.0, 0.0);
        for (int q = 0; q < cs; ++q) {
          const double2 r = *reinterpret_cast<const double2*>(
              cg::this_cluster().map_shared_rank(pub, q) + 2 * i);
          s.x += r.x;
          s.y += r.y;
        }
        const double2 v = *reinterpret_cast<const double2*>(V + 2 * i);
        const int row = 2 * i / TG, col = 2 * i % TG;
        *reinterpret_cast<double2*>(sZ + row * LDZ + col) = make_double2(s.x * v.x, s.y * v.y);
      }
    }
    __syncthreads();

    // 3. C[P, nu] += sum_g z[P, g] aoR[g, nu] over the rank's nu
#pragma unroll
    for (int kk = 0; kk < TG; kk += 8) {
      double a[2][4];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const double* zr = sZ + ((wm * 2 + i) * 16 + gid) * LDZ + kk + tig;
        a[i][0] = zr[0];
        a[i][1] = zr[8 * LDZ];
        a[i][2] = zr[4];
        a[i][3] = zr[8 * LDZ + 4];
      }
      const double* br = A + (kk + tig) * ldk + j0 * 8 + gid;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        if (j < cnt) {
          const double b[2] = {br[j * 8], br[4 * ldk + j * 8]};
          dmma_16x8x8(acc[0][j], a[0], b);
          dmma_16x8x8(acc[1][j], a[1], b);
        }
      }
    }
  }
  if constexpr (CLUSTER) cg::this_cluster().sync();  // no rank exits while its buffers are read

  double* out = partial + static_cast<size_t>(blockIdx.y) * nip * nao;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      if (j >= cnt) continue;
      const int col = col0 + (j0 + j) * 8 + 2 * tig;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int p = p0 + (wm * 2 + i) * 16 + gid + 8 * (e >> 1);
        const int c = col + (e & 1);
        if (p < nip && c < nao) out[static_cast<size_t>(p) * nao + c] = acc[i][j][e];
      }
    }
  }
}

template <int S, bool CLUSTER>
cudaError_t launch_dmma(int ng, int nao, int nip, int nsplit, int g_per_split,
                        int width, int cs, const double* aoR, const double* B,
                        const double* Vxi, double* partial, cudaStream_t stream) {
  const int kp = (nao + 7) & ~7;
  const size_t smem = dmma_smem_doubles(S, width + 4, cs) * sizeof(double);
  if (smem > static_cast<size_t>(kSmemLimit) || width <= 0 || width % 8 != 0 ||
      width > kMaxWidth || cs < 1 || cs > kMaxCluster || cs * width < kp ||
      (cs - 1) * width >= kp || g_per_split <= 0 || g_per_split % kTG64 != 0)
    return cudaErrorInvalidValue;
  auto kernel = robust_k_cross_dmma<S, CLUSTER>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const int vec_a = nao % 2 == 0 && reinterpret_cast<uintptr_t>(aoR) % 16 == 0;
  const int vec_v = ng % 2 == 0 && reinterpret_cast<uintptr_t>(Vxi) % 16 == 0;
  cudaLaunchConfig_t config = {};
  config.gridDim = dim3((nip + kTP - 1) / kTP * cs, nsplit, 1);
  config.blockDim = dim3(kDmmaThreads, 1, 1);
  config.dynamicSmemBytes = smem;
  config.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cs;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  config.attrs = attr;
  config.numAttrs = cs > 1 ? 1 : 0;
  err = cudaLaunchKernelEx(&config, kernel, ng, nao, nip, g_per_split, width, cs,
                           vec_a, vec_v, aoR, B, Vxi, partial);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

}  // namespace

// Blocks of the float64 kernel that the card runs at once for a given
// stage count, width and cluster size (clusters are placed within one GPC,
// so not every SM may take one); negative on a CUDA error.
extern "C" int robust_k_cross_f64_slots(int stages, int width, int cs) {
  auto kernel = stages == 3 ? (cs > 1 ? robust_k_cross_dmma<3, true> : robust_k_cross_dmma<3, false>)
                            : (cs > 1 ? robust_k_cross_dmma<2, true> : robust_k_cross_dmma<2, false>);
  const size_t smem = dmma_smem_doubles(stages, width + 4, cs) * sizeof(double);
  if (cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           static_cast<int>(smem)) != cudaSuccess)
    return -1;
  cudaLaunchConfig_t config = {};
  config.gridDim = dim3(cs, 1, 1);
  config.blockDim = dim3(kDmmaThreads, 1, 1);
  config.dynamicSmemBytes = smem;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cs;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  config.attrs = attr;
  config.numAttrs = 1;
  int clusters = 0;
  if (cudaOccupancyMaxActiveClusters(&clusters, kernel, &config) != cudaSuccess) return -1;
  return clusters * cs;
}

extern "C" int robust_k_cross_f64(int ng, int nao, int nip, int nsplit,
                                  int g_per_split, int stages, int width, int cs,
                                  void* aoR, void* B, void* Vxi, void* partial,
                                  void* out, void* stream) {
  const double* a = static_cast<const double*>(aoR);
  const double* b = static_cast<const double*>(B);
  const double* v = static_cast<const double*>(Vxi);
  double* part = static_cast<double*>(partial);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (stages == 3 && cs == 1) {
    err = launch_dmma<3, false>(ng, nao, nip, nsplit, g_per_split, width, cs, a, b, v, part, st);
  } else if (stages == 2 && cs == 1) {
    err = launch_dmma<2, false>(ng, nao, nip, nsplit, g_per_split, width, cs, a, b, v, part, st);
  } else if (stages == 3) {
    err = launch_dmma<3, true>(ng, nao, nip, nsplit, g_per_split, width, cs, a, b, v, part, st);
  } else if (stages == 2) {
    err = launch_dmma<2, true>(ng, nao, nip, nsplit, g_per_split, width, cs, a, b, v, part, st);
  } else {
    err = cudaErrorInvalidValue;
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(sum_splits<double>(nsplit, nip, nao, part, static_cast<double*>(out), st));
}

extern "C" int robust_k_cross_f32(int ng, int nao, int nip, int nsplit, int tp,
                                  void* aoR, void* B, void* Vxi, void* partial,
                                  void* out, void* stream) {
  const float* a = static_cast<const float*>(aoR);
  const float* b = static_cast<const float*>(B);
  const float* v = static_cast<const float*>(Vxi);
  float* part = static_cast<float*>(partial);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (tp == 32) {
    err = launch_tp<float, 32>(ng, nao, nip, nsplit, a, b, v, part, st);
  } else if (tp == 16) {
    err = launch_tp<float, 16>(ng, nao, nip, nsplit, a, b, v, part, st);
  } else {
    err = cudaErrorInvalidValue;
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(sum_splits<float>(nsplit, nip, nao, part, static_cast<float*>(out), st));
}
