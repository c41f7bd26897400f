// The cost of exp(double) on Hopper, which bounds kernel K1
// (pyscf_isdf_tpu_torch/csrc/ao_collocate.cu). Two parts:
//
//   1. SASS: the FP64 instructions of one exp(double), from cuobjdump of
//      this binary's kernel exp_one (y = exp(x), nothing else). It prints
//      the kernel's SASS and the count of each FP64 opcode, in the whole
//      kernel and on the path that arguments in [-708, 0] take. The
//      compiler places the out-of-range code inline, behind a predicated
//      forward branch that in-range arguments take; that path skips every
//      instruction a predicated forward branch jumps over.
//   2. Rate: exp(double) at full occupancy, each thread running four
//      independent chains of exponentials with arguments in [-40, 0], timed
//      with CUDA events against the same loop with the exp taken out. It
//      prints exponentials per second and the FP64 issue slots one exp
//      takes at 64 FP64 lanes per SM and the card's boost clock.
//
// Build and run on the card, from the root of a checkout:
//
//   nvcc -gencode arch=compute_90a,code=sm_90a -O3 -o k1_exp_probe tools/k1_exp_probe.cu
//   ./k1_exp_probe
//
// cuobjdump must be on PATH (it ships with the CUDA toolkit).
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <map>
#include <string>
#include <cuda_runtime.h>

#define CK(x) do { cudaError_t e = (x); if (e != cudaSuccess) { printf("CUDA error %s at %d\n", cudaGetErrorString(e), __LINE__); exit(1);} } while (0)

extern "C" __global__ void exp_one(const double* __restrict__ x, double* __restrict__ y) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  y[i] = exp(x[i]);
}

template <bool EXP>
__global__ void exp_rate(double* out, int iters) {
  double x0 = -1e-3 * (threadIdx.x & 31), x1 = x0 - 10.0, x2 = x0 - 20.0, x3 = x0 - 30.0;
  double a0 = 0, a1 = 0, a2 = 0, a3 = 0;
  for (int i = 0; i < iters; ++i) {
    if (EXP) {
      a0 += exp(x0); a1 += exp(x1); a2 += exp(x2); a3 += exp(x3);
    } else {
      a0 += x0; a1 += x1; a2 += x2; a3 += x3;
    }
    x0 -= 1e-9; x1 -= 1e-9; x2 -= 1e-9; x3 -= 1e-9;
  }
  out[blockIdx.x * blockDim.x + threadIdx.x] = a0 + a1 + a2 + a3;
}

static bool is_fp64_op(const std::string& op) {
  static const char* ops[] = {"DFMA", "DMUL", "DADD", "DSETP", "DMNMX", "DSET",
                              "F2F.F64", "F2I.F64", "I2F.F64", "F2I.S64.F64",
                              "F2I.U32.F64", "DRND", "MUFU.RCP64H", "MUFU.RSQ64H"};
  for (const char* o : ops)
    if (op.rfind(o, 0) == 0) return true;
  return false;
}

static void sass_counts(const char* self) {
  std::string cmd = std::string("cuobjdump -sass -fun exp_one ") + self + " 2>&1";
  FILE* f = popen(cmd.c_str(), "r");
  if (!f) { printf("cannot run cuobjdump\n"); exit(1); }
  std::map<std::string, int> all, fast;
  unsigned long skip_to = 0;             // end of the code a branch jumps over
  int lines = 0;
  char buf[1024];
  printf("== SASS of exp_one\n");
  while (fgets(buf, sizeof buf, f)) {
    // instruction lines look like: /*0070*/   DFMA R4, R2, ..., R4 ;
    const char* a = strstr(buf, "/*");
    const char* p = strstr(buf, "*/");
    if (!a || !p || !strstr(buf, ";")) continue;
    const unsigned long addr = strtoul(a + 2, nullptr, 16);
    ++lines;
    fputs(buf, stdout);
    p += 2;
    while (*p == ' ' || *p == '\t') ++p;
    const bool predicated = *p == '@';   // @P0 / @!P0
    if (predicated) {
      while (*p && *p != ' ') ++p;
      while (*p == ' ') ++p;
    }
    std::string op;
    while (*p && *p != ' ' && *p != ';') op += *p++;
    std::string base = op.substr(0, op.find('.'));
    const bool on_path = addr >= skip_to;
    if (is_fp64_op(op) || is_fp64_op(base)) {
      all[base]++;
      if (on_path) fast[base]++;
    }
    if (on_path && predicated && base == "BRA") {
      const unsigned long target = strtoul(p, nullptr, 16);
      if (target > addr) skip_to = target;
    }
  }
  pclose(f);
  if (!lines) { printf("no SASS found for exp_one\n"); exit(1); }
  int n_all = 0, n_fast = 0, a_fast = 0;
  printf("== FP64 opcodes of exp_one (whole kernel / in-range path)\n");
  for (auto& kv : all) {
    const int nf = fast.count(kv.first) ? fast[kv.first] : 0;
    printf("%-12s %3d / %3d\n", kv.first.c_str(), kv.second, nf);
    n_all += kv.second;
    n_fast += nf;
    if (kv.first == "DFMA" || kv.first == "DMUL" || kv.first == "DADD") a_fast += nf;
  }
  printf("FP64 instructions: %d in the kernel, %d on the in-range path, "
         "of which DFMA+DMUL+DADD %d\n", n_all, n_fast, a_fast);
}

int main(int argc, char** argv) {
  sass_counts(argv[0]);

  cudaDeviceProp prop;
  CK(cudaGetDeviceProperties(&prop, 0));
  int clock_khz = 0;
  CK(cudaDeviceGetAttribute(&clock_khz, cudaDevAttrClockRate, 0));
  const int threads = 256, blocks = prop.multiProcessorCount * 8, iters = 1 << 14;
  double* out;
  CK(cudaMalloc(&out, sizeof(double) * threads * blocks));
  cudaEvent_t e0, e1;
  CK(cudaEventCreate(&e0));
  CK(cudaEventCreate(&e1));
  float ms[2];
  for (int v = 0; v < 2; ++v) {
    for (int rep = 0; rep < 2; ++rep) {    // first launch warms up
      CK(cudaEventRecord(e0));
      if (v == 0) exp_rate<true><<<blocks, threads>>>(out, iters);
      else exp_rate<false><<<blocks, threads>>>(out, iters);
      CK(cudaEventRecord(e1));
      CK(cudaEventSynchronize(e1));
      CK(cudaGetLastError());
      CK(cudaEventElapsedTime(&ms[v], e0, e1));
    }
  }
  const double n_exp = 4.0 * iters * threads * blocks;
  const double sec = (ms[0] - ms[1]) * 1e-3;
  const double slots = sec * prop.multiProcessorCount * 64.0 * clock_khz * 1e3 / n_exp;
  printf("%s, %d SMs, clock %.0f MHz: %.3e exp in %.3f ms (loop without exp %.3f ms): "
         "%.3e exp/s, %.1f FP64 issue slots per exp\n",
         prop.name, prop.multiProcessorCount, clock_khz / 1e3, n_exp, ms[0], ms[1],
         n_exp / sec, slots);
  CK(cudaFree(out));
  return 0;
}
