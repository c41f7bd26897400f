"""Build and load the port's CUDA kernels (``csrc/*.cu``).

Each source is compiled by ``nvcc`` for ``sm_90a`` into an object file, all
sources at once in parallel, and the objects are linked into one shared
library with a plain C interface, loaded with ctypes. The library lands in
``pyscf_isdf_tpu_torch/_build/`` under a name that hashes the sources and
flags, so an edited source is rebuilt at its next first use. Nothing is
built or loaded at import time: the first kernel launch calls
:func:`load`.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

_PKG = Path(__file__).resolve().parent.parent
SRC_DIR = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
SOURCES = ("ao_collocate.cu", "robust_k.cu")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P, _I = ctypes.c_void_p, ctypes.c_int
# C entry points: name -> argument types (all return cudaError_t as int)
_SIGNATURES = {
    # l, K, P, ns, nb, NB, imax, ng, counts, nprim, cuts, centers, exps,
    # coeffs, coordsT, dest, imgs, out, stream
    "ao_collocate_f64": (_I,) * 8 + (_P,) * 11,
    "ao_collocate_f32": (_I,) * 8 + (_P,) * 11,
    # ng, nao, nip, nsplit, g_per_split, stages, width, cs, aoR, B, Vxi,
    # partial, out, stream
    "robust_k_cross_f64": (_I,) * 8 + (_P,) * 6,
    # stages, width, cs -> blocks resident at once (negative on error)
    "robust_k_cross_f64_slots": (_I,) * 3,
    # ng, nao, nip, nsplit, tp, aoR, B, Vxi, partial, out, stream
    "robust_k_cross_f32": (_I,) * 5 + (_P,) * 6,
}

_lib = None
build_log = ""          # nvcc's output (register and shared-memory use)


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return path


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in SOURCES:
        h.update((SRC_DIR / name).read_bytes())
    return h.hexdigest()[:16]


def build() -> Path:
    """Compile the sources (in parallel) and link the shared library."""
    global build_log
    out = BUILD_DIR / f"libpit_kernels_{_digest()}.so"
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    procs = []
    for name in SOURCES:
        obj = BUILD_DIR / f"{Path(name).stem}_{os.getpid()}.o"
        cmd = [nvcc, *NVCC_FLAGS, "-c", str(SRC_DIR / name), "-o", str(obj)]
        procs.append((name, obj, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    logs = []
    for name, _, proc in procs:
        text, _ = proc.communicate()
        logs.append(f"== {name}\n{text}")
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {name}:\n{text}")
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    link = subprocess.run(
        [nvcc, "-shared", "-gencode", "arch=compute_90a,code=sm_90a",
         "-o", str(tmp), *[str(obj) for _, obj, _ in procs]],
        capture_output=True, text=True)
    if link.returncode != 0:
        raise RuntimeError(f"nvcc link failed:\n{link.stdout}{link.stderr}")
    os.replace(tmp, out)
    for _, obj, _ in procs:
        obj.unlink()
    build_log = "\n".join(logs)
    return out


def load():
    """The loaded kernel library, built on first use."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = list(argtypes)
            fn.restype = ctypes.c_int
        _lib = lib
    return _lib


def check(rc: int, name: str) -> None:
    """Raise if a C entry point reported a CUDA error."""
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA error {rc}")
