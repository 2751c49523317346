"""Build and load the CUDA kernels of ``csrc/``.

Each ``csrc/<name>.cu`` has a plain C interface and is compiled by
``nvcc`` into its own shared library, loaded with ``ctypes`` (no
PyTorch headers, so a build takes seconds).  The libraries go into
``build/kernels/`` at the root of the checkout, named by a hash of the
source, the shared headers (``csrc/*.cuh``) and the flags, so a changed
source rebuilds and an unchanged one is reused.  All missing libraries
are compiled in parallel, one ``nvcc`` process each, at the first CUDA
use of any kernel.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
KERNELS = ("delta_matmul", "fused_qdot", "decode_attention", "lut_matmul",
           "residual_matmul")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "--fmad=false", "-Xptxas", "-v", "-shared",
              "-Xcompiler", "-fPIC")

_P, _I, _LL, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, \
    ctypes.c_float
# C entry point and argument types of each library (csrc/<name>.cu)
SIGNATURES = {
    "delta_matmul": ("delta_matmul_launch",
                     [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P]),
    "fused_qdot": ("fused_qdot_launch",
                   [_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _LL,
                    _I, _I, _I, _I, _I, _I, _I, _P, _P]),
    "decode_attention": ("decode_attention_launch",
                         [_P, _LL, _P, _LL, _P, _LL, _P, _P, _P, _P, _P, _P,
                          _I, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I,
                          _I, _I, _I, _P]),
    "lut_matmul": ("lut_matmul_launch",
                   [_P, _P, _P, _P, _I, _I, _I, _I, _I, _P]),
    "residual_matmul": ("residual_matmul_launch",
                        [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                         _P]),
}

_FUNCS: dict = {}     # name -> bound C function (this process)


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    cand = Path(home) / "bin" / "nvcc"
    found = str(cand) if cand.exists() else shutil.which("nvcc")
    if not found:
        raise RuntimeError("nvcc not found (set CUDA_HOME): the CUDA kernels "
                           "are built from source at first use")
    return found


def _lib_path(name: str) -> Path:
    h = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):   # shared by the sources
        h.update(header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def build(names=KERNELS) -> dict:
    """Compile every library of ``names`` that is not built yet, all at
    once; return {name: compiler output} for those compiled (ptxas -v:
    registers and shared memory per kernel).  Raises on a failed build."""
    todo = [n for n in names if not _lib_path(n).exists()]
    if not todo:
        return {}
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    procs = {}
    for n in todo:
        tmp = _lib_path(n).with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{n}.cu")]
        procs[n] = (tmp, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                          stderr=subprocess.STDOUT,
                                          text=True))
    logs, failed = {}, []
    for n, (tmp, p) in procs.items():
        logs[n] = p.communicate()[0]
        if p.returncode != 0:
            failed.append(n)
            tmp.unlink(missing_ok=True)
        else:
            os.replace(tmp, _lib_path(n))   # atomic: concurrent builds
    if failed:
        raise RuntimeError("nvcc failed for " + ", ".join(failed) + ":\n"
                           + "\n".join(logs[n] for n in failed))
    return logs


def kernel(name: str):
    """The C launch function of kernel ``name``, building the libraries
    first if needed."""
    fn = _FUNCS.get(name)
    if fn is None:
        build()
        lib = ctypes.CDLL(str(_lib_path(name)))
        sym, argtypes = SIGNATURES[name]
        fn = getattr(lib, sym)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        _FUNCS[name] = fn
    return fn
