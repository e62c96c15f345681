"""Build and load the port's CUDA kernels.

Every ``*.cu`` file under csrc/ is compiled by its own ``nvcc`` process, all
started together, and the objects are linked into one shared library with
a plain C interface under build/ (no PyTorch headers, no ninja), loaded
with ctypes at first use.  The library's file name carries a hash of every
file under csrc/ (sources and the headers they share) and of the compiler
flags, so an edited header or source never loads a stale build.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

_CSRC = Path(__file__).resolve().parent.parent / "csrc"
_BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "trpl_torch_kernels"
_LIB_NAME = "libtrpl_torch_kernels.so"
# --fmad=false keeps the arithmetic of the plain PyTorch versions (no
# contraction into fused multiply-adds), so float64 agrees to rounding.
_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
          "--fmad=false"]
_lib = None
_fns = {}
build_info = {}


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels are built at first "
                       "use and need the CUDA toolkit")


def _tag() -> str:
    h = hashlib.sha256(" ".join(_FLAGS).encode())
    for f in sorted(p for p in _CSRC.iterdir() if p.is_file()):
        h.update(f.name.encode() + b"\0" + f.read_bytes())
    return h.hexdigest()[:16]


def build_library(verbose: bool = False) -> Path:
    """Compile csrc/*.cu in parallel and link them into build/; returns the
    library's path.  ``build_info`` gets the path, the seconds and the
    ptxas report (registers, shared memory and spills of every entry)."""
    tag = _tag()
    _BUILD_DIR.mkdir(parents=True, exist_ok=True)
    out = _BUILD_DIR / f"{tag}-{_LIB_NAME}"
    if out.exists():
        build_info.update(path=str(out), seconds=0.0, cached=True)
        return out
    nvcc = _nvcc()
    objdir = _BUILD_DIR / f"{tag}.{os.getpid()}.objs"
    objdir.mkdir(exist_ok=True)
    t0 = time.perf_counter()
    try:
        jobs = []
        for src in sorted(_CSRC.glob("*.cu")):
            obj = objdir / (src.stem + ".o")
            cmd = [nvcc, *_FLAGS, "-Xptxas", "-v", "-Xcompiler", "-fPIC", "-c",
                   "-o", str(obj), str(src)]
            jobs.append((src, obj, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)))
        reports, failed = [], []
        for src, _, proc in jobs:
            _, err = proc.communicate()
            reports.append(f"== {src.name}\n{err}")
            if proc.returncode != 0:
                failed.append(f"nvcc {src.name} failed ({proc.returncode}):\n{err}")
        if failed:
            raise RuntimeError("\n".join(failed))
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        link = subprocess.run([nvcc, "-shared", "-o", str(tmp)]
                              + [str(obj) for _, obj, _ in jobs],
                              capture_output=True, text=True)
        if link.returncode != 0:
            raise RuntimeError(f"nvcc link failed ({link.returncode}):\n{link.stderr}")
        os.replace(tmp, out)
    finally:
        shutil.rmtree(objdir, ignore_errors=True)
    build_info.update(path=str(out), seconds=time.perf_counter() - t0,
                      cached=False, ptxas="\n".join(reports))
    if verbose:
        print(build_info["ptxas"])
    return out


def function(name: str, argtypes):
    """The library's C entry ``name`` with its argument types set (ctypes
    passes every pointer as c_void_p, every int as c_int); returns int."""
    global _lib
    if name not in _fns:
        if _lib is None:
            _lib = ctypes.CDLL(str(build_library()))
            _lib.trpl_error_string.argtypes = [ctypes.c_int]
            _lib.trpl_error_string.restype = ctypes.c_char_p
        fn = getattr(_lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        _fns[name] = fn
    return _fns[name]


def check_tensor(name, x, dtype, shape, device):
    """Raise unless ``x`` is a contiguous tensor of this dtype, shape and
    device (what a kernel's C entry takes)."""
    if x.dtype != dtype or tuple(x.shape) != tuple(shape) or x.device != device:
        raise ValueError(f"{name}: expected {dtype} {tuple(shape)} on {device}, "
                         f"got {x.dtype} {tuple(x.shape)} on {x.device}")
    if not x.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def check(rc: int, what: str):
    """Raise if a C entry returned a CUDA error."""
    if rc != 0:
        raise RuntimeError(f"{what} launch failed: CUDA error {rc} "
                           f"({_lib.trpl_error_string(rc).decode()})")
