"""Build and load the port's CUDA kernels.

Every ``*.cu`` file under csrc/ is compiled by its own ``nvcc`` processes,
all started together: one, or one per part for a file with a line
``// nvcc parts: N`` (part k is compiled with ``-DTRPL_PART=k`` and holds
some of the file's entries).  The objects are linked into one shared library with
a plain C interface under build/ (no PyTorch headers, no ninja), loaded
with ctypes at first use.  The library's file name carries a hash of every
file under csrc/ (sources and the headers they share) and of the compiler
flags, so an edited header or source never loads a stale build.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import re
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
            m = re.search(r"^// nvcc parts: (\d+)$", src.read_text(), re.M)
            for k in range(int(m.group(1)) if m else 1):
                name = f"{src.name} part {k}" if m else src.name
                obj = objdir / f"{src.stem}.{k}.o"
                cmd = [nvcc, *_FLAGS, *([f"-DTRPL_PART={k}"] if m else []), "-Xptxas",
                       "-v", "-Xcompiler", "-fPIC", "-c", "-o", str(obj), str(src)]
                jobs.append((name, obj, subprocess.Popen(
                    cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)))
        reports, failed = [], []
        for name, _, proc in jobs:
            _, err = proc.communicate()
            reports.append(f"== {name}\n{err}")
            if proc.returncode != 0:
                failed.append(f"nvcc {name} failed ({proc.returncode}):\n{err}")
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


LAYOUT_FIELDS = ("samples_per_block", "threads_per_block", "smem_per_block",
                 "blocks_per_sm", "registers", "local_bytes", "sms")


def layout(entry: str, batch: int, *ints) -> dict:
    """The launch layout of C entry ``entry`` on the current card, from its
    ``<entry>_layout`` companion, which takes ``ints`` and fills
    LAYOUT_FIELDS (occupancy from cudaOccupancyMaxActiveBlocksPerMultiprocessor,
    registers and local memory from cudaFuncGetAttributes); adds the
    resident samples per SM and the waves of a launch of ``batch`` samples."""
    fn = function(entry + "_layout", [ctypes.c_int] * len(ints) + [ctypes.c_void_p])
    out = (ctypes.c_int * len(LAYOUT_FIELDS))()
    check(fn(*ints, ctypes.addressof(out)), entry + " layout")
    d = dict(zip(LAYOUT_FIELDS, out))
    d["samples_per_sm"] = d["blocks_per_sm"] * d["samples_per_block"]
    blocks = -(-batch // d["samples_per_block"])
    d["waves"] = blocks / max(d["blocks_per_sm"] * d["sms"], 1)
    return d


def ptxas_entries(report: str) -> list:
    """Per kernel entry of an ``nvcc -Xptxas -v`` report: (mangled name,
    registers, spill store bytes, spill load bytes, stack frame bytes)."""
    out, name, frame = [], None, (0, 0, 0)
    for line in report.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            name, frame = m.group(1), (0, 0, 0)
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", line)
        if m and name:
            frame = tuple(int(g) for g in m.groups())
            continue
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            out.append((name, int(m.group(1)), frame[1], frame[2], frame[0]))
            name = None
    return out


def check_tensor(name, x, dtype, shape, device):
    """Raise unless ``x`` is a contiguous tensor of this dtype, shape and
    device (what a kernel's C entry takes)."""
    if x.dtype != dtype or tuple(x.shape) != tuple(shape) or x.device != device:
        raise ValueError(f"{name}: expected {dtype} {tuple(shape)} on {device}, "
                         f"got {x.dtype} {tuple(x.shape)} on {x.device}")
    if not x.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def error_string(rc: int) -> str:
    """cudaGetErrorString of a C entry's return code."""
    return _lib.trpl_error_string(rc).decode()


def check(rc: int, what: str):
    """Raise if a C entry returned a CUDA error."""
    if rc != 0:
        raise RuntimeError(f"{what} launch failed: CUDA error {rc} "
                           f"({error_string(rc)})")
