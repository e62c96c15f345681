"""The host CSV parser (native/src/trpl_native.cpp), built at first use.

The counterpart of the JAX package's ``native`` module for the observation
CSVs: ``parse_obs_csv`` scans a file's bytes with ``strtod`` instead of
Python's csv module.  The library is compiled with the host C++ compiler
(``$CXX``, else ``c++`` or ``g++``) into build/trpl_native/, under a name
that hashes the source, the compiler and the flags, and loaded with
ctypes.  A build or load that fails raises: no caller falls back quietly.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import numpy as np

_SRC = Path(__file__).resolve().parent / "src" / "trpl_native.cpp"
_BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "trpl_native"
_LIB_NAME = "libtrpl_native.so"
_FLAGS = ["-O2", "-fPIC", "-shared", "-std=c++17"]
_lib = None


def _compiler() -> str:
    for cand in (os.environ.get("CXX"), "c++", "g++"):
        path = cand and shutil.which(cand)
        if path:
            return path
    raise RuntimeError("no host C++ compiler (CXX, c++ or g++): the CSV parser "
                       "is built at first use")


def build() -> Path:
    """Compile the parser into build/ unless a build of this source and
    these flags is there; returns the library's path."""
    cxx = _compiler()
    h = hashlib.sha256(" ".join([cxx, *_FLAGS]).encode() + b"\0" + _SRC.read_bytes())
    out = _BUILD_DIR / f"{h.hexdigest()[:16]}-{_LIB_NAME}"
    if out.exists():
        return out
    _BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    proc = subprocess.run([cxx, *_FLAGS, "-o", str(tmp), str(_SRC)],
                          capture_output=True, text=True, timeout=300)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"{cxx} failed ({proc.returncode}) on {_SRC}:\n{proc.stderr}")
    os.replace(tmp, out)
    return out


def load():
    """The loaded library (built if needed)."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        dp = ctypes.POINTER(ctypes.c_double)
        lib.trpl_count_rows.restype = ctypes.c_long
        lib.trpl_count_rows.argtypes = [ctypes.c_char_p]
        lib.trpl_parse_obs_csv.restype = ctypes.c_long
        lib.trpl_parse_obs_csv.argtypes = [ctypes.c_char_p, dp, dp, dp]
        _lib = lib
    return _lib


def parse_obs_csv(path: str):
    """(t, pl, unc) float64 arrays of a 3-column observation CSV, up to its
    END sentinel.  Raises FileNotFoundError if the file cannot be read and
    ValueError if a row is not numeric (the parser's code -2)."""
    lib = load()
    name = os.fsencode(path)
    rows = lib.trpl_count_rows(name)
    if rows < 0:
        raise FileNotFoundError(path)
    cols = [np.empty(rows) for _ in range(3)]
    n = lib.trpl_parse_obs_csv(
        name, *(c.ctypes.data_as(ctypes.POINTER(ctypes.c_double)) for c in cols))
    if n == -1:
        raise FileNotFoundError(path)
    if n < 0:
        raise ValueError(f"failed to parse {path} (code {n})")
    return tuple(c[:n].copy() for c in cols)
