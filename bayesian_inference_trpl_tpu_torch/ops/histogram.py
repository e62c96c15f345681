"""Weighted 1-D and 2-D histograms: the posterior marginals' binning.

Replaces the JAX package's OpenMP histograms of its native host library
(bayesian_inference_trpl_tpu/native/src/trpl_native.cpp:97-138,
``trpl_hist1d_weighted``, and :142-179, ``trpl_hist2d_weighted``), which its
posterior/stats.py calls at :127 and :155.  Not a pallas_call.

* :func:`hist1d_weighted`, :func:`hist2d_weighted` -- the wrappers.  On
  CUDA tensors they launch the hand-written kernel (csrc/hist_kernel.cu)
  or raise; on CPU tensors they run the plain version.
* :func:`hist1d_weighted_plain`, :func:`hist2d_weighted_plain` -- the plain
  PyTorch versions (``index_add_`` in float64).
* :func:`launch_plan` -- the path (shared or global memory), blocks and
  shared bytes the kernel takes for a size.

Both versions bin by the native library's rule: ``inv = bins / (hi - lo)``
on the host in float64, ``b = (int64)((x - lo) * inv)``, a sample with
``x < lo`` or ``x > hi`` dropped, ``b == bins`` taken as ``bins - 1``.  A
NaN ``x``, or a product at or past 2^63 (``hi == lo`` gives NaN), is
dropped, as the x86 cast drops it.  Counts are exact; the kernel's float64
sums follow the order of its atomics, so they are not bitwise the same
from run to run.
"""
from __future__ import annotations

import ctypes
import math

import torch

from . import kernel_lib

# Launches of the CUDA kernels, counted by the wrappers where they launch;
# chip_smoke.py zeroes them around its main path.
launches = {"hist1d_weighted": 0, "hist2d_weighted": 0}

_VP, _LL, _CD = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_double
_ARGS_1D = [_VP, _VP, _LL, _CD, _CD, _CD, _LL, _VP, _VP, _VP, _VP]
_ARGS_2D = [_VP, _VP, _VP, _LL, _CD, _CD, _CD, _LL, _CD, _CD, _CD, _LL, _VP, _VP, _VP]
_INT64_LIMIT = 2.0 ** 63
PLAN_FIELDS = ("path", "blocks", "smem_per_block", "smem_optin")


def axis(lo, hi, bins):
    """(lo, hi, inv, bins) as the host computes them: inv in float64, +inf
    for an empty range (C++'s bins / 0.0)."""
    lo, hi, bins = float(lo), float(hi), int(bins)
    if bins < 1:
        raise ValueError(f"bins must be positive, got {bins}")
    width = hi - lo
    inv = bins / width if width != 0 else math.copysign(math.inf, width)
    return lo, hi, inv, bins


def bin_index(x, lo, hi, inv, bins):
    """Per sample its bin under the native rule, and whether it is kept."""
    keep = (x >= lo) & (x <= hi)
    f = (x - lo) * inv
    keep &= f < _INT64_LIMIT
    b = torch.where(keep, f, torch.zeros_like(f)).to(torch.int64)
    b = torch.where(b == bins, b - 1, b)
    keep &= (b >= 0) & (b < bins)
    return b, keep


def _check(name, t, n, device):
    if t.dtype != torch.float64 or t.dim() != 1 or t.shape[0] != n or t.device != device:
        raise ValueError(f"{name}: expected float64 ({n},) on {device}, got "
                         f"{t.dtype} {tuple(t.shape)} on {t.device}")
    return t.contiguous()


def hist1d_weighted_plain(x, w, lo, hi, bins):
    """Plain version of :func:`hist1d_weighted` on the tensors' device."""
    lo, hi, inv, bins = axis(lo, hi, bins)
    b, keep = bin_index(x, lo, hi, inv, bins)
    b = b[keep]
    out_w = torch.zeros(bins, dtype=torch.float64, device=x.device).index_add_(0, b, w[keep])
    out_c = torch.zeros(bins, dtype=torch.int64, device=x.device).index_add_(
        0, b, torch.ones_like(b))
    return out_w, out_c


def hist2d_weighted_plain(x, y, w, lox, hix, bx, loy, hiy, by):
    """Plain version of :func:`hist2d_weighted` on the tensors' device."""
    ax, ay = axis(lox, hix, bx), axis(loy, hiy, by)
    a, keep = bin_index(x, *ax)
    b, keep_y = bin_index(y, *ay)
    keep &= keep_y
    k = (a * ay[3] + b)[keep]
    out = torch.zeros(ax[3] * ay[3], dtype=torch.float64, device=x.device)
    return out.index_add_(0, k, w[keep]).view(ax[3], ay[3])


def hist1d_weighted(x, w, lo, hi, bins):
    """Weighted sums (bins,) float64 and counts (bins,) int64 of the float64
    samples ``x`` with weights ``w`` (each (n,)) on the uniform grid of
    ``bins`` bins over [lo, hi], under the native rule (module docstring)."""
    if x.device.type == "cpu":
        return hist1d_weighted_plain(x, w, lo, hi, bins)
    if x.device.type != "cuda":
        raise ValueError(f"hist1d_weighted: unsupported device {x.device}")
    lo, hi, inv, bins = axis(lo, hi, bins)
    n = x.shape[0] if x.dim() == 1 else -1
    x, w = _check("x", x, n, x.device), _check("w", w, n, x.device)
    out_w = torch.zeros(bins, dtype=torch.float64, device=x.device)
    out_c = torch.zeros(bins, dtype=torch.int64, device=x.device)
    fn = kernel_lib.function("trpl_hist1d_f64", _ARGS_1D)
    with torch.cuda.device(x.device):
        kernel_lib.check(fn(x.data_ptr(), w.data_ptr(), n, lo, hi, inv, bins,
                            out_w.data_ptr(), out_c.data_ptr(),
                            torch.cuda.current_stream(x.device).cuda_stream, None),
                         "hist1d_weighted")
    launches["hist1d_weighted"] += 1
    return out_w, out_c


def hist2d_weighted(x, y, w, lox, hix, bx, loy, hiy, by):
    """Weighted sums (bx, by) float64, row-major, of the samples (x, y)
    with weights ``w`` (each (n,) float64) on the uniform grids of bx bins
    over [lox, hix] and by bins over [loy, hiy], under the native rule."""
    if x.device.type == "cpu":
        return hist2d_weighted_plain(x, y, w, lox, hix, bx, loy, hiy, by)
    if x.device.type != "cuda":
        raise ValueError(f"hist2d_weighted: unsupported device {x.device}")
    ax, ay = axis(lox, hix, bx), axis(loy, hiy, by)
    n = x.shape[0] if x.dim() == 1 else -1
    x, y, w = (_check(k, t, n, x.device) for k, t in (("x", x), ("y", y), ("w", w)))
    out = torch.zeros((ax[3], ay[3]), dtype=torch.float64, device=x.device)
    fn = kernel_lib.function("trpl_hist2d_f64", _ARGS_2D)
    with torch.cuda.device(x.device):
        kernel_lib.check(fn(x.data_ptr(), y.data_ptr(), w.data_ptr(), n, *ax, *ay,
                            out.data_ptr(),
                            torch.cuda.current_stream(x.device).cuda_stream, None),
                         "hist2d_weighted")
    launches["hist2d_weighted"] += 1
    return out


def launch_plan(dims: int, n: int, bins: int) -> dict:
    """The kernel's launch for ``n`` samples into ``bins`` bins in all
    (``dims`` 1 or 2) on the current card: PLAN_FIELDS, path "shared" or
    "global"."""
    fn = kernel_lib.function("trpl_hist_plan", [ctypes.c_int, _LL, _LL, _VP])
    out = (ctypes.c_int * len(PLAN_FIELDS))()
    kernel_lib.check(fn(int(dims), int(n), int(bins), ctypes.addressof(out)),
                     "hist plan")
    d = dict(zip(PLAN_FIELDS, out))
    d["path"] = ("shared", "global")[d["path"]]
    return d
