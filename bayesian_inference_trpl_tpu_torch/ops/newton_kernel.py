"""The per-step Newton kernel: one implicit BDF step's check-then-solve
exact Newton over a batch, in one launch.

Replaces ``newton_kernel._kernel`` of the JAX package
(bayesian_inference_trpl_tpu/ops/pallas/newton_kernel.py:35-56, launched by
``_call`` at :59-104 through ``pallas_newton_step``, :107-140), the step of
method ``coupled_newton_pallas``.

* :func:`newton_step` -- the wrapper, with the signature of
  models/newton.coupled_newton_step.  On CUDA tensors it launches the
  hand-written kernel (csrc/newton_kernel.cu, one warp per sample; its
  Newton body is the horizon kernel's full Newton, csrc/trpl_newton.cuh)
  or raises; on CPU tensors it runs the plain version,
  ``coupled_newton_step`` itself.
* :func:`step_launcher` -- one launch bound to its arguments, for timing.
* :func:`launch_layout` -- how one launch sits on the card.
* :func:`step_inputs_from_jax` -- one BDF step's JAX inputs, as numpy, as
  this port's tensors, so that tests feed both the same thing.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from ..models.newton import coupled_newton_step
from ..models.trpl import MatParams, SKIP_ACCEPT_FACTOR, STEP_TOL_RESIDUAL_GUARD
from . import kernel_lib

# Launches of the CUDA kernel, counted by newton_step where it launches;
# chip_smoke.py zeroes it around each main path.
launches = 0

_VP, _CI, _CD = ctypes.c_void_p, ctypes.c_int, ctypes.c_double
_ARGTYPES = [_VP] * 14 + [_CI] * 3 + [_CD] * 2 + [_VP]


def _device_scalar(v, like: torch.Tensor) -> torch.Tensor:
    """A one-element tensor of ``like``'s dtype on its device; a tensor
    already there is reused, so passing it costs no host-device wait."""
    return torch.as_tensor(v, dtype=like.dtype, device=like.device).reshape(1)


def newton_step(Nk0, Pk0, bN, bP, bE, mp: MatParams, a0, tol, max_iters: int,
                step_tol=0.0):
    """Advance one BDF step by check-then-solve exact Newton.

    Arguments and returns as models/newton.coupled_newton_step: Nk0/Pk0 the
    (batch, L) predicted iterate, bN/bP/bE the BDF history sums, ``mp`` the
    per-sample parameters, a0/tol/step_tol scalars (0-dim tensors or
    numbers).  Returns (N, P, E, iters (batch,) int32, converged (batch,)
    bool).  On CPU tensors this is ``coupled_newton_step``; on CUDA tensors
    one launch of the kernel.
    """
    if Nk0.device.type == "cpu":
        return coupled_newton_step(Nk0, Pk0, bN, bP, bE, mp, a0, tol, max_iters,
                                   step_tol=step_tol)
    launch, (n, p, e, its, done) = step_launcher(Nk0, Pk0, bN, bP, bE, mp, a0, tol,
                                                 max_iters, step_tol)
    launch()
    return n, p, e, its, done.bool()


def step_launcher(Nk0, Pk0, bN, bP, bE, mp: MatParams, a0, tol, max_iters: int,
                  step_tol=0.0):
    """Check :func:`newton_step`'s CUDA arguments and allocate its outputs;
    returns (launch, (N, P, E, iters, converged as int32)), where each call
    of ``launch()`` runs the kernel once into those outputs, with no other
    host work (so that a timer around it sees the kernel alone)."""
    if Nk0.device.type != "cuda":
        raise ValueError(f"newton_step: unsupported device {Nk0.device}")
    dtype, dev = Nk0.dtype, Nk0.device
    if dtype not in (torch.float32, torch.float64):
        raise ValueError(f"newton_step: unsupported dtype {dtype}")
    batch, L = Nk0.shape
    if L & (L - 1) or not 32 <= L <= 1024:
        raise ValueError(f"newton_step: L must be a power of two in [32, 1024], "
                         f"got {L}")
    for name, x in (("Nk0", Nk0), ("Pk0", Pk0), ("bN", bN), ("bP", bP), ("bE", bE)):
        kernel_lib.check_tensor(name, x, dtype, (batch, L), dev)
    mat = torch.stack(tuple(mp), dim=1)
    kernel_lib.check_tensor("mp", mat, dtype, (batch, 12), dev)
    scalars = [_device_scalar(v, Nk0) for v in (a0, tol, step_tol)]
    n, p, e = (torch.empty_like(Nk0) for _ in range(3))
    its = torch.empty(batch, dtype=torch.int32, device=dev)
    done = torch.empty_like(its)
    fn = kernel_lib.function("trpl_newton_step_{}".format(
        "f32" if dtype == torch.float32 else "f64"), _ARGTYPES)
    args = (*(x.data_ptr() for x in (mat, Nk0, Pk0, bN, bP, bE, *scalars,
                                     n, p, e, its, done)),
            batch, L, int(max_iters), float(SKIP_ACCEPT_FACTOR),
            float(STEP_TOL_RESIDUAL_GUARD), torch.cuda.current_stream(dev).cuda_stream)

    def launch():
        global launches
        # The C entry launches on the current CUDA device, which need not be
        # the inputs' (horizon_kernel.horizon_chord says why that matters).
        with torch.cuda.device(dev):
            kernel_lib.check(fn(*args), "newton step kernel")
        launches += 1
    # Every tensor the launch reads or writes lives as long as the launch.
    launch.keep = (mat, Nk0, Pk0, bN, bP, bE, scalars, n, p, e, its, done)
    return launch, (n, p, e, its, done)


def launch_layout(batch: int, L: int, dtype=torch.float32) -> dict:
    """How one launch of the CUDA kernel sits on the current card
    (ops/kernel_lib.layout), at ``batch`` samples."""
    return kernel_lib.layout("trpl_newton_step_{}".format(
        "f32" if dtype == torch.float32 else "f64"), batch, L)


def step_inputs_from_jax(mp, Nk0, Pk0, bN, bP, bE, a0, tol, step_tol,
                         columns=True, dtype=torch.float64, device="cpu"):
    """One BDF step's JAX inputs (numpy, or anything ``np.asarray`` takes)
    as this port's.  ``mp``: the JAX MatParams, or its (12, batch) stack
    (the JAX kernel's layout); with ``columns=False`` a (batch, 12)
    parameter matrix.  Returns (Nk0, Pk0, bN, bP, bE, MatParams, a0, tol,
    step_tol) as tensors, in the order of :func:`newton_step`'s arguments."""
    def t(a):
        return torch.tensor(np.array(a), dtype=dtype, device=device)

    mat = np.asarray([np.asarray(c) for c in mp])
    mat = mat.T if columns else mat
    return (*(t(x) for x in (Nk0, Pk0, bN, bP, bE)),
            MatParams.from_array(t(mat)), t(a0), t(tol), t(step_tol))
