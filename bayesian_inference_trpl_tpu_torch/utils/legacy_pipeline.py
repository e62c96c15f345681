"""Hierarchical grid-refinement inference (the reference's legacy pipeline).

A copy of the JAX package's ``utils/legacy_pipeline`` (reference:
Legacy/parallel_bayes.py:44-142): the parameter box is covered by a
coarse Cartesian grid, each refinement level keeps only the cells whose
posterior mass exceeds a floor and subdivides them, and the likelihood
adds a *model-error* variance estimated from grid-neighbour PL
differences, so coarse levels are forgiving and fine levels sharpen.  The
grid bookkeeping (``refine_grid``, ``index_grid``, ``param_grid``) stays
numpy on the host, bitwise the JAX package's (utils/sampling.py).

Two things differ from the JAX package, neither in what is computed:

* :func:`grid_refine_bayes` calls ``forward`` once per slice of whole
  blocks of a level (at most ``max_batch`` cells), not once per block.  With
  :func:`make_trpl_forward` on a fused method each call is one record
  launch of the horizon kernel, whose time does not depend on how many
  samples share it up to a wave of the card; the kernel takes every
  decision per sample, so a sample's PL does not depend on its batch-mates.
* :func:`model_err` and :func:`forward_lnp` are tensor functions on the
  forward's device, over every time point and block at once (one axis at
  a time), where the JAX package loops over time points, axes and rows in
  Python.  The neighbour differences stay in the PL's dtype and the
  likelihood in float64, as numpy promotes them there; the sum over time
  points runs in torch's order, not the JAX package's sequential one, and
  the model error's square is rounded correctly, where numpy's float32
  scalar power can be one ulp off.

Column contract: the 12/13-column parameter order of physics.PARAM_NAMES,
as the JAX package's.
"""
from __future__ import annotations

from typing import Callable, Sequence

import numpy as np
import torch

from .sampling import index_grid, param_grid, refine_grid

# Cells per forward call in grid_refine_bayes: whole blocks up to this many
# cells.  At it the float32 PL trace of an 80,000-step horizon recorded
# every step is 2.6 GB (8,192 x 80,001 x 4 B; 5.2 GB in float64), well
# inside an 80 GB card; a level of up to 8,192 cells is one record launch.
MAX_BATCH = 8192


def _neighbours(ref, device):
    """Per axis m of a block of prod(ref) cells (axis 0 fastest): the flat
    index of each cell's next neighbour along m, with wrap-around, and the
    mask of the cells whose neighbour wraps (the last row along m), as the
    reference's roll and zeroing build them."""
    n = int(np.prod(ref))
    idx = np.arange(n)
    out = []
    pN = 1
    for r in ref:
        dk = int(r) * pN
        out.append((torch.as_tensor((idx + pN) % n, device=device),
                    torch.as_tensor(idx % dk >= dk - pN, device=device)))
        pN *= int(r)
    return out


def model_err(F, ref):
    """Per-axis max |PL difference| between grid neighbours
    (reference: Legacy/parallel_bayes.py:44-55).  F is (..., prod(ref)):
    the PL of one refined block at one time point in its last axis, any
    leading axes (time points, blocks) alike.  Returns (..., len(ref)) in
    F's dtype; an axis of one cell gives 0.  One axis at a time, so that
    the work space stays the size of F."""
    F = torch.as_tensor(F)
    return torch.stack([(F - F[..., nbr]).abs().masked_fill(wrap, 0).amax(-1)
                        for nbr, wrap in _neighbours(ref, F.device)], -1)


def forward_lnp(F, values, std, ref):
    """Log-likelihood of each row of F with model-error variance
    (reference: Legacy/parallel_bayes.py:57-102, likelihood at 90-101).

    F: (n, n_times) PL, n a multiple of prod(ref): consecutive blocks of
    prod(ref) rows, each scored with its own model error; values/std:
    (n_times,) observations (float64).  Returns (n,) float64 on F's device.
    """
    F = torch.as_tensor(F)
    n, n_times = F.shape
    block = int(np.prod(ref))
    if n % block:
        raise ValueError(f"forward_lnp: {n} rows are not whole blocks of {block}")
    f64 = dict(dtype=torch.float64, device=F.device)
    values = torch.as_tensor(values, **f64)
    std = torch.as_tensor(std, **f64)
    Fb = F.reshape(n // block, block, n_times)
    sig = model_err(Fb.transpose(1, 2), ref).amax(-1)           # (blocks, t)
    # The square in the PL's dtype, then float64 (numpy's promotion of
    # sig.max() ** 2 + std[n] ** 2 in the JAX package).
    sg2 = (2.0 * ((sig ** 2).to(torch.float64) + std ** 2))[:, None, :]
    # Each row's terms summed along its own contiguous time axis: a row's
    # sum does not depend on how many blocks share the call.
    terms = (Fb.to(torch.float64) - values) ** 2 / sg2 + torch.log(torch.pi * sg2) / 2.0
    return -terms.sum(-1).reshape(n)


def marginal_p(N, P, refs):
    """Marginal posterior per axis over occupied cells
    (reference: Legacy/parallel_bayes.py:104-114)."""
    pN = np.prod(refs, axis=0)
    ind = index_grid(N, refs)
    out = []
    for m in range(len(refs[0])):
        Pm = np.zeros(pN[m])
        for n in np.unique(ind[:, m]):
            Pm[n] = P[ind[:, m] == n].sum()
        out.append(Pm)
    return out


def grid_refine_bayes(forward: Callable, refs: Sequence, min_x, max_x,
                      min_p: Sequence[float], data, do_log=None,
                      logger=None, max_batch: int = MAX_BATCH):
    """The refinement loop (reference: Legacy/parallel_bayes.py:127-142).

    Args:
      forward: callable(X (n, K)) -> PL (n, n_times) in the observation's
        units, a tensor or an array; typically :func:`make_trpl_forward`.
      refs: per-level per-axis subdivisions, shape (levels, K).
      min_p: per-level posterior-mass floor below which cells are dropped.
      data: (times, values, std) observation tuple.
      do_log: per-axis log-spacing flags (pass zeros for the reference's
        linear-only paramGrid).
      max_batch: cells per forward call: a level's cells in refine order,
        whole blocks of prod(refs[level]) at a time, at most this many (one
        block when a block is larger).

    Returns (N, P): occupied cell ids (finest level) and normalized
    posterior masses.
    """
    refs = [np.asarray(r, int) for r in refs]
    min_x = np.asarray(min_x, float)
    max_x = np.asarray(max_x, float)
    if do_log is None:
        do_log = np.zeros(len(min_x), int)
    do_log = np.asarray(do_log, int)
    _, values, std = data

    N = np.array([0])
    P = np.ones(1)
    for nref in range(len(refs)):
        N = N[P > min_p[nref]]
        N = refine_grid(N, refs[nref])
        Np = int(np.prod(refs[nref]))
        if logger:
            logger.info("refinement level %d: %d cells", nref, len(N))
        ind = index_grid(N, refs[:nref + 1])
        X = param_grid(ind, refs[:nref + 1], min_x, max_x, do_log)
        step = max(1, max_batch // Np) * Np
        lnp = np.zeros(len(N))
        for n in range(0, len(N), step):
            F = forward(X[n:n + step])
            lnp[n:n + step] = forward_lnp(F, values, std, refs[nref]).cpu().numpy()
        # Underflow-safe normalization (reference: parallel_bayes.py:140-141).
        P = np.exp(lnp - np.max(lnp))
        P /= P.sum()
    return N, P


def make_trpl_forward(sim, ini_par, init_mode="exp", dtype=torch.float32,
                      log_pl: bool = False, device="cuda"):
    """Batched forward model for :func:`grid_refine_bayes`: full 13-column
    X in (V, nm, ns) units (mag_offset ignored), returns the (n, num_pl)
    PL curves in physical units (log10 when ``log_pl``) as a tensor on
    ``device``.  It runs on ``cuda`` unless the caller passes
    ``device="cpu"``, and raises when CUDA is asked for and absent.  A
    fused ``sim.method`` makes each call one record launch of the horizon
    kernel (models/solver.solve), PL every ``sim.pl_stride`` steps."""
    from ..models.driver import pvsim

    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("make_trpl_forward: CUDA requested but no CUDA device is "
                           "available (pass device='cpu' to run on the CPU)")

    def forward(X):
        pl = pvsim(np.asarray(X)[:, :12], sim, ini_par, init_mode=init_mode,
                   dtype=dtype, device=device).pl
        if log_pl:
            pl = torch.log10(pl.clamp_min(1e-300))
        return pl
    return forward
