"""Chunked single-device inference runner.

One chunk program (solver + fused likelihood) evaluates a chunk of samples
on the device; the host loops over chunks, bounding device memory like
the reference's ``sims_per_gpu`` batching (bayeslib.py:131-146), and
accumulates per-sample log-likelihoods.  The next chunk is enqueued
before the previous one is read back, so host-side preparation overlaps
device work.  More than one device is ROADMAP A15.
"""
from __future__ import annotations

import logging
import time
from dataclasses import dataclass
from typing import Callable, Optional

import numpy as np
import torch

from .. import physics
from ..models.driver import SimParams, initial_excess_density, pl_log_scale
from ..models.solver import FusedObs, SolverConfig, solve
from ..models.twophase import solve_multiphase
from ..ops.likelihood import FLOAT_MIN, log_likelihood_from_terms

logger = logging.getLogger(__name__)


@dataclass
class RunnerTimers:
    """Per-stage wall-clock accounting, mirroring the reference's
    solver/err_sq/misc accumulators (reference: bayeslib.py:210-212)."""
    solver_time: float = 0.0
    err_sq_time: float = 0.0
    misc_time: float = 0.0

    def as_dict(self):
        return dict(solver_time=self.solver_time, err_sq_time=self.err_sq_time,
                    misc_time=self.misc_time)


def _chunk_likelihood(mat_nd, mag, dn, obs_values, log_scale, obs_mask=None,
                      *, cfg: SolverConfig, normalize: bool, fast=None):
    """Chunk program: solve + fused likelihood.  Returns
    (P_chunk (num_exp, chunk), converged (chunk,)).

    ``fast``: optional phase schedule ((stride, num_fine_steps), ...)
    selecting the multi-phase fast solver (models/twophase.py).
    ``obs_mask``: optional per-point weights (num_exp, T+1).
    """
    n0 = mat_nd[:, 0:1] + dn[None, :]
    p0 = mat_nd[:, 1:2] + dn[None, :]
    e0 = torch.zeros_like(n0)
    obs = FusedObs(values=obs_values, log_scale=log_scale, min_val=FLOAT_MIN,
                   normalize=normalize, mask=obs_mask)
    if fast is not None:
        res = solve_multiphase(mat_nd, n0, p0, e0, cfg, obs, fast)
    else:
        res = solve(mat_nd, n0, p0, e0, cfg, obs=obs, record_pl=False)
    if obs_mask is not None:
        n_obs = obs_mask.sum(-1, keepdim=True)
    else:
        n_obs = obs_values.shape[-1]
    ll = log_likelihood_from_terms(res.sse, res.err_sum, n_obs, mag[None, :])
    ll = torch.where(res.converged[None, :], ll, torch.nan)
    return ll, res.converged


class Runner:
    """Chunked executor on one device (``cuda`` unless told ``cpu``)."""

    def __init__(self, chunk: int = 1024, retries: int = 1, device="cuda"):
        self.device = torch.device(device)
        self.chunk = int(chunk)
        self.retries = int(retries)
        self.timers = RunnerTimers()

    def _put(self, arr, dtype):
        return torch.as_tensor(np.ascontiguousarray(arr), dtype=dtype,
                               device=self.device)

    def _pad(self, mat_c, mag_c):
        pad = self.chunk - len(mat_c)
        if pad:
            mat_c = np.concatenate([mat_c, np.repeat(mat_c[-1:], pad, 0)], 0)
            mag_c = np.concatenate([mag_c, np.repeat(mag_c[-1:], pad, 0)], 0)
        return mat_c, mag_c

    def _retry_nonconverged(self, dispatch, mat_nd_all, mag_all, out, conv,
                            P_before):
        """Re-dispatch the non-converged samples of a finished curve in
        failure-only batches and repair their likelihoods (a second batch
        layout for the failures)."""
        for r in range(self.retries):
            idx = np.where(~conv)[0]
            if idx.size == 0:
                return
            t0 = time.perf_counter()
            before = idx.size
            for lo in range(0, idx.size, self.chunk):
                sel = idx[lo:lo + self.chunk]
                ll, ok = dispatch(*self._pad(mat_nd_all[sel], mag_all[sel]))
                ll = ll.cpu().numpy()[:, :sel.size]
                ok = ok.cpu().numpy()[:sel.size]
                rec = sel[ok]
                out[:, rec] = P_before[:, rec] + ll[:, ok]
                conv[rec] = True
            self.timers.solver_time += time.perf_counter() - t0
            logger.info("Retry %d: %d of %d non-converged samples recovered "
                        "(%.1fs)", r, before - int((~conv).sum()), before,
                        time.perf_counter() - t0)

    def run_curve(self, X, sim: SimParams, ini_par, obs_log_values,
                  normalize: bool = False, dtype=torch.float32,
                  progress: Optional[Callable[[int, int], None]] = None,
                  chunk_done: Optional[Callable[[int, np.ndarray], None]] = None,
                  out: Optional[np.ndarray] = None, obs_mask=None,
                  retry_done: Optional[Callable[[], None]] = None):
        """Evaluate the log-likelihood of every sample in X for one
        excitation curve against observations on the simulation grid.

        Args:
          X: (n, 13) sample matrix in (V, nm, ns) units (mag_offset last).
          obs_log_values: (num_exp, sim.num_pl) log10 observed PL.
          chunk_done: callback(chunk_index, P_chunk) for checkpointing.
          out: optional (num_exp, n) accumulator to ADD likelihoods into
            (NaN marks non-converged samples and propagates).
          obs_mask: optional (num_exp, sim.num_pl) per-point weights.
          retry_done: called after the retry pass repairs any samples.

        Returns (out (num_exp, n), converged (n,)).
        """
        n = len(X)
        num_exp = len(obs_log_values)
        mat_nd_all = physics.nondimensionalize(np.asarray(X)[:, :12], sim.dx, sim.dt)
        mag_all = np.asarray(X)[:, 12]
        dn = initial_excess_density(sim, ini_par, "points", dtype=dtype,
                                    device=self.device)
        obs = self._put(obs_log_values, dtype)
        mask = None if obs_mask is None else self._put(obs_mask, dtype)
        log_scale = pl_log_scale(sim)
        statics = dict(cfg=sim.solver_config(), normalize=normalize,
                       fast=sim.fast_phases)
        if out is None:
            out = np.zeros((num_exp, n))
        P_before = out.copy() if self.retries else None
        conv = np.ones(n, dtype=bool)

        def dispatch(mat_c, mag_c):
            return _chunk_likelihood(self._put(mat_c, dtype), self._put(mag_c, dtype),
                                     dn, obs, log_scale, mask, **statics)

        def harvest(ci, lo, size, ll, ok):
            t0 = time.perf_counter()
            ll = ll.cpu().numpy()                 # device sync point
            ok = ok.cpu().numpy()
            self.timers.solver_time += time.perf_counter() - t0
            t0 = time.perf_counter()
            out[:, lo:lo + size] += ll[:, :size]
            conv[lo:lo + size] = ok[:size]
            if chunk_done is not None:
                chunk_done(ci, ll[:, :size])
            self.timers.misc_time += time.perf_counter() - t0

        # The next chunk is enqueued before the previous one is read back.
        n_chunks = -(-n // self.chunk)
        pending = None
        for ci in range(n_chunks):
            lo = ci * self.chunk
            hi = min(lo + self.chunk, n)
            if progress is not None:
                progress(ci, n_chunks)
            t0 = time.perf_counter()
            ll, ok = dispatch(*self._pad(mat_nd_all[lo:hi], mag_all[lo:hi]))
            self.timers.solver_time += time.perf_counter() - t0
            if pending is not None:
                harvest(*pending)
            pending = (ci, lo, hi - lo, ll, ok)
        if pending is not None:
            harvest(*pending)
        if self.retries and not conv.all():
            self._retry_nonconverged(dispatch, mat_nd_all, mag_all, out, conv,
                                     P_before)
            if retry_done is not None:
                retry_done()
        return out, conv
