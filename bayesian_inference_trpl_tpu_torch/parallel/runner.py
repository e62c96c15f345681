"""Chunked single-device inference runner.

One chunk program (solver + fused likelihood) evaluates a chunk of samples
on the device; the host loops over chunks, bounding device memory like
the reference's ``sims_per_gpu`` batching (bayeslib.py:131-146), and
accumulates per-sample log-likelihoods.  The next chunk is enqueued
before the previous one is read back, so host-side preparation overlaps
device work.  More than one device is ROADMAP A15.

There is no retry pass for non-converged samples (the JAX package's
``_retry_nonconverged``): every path of this port takes its chord
decisions per sample, so a sample's result does not depend on its
batch-mates and a failure-only batch repeats the failure bit for bit
(tests/test_torch_runner.py).
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
from ..models.offgrid import OffGridTables, solve_offgrid
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


def _chunk_likelihood_offgrid(mat_nd, mag, dn, tables: OffGridTables,
                              log_scale, *, cfg: SolverConfig,
                              normalize: bool, schedule):
    """Chunk program for OFF-GRID observation times: solve with the
    slot-table fused likelihood (models/offgrid.py).  Returns
    (P_chunk (num_exp, chunk), converged (chunk,))."""
    n0 = mat_nd[:, 0:1] + dn[None, :]
    p0 = mat_nd[:, 1:2] + dn[None, :]
    e0 = torch.zeros_like(n0)
    res = solve_offgrid(mat_nd, n0, p0, e0, cfg, tables, schedule,
                        log_scale, FLOAT_MIN, normalize=normalize)
    ll = log_likelihood_from_terms(res.sse, res.err_sum, tables.n_obs[:, None],
                                   mag[None, :])
    ll = torch.where(res.converged[None, :], ll, torch.nan)
    return ll, res.converged


class Runner:
    """Chunked executor on one device (``cuda`` unless told ``cpu``)."""

    def __init__(self, chunk: int = 1024, device="cuda"):
        self.device = torch.device(device)
        self.chunk = int(chunk)
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

    def run_curve(self, X, sim: SimParams, ini_par, obs_log_values,
                  normalize: bool = False, dtype=torch.float32,
                  progress: Optional[Callable[[int, int], None]] = None,
                  chunk_done: Optional[Callable[[int, np.ndarray], None]] = None,
                  out: Optional[np.ndarray] = None, obs_mask=None):
        """Evaluate the log-likelihood of every sample in X for one
        excitation curve against observations on the simulation grid.

        Args:
          X: (n, 13) sample matrix in (V, nm, ns) units (mag_offset last).
          obs_log_values: (num_exp, sim.num_pl) log10 observed PL.
          chunk_done: callback(chunk_index, P_chunk) for checkpointing.
          out: optional (num_exp, n) accumulator to ADD likelihoods into
            (NaN marks non-converged samples and propagates).
          obs_mask: optional (num_exp, sim.num_pl) per-point weights.

        Returns (out (num_exp, n), converged (n,)).
        """
        obs = self._put(obs_log_values, dtype)
        mask = None if obs_mask is None else self._put(obs_mask, dtype)
        statics = dict(cfg=sim.solver_config(), normalize=normalize,
                       fast=sim.fast_phases)

        def chunk_fn(mat_c, mag_c, dn, log_scale):
            return _chunk_likelihood(mat_c, mag_c, dn, obs, log_scale, mask,
                                     **statics)
        return self._run(chunk_fn, X, sim, ini_par, len(obs_log_values), dtype,
                         progress, chunk_done, out)

    def run_curve_offgrid(self, X, sim: SimParams, ini_par, tables: OffGridTables,
                          schedule, normalize: bool = False, dtype=torch.float32,
                          progress: Optional[Callable[[int, int], None]] = None,
                          chunk_done: Optional[Callable[[int, np.ndarray], None]] = None,
                          out: Optional[np.ndarray] = None):
        """Off-grid variant of :meth:`run_curve`: observation times are
        scored inside the solve from precomputed slot tables
        (models/offgrid.py); arguments and returns as :meth:`run_curve`.

        Args:
          tables: OffGridTables from models.offgrid.build_offgrid_tables
            (times mapped with this sim's dt and the given schedule).
          schedule: ((stride, num_fine_steps), ...) covering sim.T.
        """
        dev_tables = OffGridTables(
            phases=tuple(tuple(self._put(a, dtype) for a in tbl)
                         for tbl in tables.phases),
            v0=self._put(tables.v0, dtype), m0=self._put(tables.m0, dtype),
            n_obs=self._put(tables.n_obs, dtype))
        statics = dict(cfg=sim.solver_config(), normalize=normalize,
                       schedule=tuple((int(s), int(c)) for s, c in schedule))

        def chunk_fn(mat_c, mag_c, dn, log_scale):
            return _chunk_likelihood_offgrid(mat_c, mag_c, dn, dev_tables,
                                             log_scale, **statics)
        return self._run(chunk_fn, X, sim, ini_par, len(tables.v0), dtype,
                         progress, chunk_done, out)

    def _run(self, chunk_fn, X, sim: SimParams, ini_par, num_exp: int, dtype,
             progress, chunk_done, out):
        """The chunk loop shared by both curve kinds."""
        n = len(X)
        mat_nd_all = physics.nondimensionalize(np.asarray(X)[:, :12], sim.dx, sim.dt)
        mag_all = np.asarray(X)[:, 12]
        dn = initial_excess_density(sim, ini_par, "points", dtype=dtype,
                                    device=self.device)
        log_scale = pl_log_scale(sim)
        if out is None:
            out = np.zeros((num_exp, n))
        conv = np.ones(n, dtype=bool)

        def dispatch(mat_c, mag_c):
            return chunk_fn(self._put(mat_c, dtype), self._put(mag_c, dtype),
                            dn, log_scale)

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
        return out, conv
