"""Chunked inference runner over a sample mesh.

One chunk program (solver + fused likelihood, or solver + interpolated
likelihood) evaluates a chunk of samples; the host loops over chunks,
bounding device memory like the reference's ``sims_per_gpu`` batching
(bayeslib.py:131-146), and accumulates per-sample log-likelihoods.

A global chunk is ``chunk_per_device`` x the mesh's devices x the
processes (parallel/distributed.py), as in the JAX package's
``ShardedRunner``: rank r takes rows [r c, (r + 1) c) of each padded
chunk, and its device d the d-th ``chunk_per_device`` rows of those.
Every device's share of a chunk is enqueued before any is read back, and
the next chunk before the previous one is harvested, so host-side
preparation overlaps device work.  The harvest gathers the blocks of all
processes in rank order, so chunk indices (``chunk_done``, checkpoints)
count global chunks.

There is no retry pass for non-converged samples (the JAX package's
``_retry_nonconverged``): every path of this port takes its chord
decisions per sample, so a sample's result does not depend on its
batch-mates and a failure-only batch repeats the failure bit for bit
(tests/test_torch_runner.py).  Hence resume (``start_chunk``) needs no
curve-start repair baseline (the JAX package's ``P_start``): a sample that
failed in a completed chunk is already NaN in the checkpointed
accumulator, and nothing would repair it.
"""
from __future__ import annotations

import contextlib
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
from ..ops.likelihood import (FLOAT_MIN, fastlog, interp_pl,
                              log_likelihood_from_terms)
from . import distributed
from .mesh import make_mesh

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


def _chunk_likelihood_interp(mat_nd, mag, dn, obs_times, obs_values, obs_mask,
                             sim_times, pl_scale, *, cfg: SolverConfig,
                             normalize: bool, log_pl: bool):
    """Chunk program for the INTERPOLATION fallback: a full-horizon solve
    recording PL, linear interpolation on the device onto each
    experiment's times, SSE likelihood (reference main loop:
    bayeslib.py:150-201).  Returns (P_chunk (num_exp, chunk),
    converged (chunk,)).

    ``obs_times``/``obs_values``/``obs_mask`` are (num_exp, M), padded to
    the longest experiment with time 0 and weight 0 (a valid interpolation
    point, zeroed before the sums); the mask holds the per-point weights
    (1/sigma^2 for the sigma-weighted SSE).  Observation times beyond the
    simulated horizon interpolate to NaN and poison that experiment's
    likelihood, the reference's griddata semantics, kept on purpose.
    """
    n0 = mat_nd[:, 0:1] + dn[None, :]
    p0 = mat_nd[:, 1:2] + dn[None, :]
    e0 = torch.zeros_like(n0)
    res = solve(mat_nd, n0, p0, e0, cfg, obs=None, record_pl=True)
    pl = res.pl * pl_scale
    if normalize:
        pl = pl / pl[:, 0:1]
    if log_pl:
        pl = fastlog(pl)
    ll = []
    for times, values, m in zip(obs_times, obs_values, obs_mask):
        pl_i = interp_pl(sim_times, pl, times)                   # (chunk, M)
        e = torch.where(m[None, :] > 0, pl_i - values[None, :], 0.0)
        sse = (m[None, :] * e * e).sum(-1)
        esum = (m[None, :] * e).sum(-1)
        ll.append(log_likelihood_from_terms(sse, esum, m.sum(), mag))
    ll = torch.where(res.converged[None, :], torch.stack(ll), torch.nan)
    return ll, res.converged


def on_device(dev: torch.device):
    """``dev`` as the current CUDA device inside the block (nothing on the
    CPU): launches and the current stream follow the current device."""
    return torch.cuda.device(dev) if dev.type == "cuda" else contextlib.nullcontext()


class Runner:
    """Chunked executor over a sample mesh: ``mesh`` (a tuple of devices,
    parallel/mesh.make_mesh), or ``device`` alone for a one-device mesh
    (``cuda`` unless told ``cpu``).  ``chunk``: samples per device per
    chunk; ``self.chunk`` is the global chunk over every process's
    devices, ``self.n_devices`` their number."""

    def __init__(self, chunk: int = 1024, device="cuda", mesh=None):
        self.mesh = make_mesh([device] if mesh is None else mesh)
        self.chunk_per_device = int(chunk)
        self.rank = distributed.process_index()
        # Cards this process shares with another (parallel/distributed.py).
        self.shared_cards = distributed.check_layout(self.mesh)
        self.n_devices = len(self.mesh) * distributed.process_count()
        self.chunk = self.chunk_per_device * self.n_devices
        self.timers = RunnerTimers()

    @staticmethod
    def _put(arr, dtype, device):
        return torch.as_tensor(np.ascontiguousarray(arr), dtype=dtype, device=device)

    def _per_device(self, make):
        """``make(device)`` for each device of the mesh, called once per
        distinct device (a curve's constants go to each device once)."""
        made = {}
        for dev in self.mesh:
            if dev not in made:
                with on_device(dev):
                    made[dev] = make(dev)
        return [made[dev] for dev in self.mesh]

    def _replicate(self, arr, dtype):
        return self._per_device(lambda dev: self._put(arr, dtype, dev))

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
                  out: Optional[np.ndarray] = None, obs_mask=None,
                  start_chunk: int = 0, sample_idx=None,
                  chunk_index_offset: int = 0):
        """Evaluate the log-likelihood of every sample in X for one
        excitation curve against observations on the simulation grid.

        Args:
          X: (n, 13) sample matrix in (V, nm, ns) units (mag_offset last).
          obs_log_values: (num_exp, sim.num_pl) log10 observed PL.
          chunk_done: callback(chunk_index, P_chunk) for checkpointing.
          out: optional (num_exp, n) accumulator to ADD likelihoods into
            (NaN marks non-converged samples and propagates).
          obs_mask: optional (num_exp, sim.num_pl) per-point weights.
          start_chunk: resume point; earlier chunks are left untouched in
            ``out`` (their contributions come from the checkpoint) and
            their samples count as converged (see the module docstring).
          sample_idx: optional global indices of the samples to run (the
            adaptive tau routing's subsets); chunk columns add into
            ``out[:, sample_idx[...]]``.
          chunk_index_offset: added to the chunk index given to
            ``chunk_done``, so that two passes over subsets of one curve
            share one checkpoint chunk sequence.

        Returns (out (num_exp, n), converged (n,)).
        """
        obs = self._replicate(obs_log_values, dtype)
        mask = ((None,) * len(self.mesh) if obs_mask is None
                else self._replicate(obs_mask, dtype))
        statics = dict(cfg=sim.solver_config(), normalize=normalize,
                       fast=sim.fast_phases)

        def chunk_fn(d, mat_c, mag_c, dn, log_scale):
            return _chunk_likelihood(mat_c, mag_c, dn, obs[d], log_scale, mask[d],
                                     **statics)
        return self._run(chunk_fn, X, sim, ini_par, len(obs_log_values), dtype,
                         progress, chunk_done, out, start_chunk, sample_idx,
                         chunk_index_offset)

    def run_curve_offgrid(self, X, sim: SimParams, ini_par, tables: OffGridTables,
                          schedule, normalize: bool = False, dtype=torch.float32,
                          progress: Optional[Callable[[int, int], None]] = None,
                          chunk_done: Optional[Callable[[int, np.ndarray], None]] = None,
                          out: Optional[np.ndarray] = None, start_chunk: int = 0):
        """Off-grid variant of :meth:`run_curve`: observation times are
        scored inside the solve from precomputed slot tables
        (models/offgrid.py); arguments and returns as :meth:`run_curve`.

        Args:
          tables: OffGridTables from models.offgrid.build_offgrid_tables
            (times mapped with this sim's dt and the given schedule).
          schedule: ((stride, num_fine_steps), ...) covering sim.T.
        """
        def put_tables(dev):
            return OffGridTables(
                phases=tuple(tuple(self._put(a, dtype, dev) for a in tbl)
                             for tbl in tables.phases),
                v0=self._put(tables.v0, dtype, dev), m0=self._put(tables.m0, dtype, dev),
                n_obs=self._put(tables.n_obs, dtype, dev))
        dev_tables = self._per_device(put_tables)
        statics = dict(cfg=sim.solver_config(), normalize=normalize,
                       schedule=tuple((int(s), int(c)) for s, c in schedule))

        def chunk_fn(d, mat_c, mag_c, dn, log_scale):
            return _chunk_likelihood_offgrid(mat_c, mag_c, dn, dev_tables[d],
                                             log_scale, **statics)
        return self._run(chunk_fn, X, sim, ini_par, len(tables.v0), dtype,
                         progress, chunk_done, out, start_chunk)

    def run_curve_interp(self, X, sim: SimParams, ini_par, obs_times, obs_values,
                         normalize: bool = False, log_pl: bool = True,
                         obs_weights=None, dtype=torch.float32,
                         progress: Optional[Callable[[int, int], None]] = None,
                         chunk_done: Optional[Callable[[int, np.ndarray], None]] = None,
                         out: Optional[np.ndarray] = None, start_chunk: int = 0):
        """Interpolation-fallback variant of :meth:`run_curve`: a solve over
        sim's whole horizon recording PL every sim.pl_stride steps,
        interpolated on the device onto each experiment's (possibly
        off-grid, possibly beyond-horizon) times, the reference's main loop
        (bayeslib.py:150-201); arguments and returns as :meth:`run_curve`.

        Args:
          obs_times/obs_values: per-experiment lists of 1-D arrays (ragged;
            padded here to the longest with time-0, weight-0 slots).
            Values are in the loaded observation scale (log10 when
            sim_flags.log_pl, matching ``log_pl``).
          obs_weights: optional per-experiment per-point weights (1/sigma^2
            for sim_flags.use_uncertainty); default 1.
        """
        num_exp = len(obs_times)
        M = max(len(t) for t in obs_times)
        times_p = np.zeros((num_exp, M))
        values_p = np.zeros((num_exp, M))
        mask_p = np.zeros((num_exp, M))
        for e in range(num_exp):
            m = len(obs_times[e])
            times_p[e, :m] = obs_times[e]
            values_p[e, :m] = obs_values[e]
            mask_p[e, :m] = 1.0 if obs_weights is None else obs_weights[e]

        # Times go to the device in the compute dtype, as the JAX package
        # places them: the interpolation's rounding is part of the result.
        def put_curve(dev):
            return (*(self._put(a, dtype, dev) for a in (times_p, values_p, mask_p,
                                                          sim.pl_times)),
                    torch.as_tensor(1.0 / (sim.dx ** 2 * sim.dt), dtype=dtype, device=dev))
        curve = self._per_device(put_curve)
        statics = dict(cfg=sim.solver_config(), normalize=normalize, log_pl=log_pl)

        def chunk_fn(d, mat_c, mag_c, dn, _log_scale):
            return _chunk_likelihood_interp(mat_c, mag_c, dn, *curve[d], **statics)
        return self._run(chunk_fn, X, sim, ini_par, num_exp, dtype, progress,
                         chunk_done, out, start_chunk)

    def _run(self, chunk_fn, X, sim: SimParams, ini_par, num_exp: int, dtype,
             progress, chunk_done, out, start_chunk=0, sample_idx=None,
             chunk_index_offset=0):
        """The chunk loop shared by every curve kind, from chunk
        ``start_chunk`` of the samples ``sample_idx`` (default all)."""
        X_sub = np.asarray(X) if sample_idx is None else np.asarray(X)[sample_idx]
        n = len(X_sub)
        mat_nd_all = physics.nondimensionalize(X_sub[:, :12], sim.dx, sim.dt)
        mag_all = X_sub[:, 12]
        dn = self._per_device(lambda dev: initial_excess_density(
            sim, ini_par, "points", dtype=dtype, device=dev))
        log_scale = pl_log_scale(sim)
        if out is None:
            out = np.zeros((num_exp, len(X)))
        conv = np.ones(n, dtype=bool)
        cpd = self.chunk_per_device
        first = self.rank * cpd * len(self.mesh)

        def dispatch(mat_c, mag_c):
            """Enqueue this process's rows of a padded chunk, one share per
            device, before anything is read back."""
            outs = []
            for d, dev in enumerate(self.mesh):
                rows = slice(first + d * cpd, first + (d + 1) * cpd)
                with on_device(dev):
                    outs.append(chunk_fn(d, self._put(mat_c[rows], dtype, dev),
                                         self._put(mag_c[rows], dtype, dev), dn[d],
                                         log_scale))
            return outs

        def harvest(ci, lo, size, outs):
            t0 = time.perf_counter()
            ll = np.concatenate([o[0].cpu().numpy() for o in outs], 1)  # device sync
            ok = np.concatenate([o[1].cpu().numpy() for o in outs])
            ll = distributed.allgather_to_host(ll, axis=1)     # rank order
            ok = distributed.allgather_to_host(ok)
            self.timers.solver_time += time.perf_counter() - t0
            t0 = time.perf_counter()
            cols = (slice(lo, lo + size) if sample_idx is None
                    else sample_idx[lo:lo + size])
            out[:, cols] += ll[:, :size]
            conv[lo:lo + size] = ok[:size]
            if chunk_done is not None:
                chunk_done(ci + chunk_index_offset, ll[:, :size])
            self.timers.misc_time += time.perf_counter() - t0

        # The next chunk is enqueued before the previous one is read back.
        n_chunks = -(-n // self.chunk)
        pending = None
        for ci in range(start_chunk, n_chunks):
            lo = ci * self.chunk
            hi = min(lo + self.chunk, n)
            if progress is not None:
                progress(ci, n_chunks)
            t0 = time.perf_counter()
            outs = dispatch(*self._pad(mat_nd_all[lo:hi], mag_all[lo:hi]))
            self.timers.solver_time += time.perf_counter() - t0
            if pending is not None:
                harvest(*pending)
            pending = (ci, lo, hi - lo, outs)
        if pending is not None:
            harvest(*pending)
        if sample_idx is not None:
            conv_all = np.ones(len(X), dtype=bool)
            conv_all[sample_idx] = conv
            conv = conv_all
        return out, conv
