"""End-to-end Bayesian inference pipeline.

The counterpart of the reference driver chain
``parallel_bayes_gpu.py -> bayeslib.bayes -> bayeslib.simulate``: load
observations and excitations, draw the sample grid, evaluate the
log-likelihood of every sample against every experiment and excitation
curve on the device, and export BAYRAN (X, P) arrays.  The likelihood is
fused into the solver: on the simulation grid directly (optionally with
the short-tau_n samples on a finer ladder), off it (log-spaced times)
through slot tables of dense-output weights; curves that cannot be fused
take the reference's interpolation of a recorded PL trace.  A run
checkpoints after every chunk and resumes from its checkpoint.  It runs
on every visible device (``device.n_devices`` caps them) and in every
process of a torchrun group (parallel/distributed.py); with
``device.profile_dir`` it writes a torch.profiler trace of ``simulate``.
"""
from __future__ import annotations

import contextlib
import dataclasses
import json
import logging
import os
import time
from typing import Optional

import numpy as np
import torch

from . import physics
from .config import InferenceConfig
from .models.driver import SimParams
from .parallel import distributed as dist
from .parallel.checkpoint import CheckpointManager, CheckpointState
from .parallel.mesh import make_mesh, synchronize
from .parallel.runner import Runner
from .utils import io as bio
from .utils import sampling, validate


def is_uniform_prefix(times, dt: float, threshold: float = 1e-9) -> bool:
    """True when ``times`` is exactly the uniform grid 0, dt, 2 dt, ...

    Observation curves on a dt-grid prefix of the simulation horizon can be
    scored by the fused likelihood on a shortened simulation; on matching
    grids the reference's linear interpolation returns the node values, so
    the shortened run is exactly equivalent (bayeslib.py:115, 182-191).
    """
    times = np.asarray(times)
    if len(times) < 2 or times[0] != 0.0:
        return False
    expected = dt * np.arange(len(times))
    return bool(np.max(np.abs(times - expected)) <= threshold * max(dt, 1.0))


def _with_horizon(sim: SimParams, T: int) -> SimParams:
    """``sim`` cut (or padded) to T steps of the same dt."""
    return SimParams(length=sim.length, time=T * sim.dt, L=sim.L, T=T,
                     pl_stride=1, tol_exp=sim.tol_exp, max_iters=sim.max_iters,
                     method=sim.method, predictor=sim.predictor,
                     step_tol=sim.step_tol,
                     fast_fine_steps=sim.fast_fine_steps,
                     fast_coarse_stride=sim.fast_coarse_stride,
                     fast_max_stride=sim.fast_max_stride,
                     fast_steps_per_phase=sim.fast_steps_per_phase)


def plan_fused_horizon(cfg: InferenceConfig, sim: SimParams, e_data, ic_num: int):
    """Decide the fused strategy for one curve.

    Returns (sim', obs_values (num_exp, n), obs_mask or None) when every
    experiment's curve for this ic is either the full simulation grid or a
    uniform dt-prefix of it; returns None otherwise (off-grid times).
    """
    num_exp = len(e_data)
    lengths = []
    for e in range(num_exp):
        times = np.asarray(e_data[e][0][ic_num])
        if len(times) > sim.T + 1 or not is_uniform_prefix(times, sim.dt):
            return None
        lengths.append(len(times))
    T_c = min(max(lengths) - 1, sim.T)
    sim_c = _with_horizon(sim, T_c)
    n = T_c + 1
    values = np.zeros((num_exp, n))
    weighted = cfg.sim_flags.use_uncertainty
    need_mask = weighted or any(l != n for l in lengths)
    mask = np.zeros((num_exp, n)) if need_mask else None
    for e in range(num_exp):
        v = np.asarray(e_data[e][1][ic_num])
        values[e, :len(v)] = v
        if mask is not None:
            mask[e, :len(v)] = (_sigma_weights(e_data[e][2][ic_num])
                                if weighted else 1.0)
    return sim_c, values, mask


def _sigma_weights(sigma):
    """Per-point weights 1/sigma^2 for the sigma-weighted SSE
    (sim_flags.use_uncertainty).  NaN or ~zero sigmas get weight 1 (the
    unweighted SSE point by point); sigma=inf gets weight 0."""
    s = np.asarray(sigma, dtype=float)
    w = np.ones_like(s)
    good = s > 1e-30          # False for NaN and for ~zero sigmas
    with np.errstate(divide="ignore"):
        w[good] = 1.0 / s[good] ** 2
    return w


def plan_offgrid(cfg: InferenceConfig, sim: SimParams, e_data, ic_num: int):
    """Build the off-grid fused plan for one curve: a shortened SimParams,
    the phase schedule and the slot tables (models/offgrid.py).

    Returns None when the curve cannot be fused off-grid: observation times
    beyond the simulated horizon or before 0, or tables that
    build_offgrid_tables refuses (a duplicate t=0 point).  Those curves take
    the interpolation fallback (Runner.run_curve_interp)."""
    from .models.offgrid import build_offgrid_tables

    num_exp = len(e_data)
    times = [np.asarray(e_data[e][0][ic_num], dtype=float)
             for e in range(num_exp)]
    values = [np.asarray(e_data[e][1][ic_num], dtype=float)
              for e in range(num_exp)]
    tmax = max((t.max() if len(t) else 0.0) for t in times)
    if tmax > sim.time * (1 + 1e-9):
        return None
    if any(np.any(t < 0) for t in times):
        return None
    # Shortened horizon covering the latest observation (as
    # plan_fused_horizon does).
    T_c = min(max(int(np.ceil(tmax / sim.dt - 1e-9)), 1), sim.T)
    sim_c = _with_horizon(sim, T_c)
    schedule = sim_c.fast_phases or ((1, T_c),)
    weights = ([_sigma_weights(e_data[e][2][ic_num]) for e in range(num_exp)]
               if cfg.sim_flags.use_uncertainty else None)
    try:
        tables = build_offgrid_tables(times, values, schedule, sim_c.dt,
                                      weights=weights)
    except ValueError as exc:
        logging.getLogger(__name__).warning(
            "off-grid fusion unavailable for curve %d (%s); falling back to "
            "the interpolated likelihood", ic_num, exc)
        return None
    return sim_c, schedule, tables


def _adaptive_split(cfg: InferenceConfig, sim_c: SimParams, X):
    """Adaptive tau routing (grid.adaptive_fine_tau): split the sample
    indices into (bulk, fine bucket) and build the fine bucket's SimParams
    (finer fine phase, tighter stride cap).  Returns None when routing is
    off, the curve is not on the ladder, or no sample falls in the bucket.

    The deep-window ladder error concentrates in the tau_n-bottom samples
    (coarse strides against a ~25 ns decay); a 512/16/32 ladder for them
    cut the JAX package's 10-decade max rms from 5.90e-4 to 1.18e-4
    (docs/PRECISION.md:322-333).  The split is a function of X and the
    config alone, so a resumed run replays it."""
    tau = cfg.grid.adaptive_fine_tau
    if not tau or sim_c.fast_phases is None:
        return None
    fine_sel = np.asarray(X)[:, 9] < float(tau)        # tau_n [ns]
    if not fine_sel.any():
        return None
    g = cfg.grid
    sim_f = dataclasses.replace(
        sim_c, pl_stride=1,
        fast_fine_steps=min(int(g.adaptive_fine_steps), sim_c.T // 2),
        fast_max_stride=min(int(g.adaptive_max_stride), sim_c.fast_max_stride))
    return np.where(~fine_sel)[0], np.where(fine_sel)[0], sim_f


def sim_params_for_curve(cfg: InferenceConfig, ic_num: int, num_curves: int) -> SimParams:
    g = cfg.grid
    return SimParams(length=g.thickness_for_curve(ic_num, num_curves),
                     time=g.time, L=g.num_nodes, T=g.num_steps,
                     pl_stride=g.pl_stride, tol_exp=g.tol_exp,
                     max_iters=g.max_iters, method=g.method,
                     predictor=g.predictor, step_tol=g.step_tol,
                     fast_fine_steps=g.fast_fine_steps,
                     fast_coarse_stride=g.fast_coarse_stride,
                     fast_max_stride=g.fast_max_stride,
                     fast_steps_per_phase=g.fast_steps_per_phase)


def resolve_dtype(name: str) -> torch.dtype:
    """``device.dtype``: float64 | float32 | default (float32)."""
    return torch.float64 if name == "float64" else torch.float32


def bucket_horizons(plans, logger=None):
    """Pad every fused curve plan to the run's longest horizon with
    zero-weight masks, so that all curves share one set of kernel shapes.
    The padded steps carry mask 0 and contribute nothing to the
    likelihood."""
    fused = [p for p in plans if p is not None]
    if len(fused) < 2:
        return plans
    T_shared = max(p[0].T for p in fused)
    out = []
    for p in plans:
        if p is None:
            out.append(None)
            continue
        sim_c, values, mask = p
        if sim_c.T == T_shared and mask is not None:
            out.append(p)
            continue
        n_old = values.shape[1]
        n_new = T_shared + 1
        v = np.zeros((values.shape[0], n_new))
        v[:, :n_old] = values
        m = np.zeros((values.shape[0], n_new))
        m[:, :n_old] = 1.0 if mask is None else mask
        if logger and sim_c.T != T_shared:
            logger.info("Bucketing curve horizon %d -> %d steps (masked)",
                        sim_c.T, T_shared)
        out.append((_with_horizon(sim_c, T_shared), v, m))
    return out


# What each solver method's solve goes through (models/solver.py,
# models/twophase.py, models/offgrid.py), for the run log.
SOLVER_ROUTES = {
    "fused_horizon_chord": "horizon kernel, chord Newton, one launch per phase",
    "fused_horizon": "horizon kernel, full Newton, one launch per phase",
    "coupled_newton_pallas": "per-step Newton kernel, one launch per BDF step",
    "coupled_newton": "coupled-Newton step loop, no kernel",
    "gauss_seidel": "Gauss-Seidel step loop (N then P by tridiagonal PCR, E "
                    "explicit), no kernel",
}
# The same for the interpolation fallback's solve(record_pl=True).
_RECORD_LAUNCH = "horizon kernel, full Newton recording PL, one launch over the whole horizon"
RECORD_ROUTES = dict(SOLVER_ROUTES, fused_horizon_chord=_RECORD_LAUNCH,
                     fused_horizon=_RECORD_LAUNCH)


def phase_route(method: str, phases, T: int) -> str:
    """The run log's words for how a curve is stepped: the stride ladder
    (``phases``, more than one; chord Newton under the strict chord
    profile) or exact fixed-dt stepping in one phase (chord Newton under
    the throughput profile, ops/horizon_kernel._chord_knobs)."""
    chord = method == "fused_horizon_chord"
    if phases is not None and len(phases) > 1:
        return (f"stride ladder of {len(phases)} phases"
                + (", strict chord profile" if chord else ""))
    return (f"exact fixed-dt: one phase of {T} steps"
            + (", throughput chord profile" if chord else ""))


def simulate(cfg: InferenceConfig, e_data, init_params, X, P, runner: Runner,
             logger=None, ckpt: Optional[CheckpointManager] = None, start=(0, 0)):
    """Evaluate likelihoods for all curves/experiments into P (in place).

    Mirrors the reference ``simulate`` control flow (bayeslib.py:83-205).
    ``start`` = (curve, chunk) resumes a checkpointed run: earlier curves
    and chunks are already in P.  Returns the (n,) convergence flags over
    the curves and chunks run.
    """
    if _traced_card and any(d.type == "cuda" for d in runner.mesh):
        raise RuntimeError(f"simulate: {TRACED_CARD_MESSAGE}")
    num_curves = len(init_params)
    num_exp = len(e_data)
    dtype = resolve_dtype(cfg.device.dtype)
    conv_all = np.ones(len(X), dtype=bool)
    start_curve, start_chunk = start

    plans = [plan_fused_horizon(cfg, sim_params_for_curve(cfg, ic, num_curves),
                                e_data, ic) for ic in range(num_curves)]
    if cfg.grid.bucket_horizons:
        plans = bucket_horizons(plans, logger)

    for ic_num in range(start_curve, num_curves):
        sim = sim_params_for_curve(cfg, ic_num, num_curves)
        if logger:
            logger.info("Curve #%d: thickness=%s, %d timesteps to %s ns",
                        ic_num, sim.length, sim.T, sim.time)
        plan = plans[ic_num]
        og = None
        if plan is None and cfg.grid.offgrid_fused:
            og = plan_offgrid(cfg, sim, e_data, ic_num)

        def _ckpt_chunk(ci, _ll, _ic=ic_num):
            if ckpt is not None:
                state = CheckpointState(
                    num_samples=len(X), num_exp=num_exp, num_curves=num_curves,
                    chunk=runner.chunk, curve_index=_ic, chunk_index=ci + 1)
                ckpt.save_progress(state, P)

        first_chunk = start_chunk if ic_num == start_curve else 0
        # On a mid-curve resume the snapshot on disk is this curve's already.
        if ckpt is not None and first_chunk == 0:
            ckpt.save_curve_start(P)
        common = dict(normalize=cfg.sim_flags.self_normalize, dtype=dtype,
                      chunk_done=_ckpt_chunk, out=P,
                      progress=(lambda ci, nc: logger.info(
                          "Curve #%d: chunk %d of %d", ic_num, ci, nc))
                      if logger else None)
        if plan is not None:
            sim_c, obs_vals, obs_mask = plan
            if logger:
                logger.info("Observation times on simulation grid: fused "
                            "likelihood (horizon %d steps%s); %s", sim_c.T,
                            ", masked" if obs_mask is not None else "",
                            phase_route(sim_c.method, sim_c.fast_phases, sim_c.T))
            routing = _adaptive_split(cfg, sim_c, X)
            args = (X, sim_c, init_params[ic_num], obs_vals)
            if routing is None:
                _, conv = runner.run_curve(*args, obs_mask=obs_mask,
                                           start_chunk=first_chunk, **common)
            else:
                # Adaptive tau routing: the short-tau_n bucket runs a finer
                # ladder; the two passes share one checkpoint chunk
                # sequence (bulk chunks first).
                bulk_idx, fine_idx, sim_f = routing
                if logger:
                    logger.info("Adaptive ladder: %d of %d samples in the "
                                "tau_n < %g ns fine bucket; %s", len(fine_idx),
                                len(X), cfg.grid.adaptive_fine_tau,
                                phase_route(sim_f.method, sim_f.fast_phases, sim_f.T))
                nb_chunks = -(-len(bulk_idx) // runner.chunk)
                conv = np.ones(len(X), dtype=bool)
                if len(bulk_idx) and first_chunk < nb_chunks:
                    conv &= runner.run_curve(
                        *args, obs_mask=obs_mask, start_chunk=first_chunk,
                        sample_idx=bulk_idx, **common)[1]
                conv &= runner.run_curve(
                    X, sim_f, init_params[ic_num], obs_vals, obs_mask=obs_mask,
                    start_chunk=max(0, first_chunk - nb_chunks),
                    sample_idx=fine_idx, chunk_index_offset=nb_chunks, **common)[1]
        elif og is not None:
            sim_c, schedule, tables = og
            if logger:
                logger.info("Observation times off-grid: fused slot-table "
                            "likelihood (horizon %d steps); %s", sim_c.T,
                            phase_route(sim_c.method, schedule, sim_c.T))
            _, conv = runner.run_curve_offgrid(X, sim_c, init_params[ic_num],
                                               tables, schedule,
                                               start_chunk=first_chunk, **common)
        else:
            # The interpolation fallback (the reference's main loop): the
            # full horizon of the config, PL every pl_stride steps.
            if logger:
                logger.info("Observation times off-grid: interpolating "
                            "likelihood (horizon %d steps, PL every %d); %s",
                            sim.T, sim.pl_stride, RECORD_ROUTES[sim.method])
            _, conv = runner.run_curve_interp(
                X, sim, init_params[ic_num],
                [np.asarray(e_data[e][0][ic_num]) for e in range(num_exp)],
                [np.asarray(e_data[e][1][ic_num]) for e in range(num_exp)],
                log_pl=cfg.sim_flags.log_pl,
                obs_weights=([_sigma_weights(e_data[e][2][ic_num])
                              for e in range(num_exp)]
                             if cfg.sim_flags.use_uncertainty else None),
                start_chunk=first_chunk, **common)
        conv_all &= conv
    P[:, ~conv_all] = np.nan
    return conv_all


def _launch_counts():
    """Launches of each kernel so far in this process (the wrappers'
    counters)."""
    from .ops import horizon_kernel, newton_kernel
    return dict(horizon_kernel.launches, newton_step=newton_kernel.launches)


# Set once this process has traced the card (profile_trace): a process that
# has traced the card launches kernels more slowly afterwards than after the
# same run untraced, and neither gc.collect with a synchronize nor kineto's
# CUPTI teardown (TEARDOWN_CUPTI=1) restores the rate, so simulate refuses
# to run there again.
_traced_card = False

TRACED_CARD_MESSAGE = (
    "this process has traced the card with torch.profiler ([device] profile_dir), "
    "and a process that traced the card launches kernels more slowly afterwards: "
    "run this simulate in a fresh process")


@contextlib.contextmanager
def profile_trace(profile_dir: str, mesh, logger=None):
    """A torch.profiler trace of the block, marked ``simulate``: CPU
    activities, and CUDA ones on the card, written as a Chrome trace to
    ``<profile_dir>/trace_rank<r>.json`` (r the process index).  On the
    card a trace that holds no kernel event raises and nothing is written:
    it would mean the device tracing (CUPTI) saw nothing.  A trace on the
    card marks the process, and a later :func:`simulate` on the card in it
    raises (chip_smoke.py's ``main_profile`` reads the launch rate around
    such a trace, tools/launch_rate.py)."""
    global _traced_card
    from torch.profiler import ProfilerActivity, profile, record_function
    on_card = mesh[0].type == "cuda"
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if on_card else [])
    try:
        with profile(activities=acts) as prof:
            with record_function("simulate"):
                yield
                synchronize(mesh)
    finally:
        _traced_card = _traced_card or on_card
    os.makedirs(profile_dir, exist_ok=True)
    path = os.path.join(profile_dir, f"trace_rank{dist.process_index()}.json")
    part = path + ".part"
    prof.export_chrome_trace(part)
    if on_card:
        with open(part) as f:
            events = json.load(f).get("traceEvents", [])
        if not any(e.get("cat") == "kernel" for e in events):
            os.remove(part)
            raise RuntimeError("profile_dir: the trace of simulate holds no CUDA "
                               "kernel event; the profiler did not trace the card")
    os.replace(part, path)
    if logger:
        logger.info("torch.profiler trace written to %s", path)


def bayes(cfg: InferenceConfig, logger: Optional[logging.Logger] = None,
          device="cuda"):
    """Top-level driver (reference: bayeslib.bayes, bayeslib.py:207-252).

    Runs on the visible devices of type ``device`` (``cuda`` unless the
    caller passes ``cpu``; ``validate.connect_to_devices``), in every
    process of the torchrun group when the environment names one: every
    process draws the same samples and ends with the merged P; only the
    primary reads and writes checkpoints and exports.  Returns (P, X,
    info): per-experiment log-likelihoods (num_exp, n), the sample matrix
    in user units (n, 13), and run diagnostics.
    """
    t_start = time.perf_counter()
    launches0 = _launch_counts()
    dist.maybe_initialize_from_env()
    primary = dist.is_primary()
    rng = np.random.default_rng(cfg.sim_flags.seed)

    init_params = bio.get_initpoints(cfg.paths.init_file, cfg.ic_flags.as_dict())
    e_data = bio.get_data(cfg.paths.observation_files, cfg.ic_flags.as_dict(),
                          cfg.sim_flags.as_dict(), logger=logger, rng=rng)

    num_exp = len(e_data)
    for exp in e_data:
        if len(init_params) != len(exp[0]):
            raise ValueError("Num. ICs mismatch num. datasets")
    validate.validate_ic(init_params, cfg.grid.num_nodes)
    validate.validate_ic_flags(cfg.ic_flags)
    validate.validate_params(physics.NUM_PARAMS, physics.UNIT_CONVERSIONS,
                             cfg.params.do_log, cfg.params.min_x, cfg.params.max_x)
    validate.validate_solver(cfg.grid.method, cfg.grid.predictor)
    mesh = make_mesh(validate.connect_to_devices(cfg.device, device))

    min_x, max_x = cfg.params.bounds_converted()
    ckpt = None
    start = (0, 0)
    resumed = False
    ckpt_chunk = None
    if cfg.checkpoint and cfg.paths.out_dirs and primary:
        ckpt = CheckpointManager(cfg.paths.out_dirs[0])
        if cfg.resume:
            loaded = ckpt.load()
            if loaded is not None:
                state, P, X, _ = loaded
                start = (state.curve_index, state.chunk_index)
                ckpt_chunk = state.chunk
                resumed = True
    if not resumed:
        _, P, X = sampling.make_grid(
            num_exp, min_x, max_x, cfg.params.do_log, cfg.sim_flags.as_dict(),
            rng=np.random.RandomState(cfg.sim_flags.seed))
    if cfg.checkpoint and cfg.paths.out_dirs and cfg.resume:
        # Only the primary reads the checkpoint; every process must resume
        # at its point with its P, or the per-chunk gathers pair different
        # chunks.  One process: the identity.
        start_a, P, X, resumed, ckpt_chunk = dist.broadcast_from_primary(
            (np.asarray(start), P, X, resumed, ckpt_chunk))
        start = (int(start_a[0]), int(start_a[1]))
    if resumed and logger:
        logger.info("Resuming at curve %d chunk %d", *start)
    if logger:
        logger.info("Initialized %d random samples", len(X))

    if logger:
        logger.info("Solver method %s: %s", cfg.grid.method,
                    SOLVER_ROUTES[cfg.grid.method])
    runner = Runner(chunk=cfg.device.chunk_per_device, mesh=mesh)
    if resumed and ckpt_chunk != runner.chunk:
        # The checkpoint's chunk index counts chunks of the global chunk
        # that wrote it; under another one it names other samples.
        raise ValueError(
            f"resume: the checkpoint was written at a global chunk of "
            f"{ckpt_chunk} samples, this run's is {runner.chunk} (chunk_per_device "
            f"{runner.chunk_per_device} x {runner.n_devices} devices over every "
            f"process); resume with a layout whose product is {ckpt_chunk}")
    if logger:
        logger.info("Process %d of %d: devices %s; %d devices in all, chunk %d",
                    dist.process_index(), dist.process_count(),
                    ", ".join(map(str, mesh)), runner.n_devices, runner.chunk)
    if runner.shared_cards and logger:
        logger.warning("Process %d shares card(s) %s with another process: each "
                       "process uses every card it sees; for one process per GPU "
                       "set CUDA_VISIBLE_DEVICES per process", dist.process_index(),
                       ", ".join(runner.shared_cards))
    if ckpt is not None and not resumed:
        ckpt.init(X, num_exp, len(init_params), runner.chunk)

    traced = (profile_trace(cfg.device.profile_dir, mesh, logger)
              if cfg.device.profile_dir else contextlib.nullcontext())
    with traced:
        simulate(cfg, e_data, init_params, X, P, runner, logger=logger, ckpt=ckpt,
                 start=start)
    synchronize(mesh)

    X_user = X / physics.UNIT_CONVERSIONS
    if primary:
        for i, out_dir in enumerate(cfg.paths.out_dirs):
            bio.export(out_dir, P[i], X_user, logger=logger)

    launches = {k: v - launches0.get(k, 0) for k, v in _launch_counts().items()}
    info = dict(runtime=time.perf_counter() - t_start, **runner.timers.as_dict(),
                num_samples=len(X), num_devices=runner.n_devices,
                device=",".join(map(str, mesh)),
                launches={k: v for k, v in launches.items() if v})
    if logger:
        logger.info("Total tEvol time: %.2fs; err_sq: %.2fs; misc: %.2fs",
                    runner.timers.solver_time, runner.timers.err_sq_time,
                    runner.timers.misc_time)
        logger.info("Bayesim took %.2fs", info["runtime"])
    return P, X_user, info
