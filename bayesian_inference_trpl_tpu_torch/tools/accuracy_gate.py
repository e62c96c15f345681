"""Production-scale accuracy gate: shipped fast config vs exact f64 path.

Compares the SHIPPED fast solver configuration -- float32, multi-phase
stride ladder (fine 256, strides 16->32->64), quadratic predictor --
against float64 single-phase stepping on the SAME discretization (the
80,000-step dt = 25 ps grid), over a batch drawn from the production
sampling box.  The counterpart of the JAX package's
``bayesian_inference_trpl_tpu/tools/accuracy_gate.py``: the same flags,
defaults, thresholds, report, PASS/FAIL lines and exit code, plus
``--device cuda|cpu`` (default ``cuda``).

The metric is the rms deviation of log10-PL at the fine observation
times, obtained the way production consumes it: the exact curves are fed
to the fast solver as fused observations, so diag(sse)/n is the squared
rms deviation per sample; the fast path never materializes a PL trace.

The GATED rms is windowed to each curve's measurable region (points within
7 decades of its peak, MEAS_DEPTH_DECADES) and to a deep window
(--meas-decades, default 10); the raw full-horizon rms is reported as
rms_log10_pl_max_full.  Gate: max-over-samples rms <= --tol (7-decade
window) and <= --tol10 (deep window), and no non-converged sample.  Exits
1 on failure.

The exact curves come from the JAX package's bundled float64 caches
(EXACT_CACHE_DIR, data files only; --exact-file overrides), or are
computed here on --device in float64 (coupled Newton, tol 1e-7) when no
cache matches.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

_REPO = Path(__file__).resolve().parents[2]
# The JAX package's bundled exact caches, read as data:
# exact_T{T}_b{batch}_s{seed}[_{profile}].npz, (batch, T + 1) float64 ``lp64``.
EXACT_CACHE_DIR = _REPO / "bayesian_inference_trpl_tpu" / "tools" / "exact_cache"
# The measured Example-Data excitations are examples/power_scan.toml's
# [paths] init_file (the file the JAX tool's POWER_SCAN_EXC names).
POWER_SCAN_CONFIG = _REPO / "examples" / "power_scan.toml"

# Hard-gate window depth: one decade deeper than the widest dynamic range
# in the bundled reference observations (6.9 decades, Highbacksurf
# Power_scan curve 2) -- i.e. everything an instrument in this problem
# domain can see, with a decade to spare.
MEAS_DEPTH_DECADES = 7.0


def sample_production_box(n, seed=0):
    from .. import physics
    rng = np.random.default_rng(seed)
    minx = np.array([1e8, 1e14, 0.0, 0.0, 1e-11, 0.1, 0.1, 1e-30, 1e-30,
                     1.0, 1.0, 0.1])
    maxx = np.array([1e8, 1e16, 50.0, 50.0, 1e-9, 100.0, 100.0, 1e-28,
                     1e-28, 1000.0, 2000.0, 0.1])
    do_log = np.array([0, 1, 0, 0, 1, 1, 1, 1, 1, 0, 0, 0], dtype=bool)
    u = rng.uniform(size=(n, 12))
    with np.errstate(divide="ignore"):
        lo = np.log10(np.where(minx > 0, minx, 1))
        hi = np.log10(np.where(maxx > 0, maxx, 1))
    x = np.where(do_log, 10 ** (lo + u * (hi - lo)), minx + u * (maxx - minx))
    return x * physics.UNIT_CONVERSIONS[:12]


def power_scan_excitations() -> str:
    """Path of the measured Power_scan excitation CSV."""
    import tomllib
    with open(POWER_SCAN_CONFIG, "rb") as f:
        return tomllib.load(f)["paths"]["init_file"]


def excitation_profiles(profile: str, batch: int, sim, dtype,
                        row_offset: int = 0, device="cuda") -> torch.Tensor:
    """(batch, L) nondimensional initial excess densities.

    ``synthetic``: the smooth a*exp(-x/l) profile (every sample alike).
    ``power_scan``: the MEASURED Example-Data excitation profiles, cycled
    over the batch; ``row_offset`` shifts the cycle for row-sharded exact
    curves (the profile of global row i does not depend on the shard)."""
    from ..models.driver import initial_excess_density

    if profile == "synthetic":
        dn = initial_excess_density(sim, (1e18 / 1e7 ** 3, 100.0), "exp",
                                    dtype=dtype, device=device)
        return dn[None, :].expand(batch, sim.L)
    if profile == "power_scan":
        from ..utils.io import get_initpoints
        profiles = get_initpoints(power_scan_excitations(), {})
        rows = [initial_excess_density(
                    sim, profiles[(row_offset + i) % len(profiles)],
                    "points", dtype=dtype, device=device)
                for i in range(batch)]
        return torch.stack(rows)
    raise ValueError(f"unknown profile {profile!r}")


def exact_curves(batch, T, seed=0, tol_exp_exact=7.0, profile="synthetic",
                 rows=None, device="cuda"):
    """Exact reference: float64 single-phase full-horizon log10-PL curves
    (batch, T + 1), coupled Newton to tol 1e-7, on ``device``.

    ``rows=(lo, hi)`` computes only that slice of the batch's sample matrix
    (PCG64 draws are row-prefix-stable, so the (batch, 12) box is the same
    however it is sharded)."""
    from .. import physics
    from ..models.driver import SimParams, pl_log_scale
    from ..models.solver import SolverConfig, solve

    mat = sample_production_box(batch, seed)
    row_offset = 0
    if rows is not None:
        row_offset, hi = rows
        mat = mat[row_offset:hi]
        batch = mat.shape[0]
    sim = SimParams(length=311.0, time=2000.0 * T / 80000, L=128, T=T)
    dn64 = excitation_profiles(profile, batch, sim, torch.float64,
                               row_offset=row_offset, device=device)
    mat64 = torch.as_tensor(physics.nondimensionalize(mat, sim.dx, sim.dt),
                            dtype=torch.float64, device=device)
    cfg64 = SolverConfig(num_steps=T, pl_stride=1, tol=10.0 ** -tol_exp_exact,
                         max_iters=100, method="coupled_newton")
    n0 = mat64[:, 0:1] + dn64
    p0 = mat64[:, 1:2] + dn64
    r64 = solve(mat64, n0, p0, torch.zeros_like(n0), cfg64, record_pl=True)
    if not bool(r64.converged.all()):
        raise RuntimeError("exact path failed to converge")
    pl64 = r64.pl.cpu().numpy()
    return np.log10(np.maximum(pl64, 1e-300)) + pl_log_scale(sim)


def run_gate(lp64, batch=64, T=80000, fine_steps=256, base_stride=16,
             max_stride=64, steps_per_phase=512,
             tol_exp_fast=4.0, seed=0, verbose=True, t_exact=None,
             profile="synthetic", method=None, predictor="quadratic",
             meas_decades=10.0, adaptive_fine_tau=None, device="cuda"):
    """Score the shipped fast float32 path on ``device`` against
    precomputed exact curves ``lp64`` (from :func:`exact_curves`, same
    batch/T/seed).

    * ``rms_log10_pl_max_meas``: rms over points within MEAS_DEPTH_DECADES
      (7) of each curve's peak; the HARD gate (default 5e-4).
    * ``rms_log10_pl_max``: rms within ``meas_decades`` (default 10) of the
      peak, gated at 1e-3 (short-tau samples carry a ~1.3e-3 coarse-stride
      ladder discretization error 7-12 decades below the peak, the same in
      a float64 ladder run: a schedule property, docs/PRECISION.md).
    * ``rms_log10_pl_max_full``: the raw full-horizon rms, reported only.

    Both sides are clamped at the float32 model floor (nondimensional PL
    1e-30) before differencing, as the reference clamps both sides before
    its SSE.  ``method`` None takes ``fused_horizon_chord`` (the CUDA
    kernel) on the card and ``coupled_newton`` (the step loop) on the CPU.

    ``adaptive_fine_tau``: the samples with tau_n below it also run the
    finer ladder of the pipeline's adaptive routing (grid.adaptive_fine_tau:
    fine phase min(512, T // 2), stride cap min(32, max_stride)), and their
    rms rows and convergence come from it.
    """
    from .. import physics
    from ..models.driver import SimParams, pl_log_scale
    from ..models.solver import FusedObs, SolverConfig
    from ..models.twophase import geometric_schedule, solve_multiphase

    device = torch.device(device)
    mat = sample_production_box(batch, seed)
    sim = SimParams(length=311.0, time=2000.0 * T / 80000, L=128, T=T)
    log_scale = pl_log_scale(sim)
    mat64 = physics.nondimensionalize(mat, sim.dx, sim.dt)

    floor = -30.0 + float(log_scale)
    lp64 = np.maximum(lp64, floor)
    dtype = torch.float32
    mat32 = torch.as_tensor(np.asarray(mat64), dtype=dtype, device=device)
    dn32 = excitation_profiles(profile, batch, sim, dtype, device=device)
    values = torch.as_tensor(lp64, dtype=dtype, device=device)
    schedule = geometric_schedule(T, fine_steps, base_stride=base_stride,
                                  coarse_steps_per_phase=steps_per_phase,
                                  max_stride=max_stride)
    if method is None:
        method = ("fused_horizon_chord" if device.type == "cuda"
                  else "coupled_newton")
    cfg32 = SolverConfig(num_steps=T, pl_stride=1, tol=10.0 ** -tol_exp_fast,
                         max_iters=8, method=method, predictor=predictor,
                         step_tol=1e-6)

    # Measurement windows: per curve, points within N decades of the peak
    # carry weight 1, the rest weight 0 (FusedObs.mask).
    win = (lp64 >= lp64.max(axis=1, keepdims=True) - float(meas_decades))
    win_m = (lp64 >= lp64.max(axis=1, keepdims=True) - MEAS_DEPTH_DECADES)

    n_win = win.sum(axis=1)
    n_win_m = win_m.sum(axis=1)

    def run_fast(mask, sched):
        """Each sample's exact curve is one observation row (num_exp =
        batch); returns sse (batch, batch) and the convergence flags."""
        obs = FusedObs(values=values, log_scale=log_scale, min_val=1e-30,
                       mask=None if mask is None else
                       torch.as_tensor(mask, dtype=dtype, device=device))
        n0 = mat32[:, 0:1] + dn32
        p0 = mat32[:, 1:2] + dn32
        r = solve_multiphase(mat32, n0, p0, torch.zeros_like(n0), cfg32, obs,
                             sched)
        return r.sse.cpu().numpy(), r.converged.cpu().numpy()

    def rms_set(sched):
        """(full-horizon, deep-window, measurable-window) rms per sample,
        the convergence flags and the seconds of the first (full-horizon)
        solve, on the ladder ``sched``."""
        t0 = time.perf_counter()
        sse, conv = run_fast(None, sched)
        secs = time.perf_counter() - t0
        sse_w, _ = run_fast(win, sched)
        sse_m, _ = run_fast(win_m, sched)
        return (np.sqrt(np.diagonal(sse) / (T + 1)),
                np.sqrt(np.diagonal(sse_w) / n_win),
                np.sqrt(np.diagonal(sse_m) / n_win_m), conv, secs)

    # fast_seconds times the shipped ladder's first (full-horizon) solve
    # only; the JAX tool times all three (ROADMAP C2).
    rms_full, rms_w, rms_m, conv, t_fast = rms_set(schedule)
    n_fine_bucket = 0
    if adaptive_fine_tau:
        sched_fine = geometric_schedule(
            T, min(512, T // 2), base_stride=base_stride,
            coarse_steps_per_phase=steps_per_phase,
            max_stride=min(32, max_stride))
        sel = mat[:, 9] < float(adaptive_fine_tau)      # tau_n [ns]
        n_fine_bucket = int(sel.sum())
        if n_fine_bucket:
            f_full, f_w, f_m, f_conv, _ = rms_set(sched_fine)
            rms_full = np.where(sel, f_full, rms_full)
            rms_w = np.where(sel, f_w, rms_w)
            rms_m = np.where(sel, f_m, rms_m)
            conv = np.where(sel, f_conv, conv)
    report = dict(
        batch=batch, T=T, profile=profile, seed=seed,
        schedule=[list(p) for p in schedule],
        adaptive_fine_tau=adaptive_fine_tau,
        adaptive_fine_bucket=n_fine_bucket,
        rms_log10_pl_max_meas=float(np.nanmax(rms_m)),
        rms_log10_pl_max=float(np.nanmax(rms_w)),
        rms_log10_pl_mean=float(np.nanmean(rms_w)),
        rms_log10_pl_max_full=float(np.nanmax(rms_full)),
        meas_depth_decades=float(MEAS_DEPTH_DECADES),
        meas_decades=float(meas_decades),
        win_points_min=int(n_win.min()),
        non_converged=int((~conv).sum()),
        exact_seconds=None if t_exact is None else round(t_exact, 2),
        fast_seconds=round(t_fast, 2),
        backend=device.type, method=method,
        device_name=(torch.cuda.get_device_name(device)
                     if device.type == "cuda" else "cpu"),
    )
    if verbose:
        print(json.dumps(report))
    return report


def load_exact(path, batch, T, seed=None, profile=None):
    """Load an exact-curve cache and VALIDATE it against the gate's
    (batch, T): a shard, a truncated assembly or a wrong-profile file fails
    loudly instead of gating against the wrong rows.  .npz files may also
    carry row/seed/profile metadata."""
    d = np.load(path, allow_pickle=False)
    if isinstance(d, np.lib.npyio.NpzFile):
        lp64 = d["lp64"]
        if "rows" in d.files:
            rows = tuple(int(v) for v in np.asarray(d["rows"]))
            if rows != (0, batch):
                raise SystemExit(
                    f"{path} holds rows {rows[0]}:{rows[1]}, not the full "
                    f"0:{batch} batch — assemble shards before gating")
        for key, want in (("seed", seed), ("profile", profile)):
            if want is not None and key in d.files:
                have = np.asarray(d[key]).item()
                if str(have) != str(want):
                    raise SystemExit(
                        f"{path}: {key}={have!r} does not match the "
                        f"requested {key}={want!r}")
    else:
        lp64 = d
    if lp64.shape != (batch, T + 1):
        raise SystemExit(
            f"{path}: exact curves shape {lp64.shape} != expected "
            f"({batch}, {T + 1}) — wrong --batch/--T for this cache?")
    return lp64


def bundled_cache(T, batch, seed, profile) -> Path:
    """The bundled exact cache's path for these arguments."""
    tag = "" if profile == "synthetic" else f"_{profile}"
    return EXACT_CACHE_DIR / f"exact_T{T}_b{batch}_s{seed}{tag}.npz"


def main(argv=None):
    ap = argparse.ArgumentParser(
        description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--batch", type=int, default=32,
                    help="samples (default matches the bundled batch-32 "
                         "measured-profile exact cache)")
    ap.add_argument("--T", type=int, default=80000)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--tol", type=float, default=5e-4,
                    help="max allowed rms log10-PL deviation within the "
                         "measurable window (7 decades of peak) [decades]")
    ap.add_argument("--tol10", type=float, default=1e-3,
                    help="max allowed rms within the deep --meas-decades "
                         "window (short-tau samples carry ~1.3e-3 ladder "
                         "discretization error at 7-12 decades below "
                         "peak; f64-identical — docs/PRECISION.md)")
    ap.add_argument("--exact-file", default=None,
                    help="cache file for the exact f64 curves (.npy or .npz); "
                         "reused if it exists, else computed and saved "
                         "(default: the bundled cache in EXACT_CACHE_DIR)")
    ap.add_argument("--exact-only", action="store_true",
                    help="compute exact curves and exit")
    ap.add_argument("--rows", default=None,
                    help="with --exact-only: 'lo:hi' row slice of the "
                         "batch to compute (shardable cache generation)")
    ap.add_argument("--method", default=None,
                    help="fast-path solver method override (default: "
                         "fused_horizon_chord on cuda, coupled_newton on cpu)")
    ap.add_argument("--predictor", default="quadratic",
                    help="Newton predictor override (previous | linear | "
                         "quadratic | geometric)")
    ap.add_argument("--profile", default="power_scan",
                    choices=["synthetic", "power_scan"],
                    help="excitation profiles: the MEASURED Example-Data "
                         "Power_scan curves (default) or smooth synthetic")
    ap.add_argument("--fine-steps", type=int, default=256,
                    help="fast-ladder fine-phase length (schedule sweeps)")
    ap.add_argument("--base-stride", type=int, default=16)
    ap.add_argument("--max-stride", type=int, default=64)
    ap.add_argument("--steps-per-phase", type=int, default=512)
    ap.add_argument("--adaptive-fine-tau", type=float, default=None,
                    help="route samples with tau_n below this [ns] through "
                         "the finer 512/16/32 ladder (the pipeline's "
                         "grid.adaptive_fine_tau)")
    ap.add_argument("--meas-decades", type=float, default=10.0,
                    help="measurement window for the gated rms: points "
                         "within this many decades of each curve's peak")
    ap.add_argument("--device", default="cuda",
                    help="torch device to run on (default: cuda)")
    args = ap.parse_args(argv)
    if torch.device(args.device).type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("accuracy_gate: CUDA requested but no CUDA device is "
                         "available (pass --device cpu to run on the CPU)")

    tag = "" if args.profile == "synthetic" else f"_{args.profile}"
    default_file = os.path.join(tempfile.gettempdir(),
                                f"trpl_exact_{args.T}_{args.batch}_{args.seed}{tag}")
    if args.exact_only:
        rows = None
        if args.rows:
            lo, hi = (int(v) for v in args.rows.split(":"))
            rows = (lo, hi)
        if args.exact_file is None:
            rtag = f"_rows_{rows[0]}_{rows[1]}" if rows else ""
            args.exact_file = f"{default_file}{rtag}.npy"
        lp64 = exact_curves(args.batch, args.T, args.seed,
                            profile=args.profile, rows=rows, device=args.device)
        if rows is not None:
            # Shards carry their own row identity, so a mislabeled or
            # partly assembled file cannot be scored as the wrong rows.
            path = args.exact_file
            if not path.endswith(".npz"):
                path += ".npz"
            np.savez(path, lp64=lp64, rows=np.asarray(rows),
                     batch=args.batch, T=args.T, seed=args.seed,
                     profile=args.profile)
            print(f"wrote exact rows {rows[0]}:{rows[1]} to {path}")
            return
        np.save(args.exact_file, lp64)
        print(f"wrote exact curves to {args.exact_file}")
        return

    t_exact = None
    bundled = bundled_cache(args.T, args.batch, args.seed, args.profile)
    if args.exact_file and os.path.exists(args.exact_file):
        lp64 = load_exact(args.exact_file, args.batch, args.T, args.seed,
                          args.profile)
    elif args.exact_file is None and bundled.exists():
        lp64 = load_exact(bundled, args.batch, args.T, args.seed, args.profile)
    else:
        exact_file = args.exact_file or f"{default_file}.npy"
        t0 = time.perf_counter()
        np.save(exact_file, exact_curves(args.batch, args.T, args.seed,
                                         profile=args.profile,
                                         device=args.device))
        t_exact = time.perf_counter() - t0
        lp64 = load_exact(exact_file, args.batch, args.T, args.seed,
                          args.profile)

    report = run_gate(lp64, batch=args.batch, T=args.T, seed=args.seed,
                      fine_steps=args.fine_steps,
                      base_stride=args.base_stride,
                      max_stride=args.max_stride,
                      steps_per_phase=args.steps_per_phase,
                      t_exact=t_exact, profile=args.profile,
                      method=args.method, predictor=args.predictor,
                      meas_decades=args.meas_decades,
                      adaptive_fine_tau=args.adaptive_fine_tau, device=args.device)
    ok = (report["rms_log10_pl_max_meas"] <= args.tol
          and report["rms_log10_pl_max"] <= args.tol10
          and report["non_converged"] == 0)
    if not ok:
        print(f"FAIL: measurable-window rms "
              f"{report['rms_log10_pl_max_meas']:.3e} > tol {args.tol:.3e}, "
              f"or deep-window rms {report['rms_log10_pl_max']:.3e} > "
              f"{args.tol10:.3e}, or {report['non_converged']} "
              f"non-converged")
        sys.exit(1)
    print(f"PASS: max rms log10-PL {report['rms_log10_pl_max_meas']:.3e} "
          f"(7-decade window) <= {args.tol:.3e}; "
          f"{report['rms_log10_pl_max']:.3e} (deep window) <= "
          f"{args.tol10:.3e}")


if __name__ == "__main__":
    main()
