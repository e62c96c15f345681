"""Time-shift alignment test for the gate's raw full-horizon rms.

The JAX package's tools/timeshift_demo.py on a torch device.  Claim under
test: the gate's raw full-horizon rms comes from steep-decay samples whose
float32 trajectory time-shifts by a fraction of a step against float64,
so aligning the exact curve by one fitted sub-step shift would collapse
the raw rms to the windowed level.  The JAX package's records refute it
(docs/PRECISION.md "The raw-rms tail, attributed"); the tool stays as the
instrument of that refutation and as a regression probe.

Method: the fast path never materializes PL, so the fit runs through the
fused likelihood production uses: one multiphase solve scores a grid of
time-shifted exact curves as ``num_exp`` observation rows (sse[shift,
sample] in one pass), and the best shift per sample is read off one
column.  rms at shift 0 reproduces the gate's raw number.  The solve is
``fused_horizon_chord`` (the CUDA kernel) on the card and
``coupled_newton`` on the CPU, as the JAX tool picks its method by backend.

The exact curves are the bundled float64 cache that the port's gate reads
(tools/accuracy_gate.bundled_cache: no ``_synthetic`` suffix), where the
JAX tool opens ``exact_T{T}_b{batch}_s{seed}_{profile}.npz``.

Usage (the bundled batch-8 synthetic cache, on the card):

    python -m bayesian_inference_trpl_tpu_torch.tools.timeshift_demo \\
        --profile synthetic --batch 8 --seed 0 [--device cpu]
"""
from __future__ import annotations

import argparse
import json

import numpy as np
import torch


def shifted_curves(lp, deltas):
    """(n_shifts, T+1) copies of log-PL curve ``lp`` resampled at
    t + delta (linear interpolation in log space, clamped at the ends —
    the first/last few points are inside the measurement window where
    the curve is flat-peaked, so clamping is inert at the rms level)."""
    T = lp.shape[-1] - 1
    t = np.arange(T + 1, dtype=np.float64)
    return np.stack([np.interp(t + d, t, lp) for d in deltas])


def main(argv=None):
    """Prints the JAX tool's lines and JSON; returns that JSON's dict with
    ``non_converged`` (pass 1), ``deltas`` (the shift grid, in steps) and
    ``rms_by_shift`` ({sample: rms at each shift}) added."""
    ap = argparse.ArgumentParser(
        description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--batch", type=int, default=32)
    ap.add_argument("--T", type=int, default=80000)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--profile", default="power_scan")
    ap.add_argument("--shift-max", type=float, default=2.0,
                    help="max |shift| in fine steps")
    ap.add_argument("--shift-points", type=int, default=41)
    ap.add_argument("--top", type=int, default=3,
                    help="demonstrate on the worst N raw-rms samples")
    ap.add_argument("--device", default="cuda",
                    help="torch device to run on (default: cuda)")
    args = ap.parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("timeshift_demo: CUDA requested but no CUDA device is "
                         "available (pass --device cpu to run on the CPU)")

    from .. import physics
    from ..models.driver import SimParams, pl_log_scale
    from ..models.solver import FusedObs, SolverConfig
    from ..models.twophase import geometric_schedule, solve_multiphase
    from . import accuracy_gate

    bundled = accuracy_gate.bundled_cache(args.T, args.batch, args.seed, args.profile)
    lp64 = accuracy_gate.load_exact(bundled, args.batch, args.T, args.seed, args.profile)

    T, batch = args.T, args.batch
    mat = accuracy_gate.sample_production_box(batch, args.seed)
    sim = SimParams(length=311.0, time=2000.0 * T / 80000, L=128, T=T)
    log_scale = pl_log_scale(sim)
    floor = -30.0 + float(np.asarray(log_scale))
    lp64 = np.maximum(lp64, floor)
    dtype = torch.float32
    mat32 = torch.as_tensor(physics.nondimensionalize(mat, sim.dx, sim.dt), dtype=dtype,
                            device=device)
    dn32 = accuracy_gate.excitation_profiles(args.profile, batch, sim, dtype, device=device)
    # The shipped fast configuration (the gate's default).
    schedule = geometric_schedule(T, 256, base_stride=16,
                                  coarse_steps_per_phase=512, max_stride=64)
    cfg32 = SolverConfig(num_steps=T, pl_stride=1, tol=1e-4, max_iters=8,
                         method=("fused_horizon_chord" if device.type == "cuda"
                                 else "coupled_newton"),
                         predictor="quadratic", step_tol=1e-6)

    def score(obs_values):
        obs = FusedObs(values=torch.as_tensor(obs_values, dtype=dtype, device=device),
                       log_scale=log_scale, min_val=1e-30)
        n0 = mat32[:, 0:1] + dn32
        p0 = mat32[:, 1:2] + dn32
        r = solve_multiphase(mat32, n0, p0, torch.zeros_like(n0), cfg32, obs, schedule)
        return r.sse.cpu().numpy(), r.converged.cpu().numpy()

    # Pass 1: the gate itself — per-sample raw rms, worst samples.
    sse, conv = score(lp64)
    rms_full = np.sqrt(np.diagonal(sse) / (T + 1))
    order = np.argsort(-rms_full)
    non_converged = int((~conv).sum())
    print(f"raw full-horizon rms: max {rms_full.max():.3e} "
          f"(sample {order[0]}), median {np.median(rms_full):.3e}; "
          f"non-converged {non_converged}")

    deltas = np.linspace(-args.shift_max, args.shift_max, args.shift_points)
    results, rms_by_shift = [], {}
    for i in order[:args.top]:
        shifts = shifted_curves(lp64[i], deltas)       # (n_shifts, T+1)
        sse_s, _ = score(shifts)
        rms_s = np.sqrt(sse_s[:, i] / (T + 1))
        rms_by_shift[int(i)] = rms_s.tolist()
        k = int(np.argmin(rms_s))
        results.append(dict(
            sample=int(i), raw_rms=float(rms_full[i]),
            best_shift_steps=float(deltas[k]),
            best_shift_ps=float(deltas[k] * sim.dt * 1000),
            aligned_rms=float(rms_s[k]),
            collapse_factor=float(rms_full[i] / rms_s[k]),
        ))
        print(f"sample {i}: raw rms {rms_full[i]:.3e} -> aligned "
              f"{rms_s[k]:.3e} at shift {deltas[k]:+.2f} steps "
              f"({deltas[k] * sim.dt * 1e3:+.1f} ps)  "
              f"[{rms_full[i] / rms_s[k]:.0f}x collapse]")
    report = dict(batch=batch, T=T, profile=args.profile, worst=results)
    print(json.dumps(report))
    return dict(report, non_converged=non_converged, deltas=deltas.tolist(),
                rms_by_shift=rms_by_shift)


if __name__ == "__main__":
    main()
