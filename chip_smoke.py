"""Smoke run of the PyTorch port on one NVIDIA GPU (H100).

    python3 chip_smoke.py [--num-points N]

Phases, each printed on its own line with its seconds:

1. build   -- nvcc builds csrc/horizon_kernel.cu into build/ (plain C
              interface, loaded with ctypes).
2. compare -- the horizon kernel against its plain PyTorch version
              (group=1), on the card, on the same inputs, at main-path
              shapes: a seeded sample box, one curve, the full power_scan
              ladder (256 fine steps, then strides 16/32/64 x 512).
              float64 at 64 samples: conv, its and fulls equal, sse/esum
              within 1e-9 relative.  float32 at 1024 samples (the chunk):
              see F32_* below.  The kernel and plain times at chunk 1024
              come from this phase (CUDA events).
3. main    -- ``python -m bayesian_inference_trpl_tpu_torch.run`` on a TOML
              written into a temp dir: power_scan's [grid], [params] and
              [device], synthetic data for 3 excitation curves, a reduced
              num_points.  Counts every kernel launch and checks the output.
4. compare_offgrid -- as 2, for the kernel's off-grid mode: the same
              ladder scored at ~400 log-spaced observation times (slot
              tables, models/offgrid.py), every phase one off-grid launch.
5. main_offgrid -- as 3, with the observations at those log-spaced times
              (examples/power_scan_offgrid.toml's configuration).

Then one JSON line describing every kernel, the card's name and power
limit, and as the last line {"ok": true, "device": {...}}.  Any failure
raises: the script exits non-zero and prints no result.  It needs CUDA and
the package beside it; it writes only to a temp dir and under build/.
"""
from __future__ import annotations

import argparse
import functools
import json
import logging
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

# Per-cell operation counts of the horizon kernel, from csrc/horizon_kernel.cu
# (adds, multiplies, divides and compares of the per-cell work; per-sample
# scalars such as the surface terms are not counted):
#   per step: BDF history sums 27, quadratic predictor 16, E update 12, PL 2,
#             plus the cheap residual check 90;
#   per executed Newton iteration: chord apply 110 (6 sweeps of 16 + final
#             pair 14), positivity-clamped update and step-size maxima 18,
#             residual re-check 90;
#   per Jacobian refresh: Jacobian blocks 70, PCR reduce 600 (6 sweeps of 96
#             + final pair 22).
OPS_STEP = 27 + 16 + 12 + 2 + 90
OPS_ITER = 110 + 18 + 90
OPS_FULL = 70 + 600
# Off-grid slot scoring, per slot and step (not per cell): window sum 7,
# error 1, weighted sums 5.
OPS_SLOT = 13
PEAK_FP32 = 67e12        # H100 SXM, FP32 outside the tensor cores
HBM_BYTES_PER_S = 3.35e12

F64_RTOL = 1e-9
# float32: the kernel and the plain version run the same arithmetic in a
# different summation order (block reductions vs torch's), so residual
# norms differ in the last bits and a chord decision (skip / refresh /
# accept) can flip at a threshold; a flipped sample then takes another,
# equally valid, path to its tolerance.  Required: conv equal on >= 99% of
# the samples, and sse within F32_RTOL relative on >= 99% of the samples
# converged in both.
F32_RTOL = 1e-3
F32_MIN_SHARE = 0.99

POWER_SCAN = dict(thickness=311.0, time=2000.0, L=128, T=80000, tol_exp=4.0,
                  max_iters=8, step_tol=1e-6, fast_fine_steps=256,
                  fast_coarse_stride=16, fast_max_stride=64,
                  fast_steps_per_phase=512)
MIN_X = [1e8, 1e14, 0.0, 0.0, 1e-11, 0.1, 0.1, 1e-30, 1e-30, 1.0, 1.0, 0.1, 0.0]
MAX_X = [1e8, 1e16, 50.0, 50.0, 1e-9, 100.0, 100.0, 1e-28, 1e-28, 1000.0, 2000.0, 0.1, 0.0]
DO_LOG = [1, 1, 0, 0, 1, 1, 1, 1, 1, 0, 0, 1, 0]
# Off-grid observations: t = 0 plus this many log-spaced times from
# 0.7 dt to the horizon (examples/power_scan_offgrid.toml: ~400 per curve).
OFFGRID_POINTS = 400


def phase(name, t0, msg):
    print(f"phase {name}: {time.perf_counter() - t0:.2f} s  {msg}", flush=True)


def excitation_profiles(L, thickness, num=3):
    """Exp-shaped excitation densities [nm^-3] (as tests/test_pipeline.py)."""
    xg = (np.arange(L) + 0.5) * (thickness / L)
    return [(0.5 + c) * 1e18 / 1e7 ** 3 * np.exp(-xg / 100.0) for c in range(num)]


def decay_curves(T, time_ns, num, seed, t=None):
    """Seeded closed-form bi-exponential PL decays with 2% noise, in
    [nm^-2 ns^-1], at the times ``t`` [ns]; by default on the simulation
    grid t = k dt, k = 0..T."""
    rng = np.random.default_rng(seed)
    if t is None:
        t = np.arange(T + 1) * (time_ns / T)
    out = []
    for c in range(num):
        amp = 1e-4 * (1.0 + c)
        pl = amp * (0.6 * np.exp(-t / (15.0 + 5 * c)) + 0.4 * np.exp(-t / 400.0))
        out.append(pl * (1.0 + 0.02 * rng.standard_normal(t.size)))
    return t, out


def offgrid_times(T, time_ns):
    """t = 0 plus OFFGRID_POINTS log-spaced times [ns] from 0.7 dt to 0.4 dt
    before the horizon, as written to the CSV (6 decimals); none on the dt
    grid."""
    dt = time_ns / T
    t = np.concatenate([[0.0], np.geomspace(0.7 * dt, time_ns - 0.4 * dt,
                                            OFFGRID_POINTS)])
    t = np.round(t, 6)
    on_grid = np.abs(t[1:] / dt - np.round(t[1:] / dt)) < 1e-6
    if on_grid.any():
        raise AssertionError(f"{int(on_grid.sum())} off-grid times land on the grid")
    return t


def card():
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 else "nvidia-smi failed"


class Recorder:
    """Wraps a horizon-kernel entry; keeps each call's inputs, outputs and
    synchronised wall time."""

    def __init__(self, fn):
        self.fn = fn
        self.calls = []

    def __call__(self, *args):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = self.fn(*args)
        torch.cuda.synchronize()
        self.calls.append((args, out, time.perf_counter() - t0))
        return out


def ladder_inputs(num, dtype, seed, offgrid=False):
    """One curve of the power_scan configuration at ``num`` samples; with
    ``offgrid`` its observations at the log-spaced times, as slot tables."""
    from bayesian_inference_trpl_tpu_torch import physics
    from bayesian_inference_trpl_tpu_torch.models.driver import SimParams, pl_log_scale
    from bayesian_inference_trpl_tpu_torch.models.solver import FusedObs
    from bayesian_inference_trpl_tpu_torch.utils import sampling
    g = POWER_SCAN
    sim = SimParams(length=g["thickness"], time=g["time"], L=g["L"], T=g["T"],
                    tol_exp=g["tol_exp"], max_iters=g["max_iters"],
                    method="fused_horizon_chord", predictor="quadratic",
                    step_tol=g["step_tol"], fast_fine_steps=g["fast_fine_steps"],
                    fast_coarse_stride=g["fast_coarse_stride"],
                    fast_max_stride=g["fast_max_stride"],
                    fast_steps_per_phase=g["fast_steps_per_phase"])
    uc = physics.UNIT_CONVERSIONS
    X = sampling.random_grid(np.asarray(MIN_X) * uc, np.asarray(MAX_X) * uc,
                             DO_LOG, num, rng=np.random.RandomState(seed))
    dev = "cuda"
    mat = torch.as_tensor(physics.nondimensionalize(X[:, :12], sim.dx, sim.dt),
                          dtype=dtype, device=dev)
    dn = torch.as_tensor(excitation_profiles(g["L"], g["thickness"])[1] * sim.dx ** 3,
                         dtype=dtype, device=dev)
    n0 = (mat[:, 0:1] + dn[None]).contiguous()
    p0 = (mat[:, 1:2] + dn[None]).contiguous()
    if offgrid:
        from bayesian_inference_trpl_tpu_torch.models.offgrid import (
            build_offgrid_tables, solve_offgrid)
        t = offgrid_times(g["T"], g["time"])
        _, curves = decay_curves(g["T"], g["time"], 1, seed, t)
        tables = build_offgrid_tables([t], [np.log10(curves[0])], sim.fast_phases,
                                      sim.dt)

        def run(kernel):
            solve_offgrid(mat, n0, p0, torch.zeros_like(n0), sim.solver_config(),
                          tables, sim.fast_phases, pl_log_scale(sim),
                          sys.float_info.min, kernel=kernel)
        return run
    from bayesian_inference_trpl_tpu_torch.models.twophase import solve_multiphase
    _, curves = decay_curves(g["T"], g["time"], 1, seed)
    vals = torch.as_tensor(np.log10(curves[0])[None], dtype=dtype, device=dev)
    obs = FusedObs(values=vals, log_scale=pl_log_scale(sim),
                   min_val=sys.float_info.min)

    def run(kernel):
        solve_multiphase(mat, n0, p0, torch.zeros_like(n0), sim.solver_config(),
                         obs, sim.fast_phases, kernel=kernel)
    return run


def compare_phase(hk, run, dtype_name):
    """Plain chain (group=1) on the card, then the kernel on each phase's
    recorded inputs.  Returns per-phase records."""
    plain = Recorder(functools.partial(hk.horizon_chord_plain, group=1))
    run(plain)
    recs = []
    for args, ref, plain_s in plain.calls:
        out = hk.horizon_chord(*args)          # warm-up + comparison
        torch.cuda.synchronize()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        reps = 3
        start.record()
        for _ in range(reps):
            hk.horizon_chord(*args)
        end.record()
        torch.cuda.synchronize()
        prm = args[-1]
        recs.append(dict(stride=prm.stride, K=prm.offgrid_k, steps=args[4].shape[1],
                         label=(f"off-grid K {prm.offgrid_k:>2}" if prm.offgrid_k
                                else f"stride {prm.stride:>2}"),
                         ref=ref, out=out, kernel_ms=start.elapsed_time(end) / reps,
                         plain_ms=plain_s * 1e3, args=args, dtype=dtype_name))
    return recs


def check_f64(r):
    ref, out = r["ref"], r["out"]
    for name in ("conv", "its", "fulls", "execs", "maxit"):
        a, b = getattr(out, name), getattr(ref, name)
        if not torch.equal(a, b):
            bad = int((a != b).sum())
            raise AssertionError(f"f64 {r['label']}: {name} differs on {bad} samples")
    err = 0.0
    for name in ("sse", "esum"):
        a, b = getattr(out, name), getattr(ref, name)
        both = torch.isfinite(a) & torch.isfinite(b)
        if not torch.equal(torch.isfinite(a), torch.isfinite(b)):
            raise AssertionError(f"f64 {r['label']}: {name} finiteness differs")
        rel = ((a - b).abs() / b.abs().clamp_min(1e-300))[both]
        if rel.numel() and float(rel.max()) > F64_RTOL:
            raise AssertionError(f"f64 {r['label']}: {name} rel err "
                                 f"{float(rel.max()):.3e} > {F64_RTOL}")
        err = max(err, float((a - b).abs()[both].max()) if both.any() else 0.0)
    return err, state_rel(out, ref)


def state_rel(out, ref):
    """Largest relative difference of the final N and P."""
    return max(float(((getattr(out, k) - getattr(ref, k)).abs()
                      / getattr(ref, k).abs().clamp_min(1e-300)).max())
               for k in ("n", "p"))


def check_f32(r):
    ref, out = r["ref"], r["out"]
    conv_eq = float((out.conv == ref.conv).float().mean())
    both = out.conv & ref.conv & torch.isfinite(out.sse).all(0) & torch.isfinite(ref.sse).all(0)
    rel = ((out.sse - ref.sse).abs() / ref.sse.abs().clamp_min(1e-30)).amax(0)[both]
    within = float((rel <= F32_RTOL).float().mean()) if rel.numel() else 1.0
    if conv_eq < F32_MIN_SHARE or within < F32_MIN_SHARE:
        raise AssertionError(f"f32 {r['label']}: conv equal on {conv_eq:.4f}, "
                             f"sse within {F32_RTOL} on {within:.4f} (< {F32_MIN_SHARE})")
    return conv_eq, within, float(rel.max()) if rel.numel() else 0.0, \
        float((out.sse - ref.sse).abs().amax(0)[both].max()) if rel.numel() else 0.0


def bound_ms(r, L, peak):
    """Least time for this launch's work: operations over the peak rate vs
    bytes (inputs read once, outputs written once) over HBM bandwidth."""
    out = r["out"]
    batch = out.n.shape[0]
    ops = L * (r["steps"] * batch * OPS_STEP
               + float(out.execs.double().sum()) * OPS_ITER
               + float(out.fulls.double().sum()) * OPS_FULL)
    ops += r["steps"] * batch * out.sse.shape[0] * r["K"] * OPS_SLOT
    nbytes = sum(a.numel() * a.element_size() for a in r["args"][:9]
                 if isinstance(a, torch.Tensor))
    nbytes += sum(x.numel() * x.element_size() for x in out)
    t_ops, t_bytes = ops / peak, nbytes / HBM_BYTES_PER_S
    return max(t_ops, t_bytes) * 1e3, "operations" if t_ops >= t_bytes else "bytes"


def write_main_inputs(tmp, num_points, seed, offgrid=False):
    """Excitations, observations (on the grid, or at the off-grid times)
    and a TOML of the power_scan configuration, in ``tmp``."""
    g = POWER_SCAN
    profiles = excitation_profiles(g["L"], g["thickness"])
    exc = os.path.join(tmp, "excitations.csv")
    obs = os.path.join(tmp, "observations.csv")
    with open(exc, "w") as f:
        for dn in profiles:
            f.write(",".join(f"{v / 1e-21:.8e}" for v in dn) + "\n")
    t = offgrid_times(g["T"], g["time"]) if offgrid else None
    t, curves = decay_curves(g["T"], g["time"], len(profiles), seed + 1, t)
    ts = [f"{x:.6f}" for x in t]
    with open(obs, "w") as f:
        for pl in curves:
            f.write("".join(f"{a},{b / 1e-23:.10e},1e13\n" for a, b in zip(ts, pl)))
        f.write("END,,\n")
    cfg = os.path.join(tmp, "smoke.toml")
    with open(cfg, "w") as f:
        f.write(f"""checkpoint = true
resume = false

[grid]
thickness = {g['thickness']}
time = {g['time']}
num_nodes = {g['L']}
num_steps = {g['T']}
pl_stride = 1
tol_exp = {g['tol_exp']}
max_iters = {g['max_iters']}
method = "fused_horizon_chord"
predictor = "quadratic"
step_tol = {g['step_tol']}
fast_fine_steps = {g['fast_fine_steps']}
fast_coarse_stride = {g['fast_coarse_stride']}
fast_max_stride = {g['fast_max_stride']}
fast_steps_per_phase = {g['fast_steps_per_phase']}

[params]
min_x = {MIN_X}
max_x = {MAX_X}
do_log = {DO_LOG}

[ic_flags]
time_cutoff = 2000.0

[sim_flags]
random_sample = true
num_points = {num_points}
log_pl = true
self_normalize = false
seed = {seed}

[device]
chunk_per_device = 1024
dtype = "float32"

[paths]
init_file = "{exc}"
observation_files = ["{obs}"]
out_dirs = ["{os.path.join(tmp, 'out', 'smoke')}"]
""")
    return cfg


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--num-points", type=int, default=32768,
                    help="samples of the main-path run (power_scan: 131072)")
    ap.add_argument("--seed", type=int, default=42)
    args = ap.parse_args()
    t_all = time.perf_counter()
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: CUDA is not available")
    from bayesian_inference_trpl_tpu_torch.ops import horizon_kernel as hk
    from bayesian_inference_trpl_tpu_torch.run import main as run_main
    from bayesian_inference_trpl_tpu_torch.utils import io as bio

    name = torch.cuda.get_device_name(0)
    card_line = card()
    print(f"device: {name}; torch {torch.__version__}, CUDA {torch.version.cuda}; "
          f"{card_line}", flush=True)

    # 1. build
    t0 = time.perf_counter()
    lib = hk.build_library()
    ptx = [ln.strip() for ln in hk.build_info.get("ptxas", "").splitlines()
           if "registers" in ln or "Compiling entry" in ln]
    phase("build", t0, f"nvcc {hk.build_info['seconds']:.2f} s -> "
          f"{os.path.relpath(lib, os.path.dirname(os.path.abspath(__file__)))}")
    for ln in ptx:
        print(f"  ptxas: {ln}")

    # 2. kernel vs plain, on-grid modes
    err64 = {}
    recs32 = {}
    compare_modes(hk, "", args.seed, err64, recs32)

    # 3. on-grid main path through the port's CLI
    counts = {}
    main_path(hk, run_main, bio, args, "", ("stride_1", "stride_s"), counts,
              {"stride_1": 1, "stride_s": 3})

    # 4-5. the off-grid mode and path
    compare_modes(hk, "offgrid", args.seed, err64, recs32)
    main_path(hk, run_main, bio, args, "offgrid", ("offgrid",), counts,
              {"offgrid": 4})

    def entry(mode):
        sel = recs32[mode]
        return dict(
            name=f"horizon_chord_{mode}", route="cuda",
            source="bayesian_inference_trpl_tpu_torch/csrc/horizon_kernel.cu",
            replaces="bayesian_inference_trpl_tpu/ops/pallas/horizon_kernel.py:887",
            launches=counts[mode],
            max_abs_err=err64[mode],
            ms=float(np.mean([r["kernel_ms"] for r in sel])),
            plain_ms=float(np.mean([r["plain_ms"] for r in sel])),
            bound_ms=float(np.mean([r["bound_ms"] for r in sel])),
            bound_by=sel[0]["bound_by"], library_ms=None)

    print(json.dumps({"kernels": [entry(m) for m in ("stride_1", "stride_s", "offgrid")]}))
    phase("total", t_all, "")
    print(card_line)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}))


def mode_of(r):
    return "offgrid" if r["K"] else "stride_1" if r["stride"] == 1 else "stride_s"


def compare_modes(hk, kind, seed, err64, recs32):
    """Kernel vs plain in float64 (64 samples) and float32 (the chunk,
    1024 samples) over the full ladder, on-grid (kind "") or off-grid."""
    offgrid = kind == "offgrid"
    suffix = "_offgrid" if offgrid else ""
    t0 = time.perf_counter()
    for r in compare_phase(hk, ladder_inputs(64, torch.float64, seed, offgrid), "f64"):
        e, srel = check_f64(r)
        err64[mode_of(r)] = max(err64.get(mode_of(r), 0.0), e)
        print(f"  f64 {r['label']} x {r['steps']} steps, 64 samples: "
              f"conv/its/fulls/execs equal, max abs err {e:.3e}, "
              f"final N/P max rel diff {srel:.1e}, "
              f"conv {int(r['out'].conv.sum())}/64, fulls mean "
              f"{float(r['out'].fulls.float().mean()):.1f}")
    phase(f"compare{suffix}_f64", t0, f"kernel == plain(group=1) within {F64_RTOL} relative")

    t0 = time.perf_counter()
    for r in compare_phase(hk, ladder_inputs(1024, torch.float32, seed, offgrid), "f32"):
        conv_eq, within, rmax, amax = check_f32(r)
        b_ms, b_by = bound_ms(r, POWER_SCAN["L"], PEAK_FP32)
        r.update(bound_ms=b_ms, bound_by=b_by, abs_err=amax)
        recs32.setdefault(mode_of(r), []).append(r)
        print(f"  f32 {r['label']} x {r['steps']} steps, 1024 samples: "
              f"conv equal {conv_eq:.4f}, sse within {F32_RTOL}: {within:.4f} "
              f"(max rel {rmax:.2e}), final N/P max rel diff "
              f"{state_rel(r['out'], r['ref']):.1e}; kernel {r['kernel_ms']:.3f} ms, "
              f"plain {r['plain_ms']:.1f} ms, bound {b_ms:.4f} ms ({b_by}, "
              f"{100 * b_ms / r['kernel_ms']:.1f}% of it reached); "
              f"its/sample {float(r['out'].its.float().mean()):.1f}, "
              f"execs/sample {float(r['out'].execs.float().mean()):.1f}, "
              f"fulls/sample {float(r['out'].fulls.float().mean()):.1f}")
    phase(f"compare{suffix}_f32", t0, "kernel vs plain(group=1) at chunk 1024")


def main_path(hk, run_main, bio, args, kind, modes, counts, per_chunk_curve):
    """The port's CLI on synthetic data; the launch counts are zeroed just
    before the run and read just after.  Every kernel of the path must
    have launched, and no other."""
    suffix = "_offgrid" if kind else ""
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="trpl_smoke_") as tmp:
        cfg_path = write_main_inputs(tmp, args.num_points, args.seed, bool(kind))
        print(f"  main{suffix} path: num_points reduced 131072 -> {args.num_points}; "
              f"3 curves x 80000 steps; chunk 1024; float32"
              + (f"; t = 0 plus {OFFGRID_POINTS} log-spaced times per curve" if kind else ""),
              flush=True)
        phase(f"main{suffix}_inputs", t0, f"synthetic data and TOML in {tmp}")
        for k in hk.launches:
            hk.launches[k] = 0
        t0 = time.perf_counter()
        rc = run_main([cfg_path, "--log-dir", os.path.join(tmp, "Logs")])
        torch.cuda.synchronize()
        main_s = time.perf_counter() - t0
        run_counts = dict(hk.launches)
        logging.getLogger("bayes-trpl-torch").handlers.clear()
        if rc != 0:
            raise RuntimeError(f"run.main returned {rc}")
        P, X = bio.load_bayran(os.path.join(tmp, "out", "smoke"))
    if P.shape != (args.num_points,) or X.shape != (args.num_points, 13):
        raise AssertionError(f"BAYRAN shapes {P.shape} {X.shape}")
    finite = float(np.isfinite(P).mean())
    sims_per_min = 3 * args.num_points / main_s * 60.0
    phase(f"main{suffix}", t0, f"{args.num_points} samples x 3 curves; {sims_per_min:.0f} "
          f"sims/min; finite share of P {finite:.4f}; launches {run_counts}")
    if finite < 0.99:
        raise AssertionError(f"finite share of P {finite:.4f} < 0.99")
    chunk_curves = 3 * -(-args.num_points // 1024)
    for k, v in run_counts.items():
        want = per_chunk_curve.get(k, 0) * chunk_curves
        if v != want:
            raise AssertionError(f"main{suffix} path launched the {k} kernel {v} times, "
                                 f"expected {want}")
    print(f"  launches as expected: {', '.join(f'{per_chunk_curve[k]} {k}' for k in modes)} "
          f"per chunk per curve, {chunk_curves} chunk-curves")
    counts.update({k: run_counts[k] for k in modes})


if __name__ == "__main__":
    main()
