"""Multi-device dry run: an n-device mesh against a 1-device mesh at the
same global chunk, bit for bit.

The port's twin of the JAX package's ``dryrun_multichip``
(__graft_entry__.py:67-197).  It drives ``Runner`` over a sample mesh on
the three curve routes of the pipeline:

* on-grid, with the stride ladder and masked observations (a short second
  experiment), over at least two chunks, counting the checkpoint
  callback;
* off-grid slot tables, with a ragged second experiment;
* the interpolation fallback, with one experiment observed beyond the
  horizon, which is NaN on both sides;

and requires X's likelihoods, their NaN pattern and the convergence flags
to be equal on both meshes.  Every route takes its decisions per sample,
so a sample's result does not depend on which device or batch ran it.

On the CPU the mesh is the CPU n times at 2 samples per device and the
plain versions run, at tiny sizes (T 48).  On the card it is ``cuda:0`` n
times, or the visible cards when there are that many, at power_scan's
full ladder and a global chunk of 1,024:

    python -m bayesian_inference_trpl_tpu_torch.tools.dryrun_multichip \\
        --devices 2 [--device cpu]
"""
from __future__ import annotations

import argparse
import time
from dataclasses import dataclass

import numpy as np
import torch

from .. import physics
from ..models.driver import SimParams
from ..models.offgrid import OffGridTables, build_offgrid_tables
from ..config import DeviceConfig
from ..parallel.mesh import make_mesh, synchronize
from ..parallel.runner import Runner
from ..utils.validate import connect_to_devices

ROUTES = ("ongrid", "offgrid", "interp")
# The sample box of the JAX dry run (V, nm, ns units before conversion).
BOX_LO = np.array([1e8, 1e14, 5.0, 5.0, 1e-11, 0.1, 0.1, 1e-30, 1e-30, 100.0, 100.0, 0.1])
BOX_HI = np.array([1e8, 1e16, 50.0, 50.0, 1e-9, 100.0, 100.0, 1e-28, 1e-28, 1000.0, 2000.0,
                   0.1])
# A route's converged share must reach this (the pipeline's finite share).
MIN_CONVERGED = 0.99
# Samples per device per chunk on the CPU (the JAX dry run's), and the
# global chunk on the card (power_scan's chunk_per_device), split over
# the mesh.
CPU_CHUNK_PER_DEVICE = 2
CARD_CHUNK = 1024


@dataclass
class Problem:
    sim: SimParams
    X: np.ndarray                 # (num, 13) samples in user units
    ini: np.ndarray               # (L,) excitation [nm^-3]
    obs_vals: np.ndarray          # (2, T + 1) on-grid log10 observations
    obs_mask: np.ndarray          # (2, T + 1); the second curve is short
    tables: OffGridTables         # off-grid slot tables, ragged
    interp_times: list            # the second experiment beyond the horizon
    interp_values: list
    interp_num: int               # samples on the interpolation route
    dtype: torch.dtype = torch.float32


def problem(full: bool = False, num: int = 16, interp_num: int = 16, seed: int = 1,
            dtype=torch.float32, T: int = 48) -> Problem:
    """The dry run's inputs: ``full`` is power_scan's grid (T 80,000, the
    256/16/64/512 ladder, examples/power_scan.toml:9-25), else the JAX dry
    run's tiny one (``T`` steps of power_scan's dt, ladder T/3 fine steps,
    then strides 2 and 4 at 4 coarse steps); the fused_horizon_chord
    method, quadratic predictor."""
    if full:
        T, ladder, n_off = 80000, (256, 16, 64, 512), 400
    else:
        ladder, n_off = (T // 3, 2, 4, 4), 9
    sim = SimParams(length=311.0, time=2000.0 * T / 80000, L=128, T=T, pl_stride=1,
                    tol_exp=4.0, max_iters=8, method="fused_horizon_chord", predictor="quadratic",
                    step_tol=1e-6, fast_fine_steps=ladder[0], fast_coarse_stride=ladder[1],
                    fast_max_stride=ladder[2], fast_steps_per_phase=ladder[3])
    rng = np.random.default_rng(seed)
    u = rng.uniform(size=(num, 12))
    X = np.zeros((num, 13))
    X[:, :12] = (BOX_LO + u * (BOX_HI - BOX_LO)) * physics.UNIT_CONVERSIONS[:12]
    X[:, 12] = rng.uniform(-0.2, 0.2, num)
    ini = rng.uniform(0.5, 1.5, sim.L) * 1e18 / 1e7 ** 3
    obs_vals = rng.uniform(-4.0, -2.0, (2, sim.num_pl))
    obs_mask = np.ones((2, sim.num_pl))
    obs_mask[1, -(sim.num_pl // 5):] = 0.0         # a bucket_horizons-style short curve
    t_obs = np.geomspace(sim.dt, sim.time * 0.98, n_off)
    times = [t_obs, t_obs[:n_off // 2]]              # ragged second curve
    tables = build_offgrid_tables(times, [rng.uniform(-4.0, -2.0, len(t)) for t in times],
                                  sim.fast_phases, sim.dt)
    times_i = [np.linspace(0.0, sim.time, 7),
               np.array([0.0, sim.dt * 1.5, sim.time * 1.5])]   # beyond the horizon
    values_i = [rng.uniform(-4.0, -2.0, len(t)) for t in times_i]
    return Problem(sim, X, ini, obs_vals, obs_mask, tables, times_i, values_i,
                   min(interp_num, num), dtype)


def run_route(route: str, mesh, chunk_per_device: int, prob: Problem):
    """One route on ``mesh``; returns (out (2, n), conv (n,), checkpointed
    chunk indices, wall seconds with the device synchronised)."""
    runner = Runner(chunk=chunk_per_device, mesh=mesh)
    ckpts = []
    kw = dict(normalize=False, dtype=prob.dtype,
              chunk_done=lambda ci, ll: ckpts.append(ci))
    t0 = time.perf_counter()
    if route == "ongrid":
        out, conv = runner.run_curve(prob.X, prob.sim, prob.ini, prob.obs_vals,
                                     obs_mask=prob.obs_mask, **kw)
    elif route == "offgrid":
        out, conv = runner.run_curve_offgrid(prob.X, prob.sim, prob.ini, prob.tables,
                                             prob.sim.fast_phases, **kw)
    else:
        out, conv = runner.run_curve_interp(prob.X[:prob.interp_num], prob.sim, prob.ini,
                                            prob.interp_times, prob.interp_values,
                                            log_pl=True, **kw)
    synchronize(runner.mesh)
    return out, conv, ckpts, time.perf_counter() - t0


def check_route(route: str, res_n, res_1, n_chunks: int) -> str:
    """Raise unless the n-device result equals the 1-device one bit for
    bit (NaN where NaN), both checkpointed every chunk, and the route's
    converged samples are finite (the interpolation route's second
    experiment NaN)."""
    (out_n, conv_n, ck_n, _), (out_1, conv_1, ck_1, _) = res_n, res_1
    if ck_n != list(range(n_chunks)) or ck_1 != ck_n:
        raise AssertionError(f"{route}: checkpointed chunks {ck_n} / {ck_1}, "
                             f"expected {n_chunks}")
    if not np.array_equal(conv_n, conv_1):
        raise AssertionError(f"{route}: converged flags differ on "
                             f"{int((conv_n != conv_1).sum())} samples")
    if not np.array_equal(out_n, out_1, equal_nan=True):
        raise AssertionError(f"{route}: the n-device result differs from the 1-device "
                             f"run: max abs diff {np.nanmax(np.abs(out_n - out_1))}")
    if conv_n.mean() < MIN_CONVERGED:
        raise AssertionError(f"{route}: converged share {conv_n.mean():.4f}")
    live = out_n[:1] if route == "interp" else out_n
    if not np.isfinite(live[:, conv_n]).all():
        raise AssertionError(f"{route}: non-finite likelihood of a converged sample")
    if route == "interp" and not np.isnan(out_n[1]).all():
        raise AssertionError("interp: the beyond-horizon experiment is not NaN")
    return (f"{route}: {out_n.shape[1]} samples, {n_chunks} chunks, bitwise equal, "
            f"converged {conv_n.mean():.4f}")


def dryrun_multichip(n_devices: int, device: str = "cpu") -> dict:
    """An ``n_devices`` mesh against one device at the same global chunk,
    on every route: on the CPU the CPU n times at the tiny grid; on the
    card the visible cards when there are that many, else ``cuda:0`` n
    times, at power_scan's grid.  Returns each route's wall seconds per
    mesh."""
    full = device != "cpu"
    if not full:
        mesh_n = make_mesh(["cpu"] * n_devices)
        chunk_per_device = CPU_CHUNK_PER_DEVICE
    else:
        if torch.cuda.device_count() >= n_devices:
            mesh_n = make_mesh(connect_to_devices(DeviceConfig(n_devices=n_devices)))
        else:
            mesh_n = make_mesh(["cuda:0"] * n_devices)
        chunk_per_device = CARD_CHUNK // n_devices
    mesh_1 = mesh_n[:1]
    chunk = chunk_per_device * n_devices
    prob = problem(full, 2 * chunk, 2 * chunk)            # two chunks on every route
    seconds = {}
    for route in ROUTES:
        res_n = run_route(route, mesh_n, chunk_per_device, prob)
        res_1 = run_route(route, mesh_1, chunk, prob)
        print("  " + check_route(route, res_n, res_1, 2))
        seconds[route] = (res_n[3], res_1[3])
    return dict(mesh=[str(d) for d in mesh_n], seconds=seconds)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--devices", type=int, default=4)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        raise SystemExit("dryrun_multichip: CUDA requested but no CUDA device is available")
    rep = dryrun_multichip(args.devices, args.device)
    print(f"dryrun_multichip ok: mesh {rep['mesh']}; seconds (n-device, 1-device) "
          f"{rep['seconds']}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
