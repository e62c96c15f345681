"""Run a parameter sweep through the production solver or the scipy
oracle, recording state snapshots and the PL trace.

The runner half of the reference's verification pipeline: the standalone
solver mode (pvSimPCR.py:403-416) and the independent scipy integrator
(Testing/PV_tester2.py) write pickled (plN, plP, plE, plI); here both
backends emit one npz result file with snapshots at the reference's
fractional times pT = (0, 1, 3, 10, 30, 100)%% of T (pvSetup.py:56-64),
ready for ``tools.compare`` / ``tools.overlay``.

The solver backend runs models/driver.pvsim on ``--device`` (default
``cuda``); with a fused method (fused_horizon, fused_horizon_chord) the
whole sweep is one launch of the horizon kernel recording the PL trace
and the state snapshots (ops/horizon_kernel.solve_horizon_record).
"""
from __future__ import annotations

import argparse

import numpy as np

SNAP_PCT = (0, 1, 3, 10, 30, 100)       # reference pT (pvSetup.py:61)


def _snap_steps(T: int):
    return np.array([p * T // 100 for p in SNAP_PCT], dtype=int)


def run_solver(sweep: dict, method: str, dtype_name: str, device="cuda") -> dict:
    import torch
    from .. import physics
    from ..models.driver import SimParams, initial_excess_density, pvsim

    T = int(sweep["T"])
    steps = _snap_steps(T)
    stride = int(np.gcd.reduce(steps[steps > 0]))
    if T % stride:
        raise ValueError(f"T={T} must be divisible by 100")
    # PL and states are both recorded at the snapshot gcd stride (the
    # reference standalone test runs plT=10 as well, pvSetup.py:61).
    sim = SimParams(length=float(sweep["length"]), time=float(sweep["time"]),
                    L=int(sweep["L"]), T=T, pl_stride=stride,
                    tol_exp=float(sweep["tol_exp"]),
                    max_iters=int(sweep["max_iters"]), method=method)
    dtype = torch.float64 if dtype_name == "float64" else torch.float32
    ini = tuple(sweep["ini_par"]) if sweep["init_mode"] == "exp" else sweep["ini_par"]
    res = pvsim(sweep["mat_par"], sim, ini, init_mode=str(sweep["init_mode"]),
                dtype=dtype, record_state_stride=stride, device=device)
    # states: tuple of (T//stride, batch, L); frame j = step (j+1)*stride.
    ns, ps, es = res.states
    dx = sim.dx
    mat = np.asarray(sweep["mat_par"])
    dn0 = initial_excess_density(sim, ini, str(sweep["init_mode"]), dtype=dtype,
                                 device="cpu").numpy() / dx ** 3  # [nm^-3]
    n0 = mat[:, 0:1] + dn0[None, :]
    p0 = mat[:, 1:2] + dn0[None, :]

    def snap(arr0, arr, scale):
        frames = [np.asarray(arr0)]
        frames += [arr[s // stride - 1].cpu().numpy() * scale
                   for s in steps if s > 0]
        return np.stack(frames, axis=1)           # (batch, n_snap, L)

    N = snap(n0, ns, 1.0 / dx ** 3)
    P = snap(p0, ps, 1.0 / dx ** 3)
    E = snap(np.zeros_like(n0), es, physics.KB_T / dx)
    return dict(times=steps * sim.dt, N=N, P=P, E=E,
                pl=res.pl.cpu().numpy(), pl_times=sim.pl_times,
                converged=res.converged.cpu().numpy())


def run_oracle(sweep: dict, rtol: float, atol: float) -> dict:
    from ..models.driver import SimParams, initial_excess_density
    from ..models.oracle import solve_oracle

    T = int(sweep["T"])
    steps = _snap_steps(T)
    sim = SimParams(length=float(sweep["length"]), time=float(sweep["time"]),
                    L=int(sweep["L"]), T=T)
    ini = tuple(sweep["ini_par"]) if sweep["init_mode"] == "exp" else sweep["ini_par"]
    dn = initial_excess_density(sim, ini, str(sweep["init_mode"]),
                                device="cpu").numpy() / sim.dx ** 3   # [nm^-3]
    mat = np.asarray(sweep["mat_par"])
    Ns, Ps, Es, pls = [], [], [], []
    for row in mat:
        t, N, Pv, E, pl = solve_oracle(row, sim.length, sim.time, sim.L,
                                       sim.num_pl, dn, rtol=rtol, atol=atol)
        Ns.append(N.T[steps])                     # (n_snap, L)
        Ps.append(Pv.T[steps])
        Es.append(E.T[steps])
        pls.append(pl)
    return dict(times=steps * sim.dt, N=np.stack(Ns), P=np.stack(Ps),
                E=np.stack(Es), pl=np.stack(pls), pl_times=sim.pl_times,
                converged=np.ones(len(mat), dtype=bool))


def main(argv=None):
    ap = argparse.ArgumentParser(
        description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("sweep", help="input sweep .npz (tools.sweep)")
    ap.add_argument("out", help="output result .npz")
    ap.add_argument("--backend", choices=["solver", "oracle"], default="solver")
    ap.add_argument("--method", default="coupled_newton",
                    help="solver method (gauss_seidel | coupled_newton | "
                         "coupled_newton_pallas | fused_horizon | fused_horizon_chord)")
    ap.add_argument("--dtype", default="float64",
                    choices=["float32", "float64"])
    ap.add_argument("--rtol", type=float, default=1e-8)
    ap.add_argument("--atol", type=float, default=1e-12)
    ap.add_argument("--device", default="cuda",
                    help="device of the solver backend (default cuda; cpu runs "
                         "each kernel's plain version)")
    args = ap.parse_args(argv)
    sweep = dict(np.load(args.sweep, allow_pickle=False))
    if args.backend == "solver":
        res = run_solver(sweep, args.method, args.dtype, args.device)
    else:
        res = run_oracle(sweep, args.rtol, args.atol)
    np.savez(args.out, **res, **{k: sweep[k] for k in
                                 ("mat_par", "length", "time", "L", "T")})
    nc = int((~res["converged"]).sum())
    print(f"wrote {args.backend} results for {len(res['pl'])} sets to "
          f"{args.out}" + (f" ({nc} non-converged)" if nc else ""))


if __name__ == "__main__":
    main()
