"""Corner-gate oracle cache: definition + loader + generator CLI.

The corner parity gate (tests/test_torch_corner_gate.py, chip_smoke.py's
``corner_gate``) compares the solver against an independent scipy-BDF
oracle (models/oracle.py) over the Cartesian corners of the production
parameter box.  The oracle integration costs ~2 h on one CPU core, so the
refined-dt oracle results ship with the repo, beside the JAX package's
exact caches; the port reads them there as data files (EXACT_CACHE_DIR of
tools/accuracy_gate.py), under the same names, since the matrices, grid
and tolerances below are the JAX package's (tools/corner_cache.py there).

Regenerate one (only needed if the corner matrix, grid or tolerances
change; scipy only, ~2 h on one core), into a file you name:

    python -m bayesian_inference_trpl_tpu_torch.tools.corner_cache \
        --matrix box|e --out corner_oracle.npz
"""
from __future__ import annotations

import hashlib
import itertools
import os

import numpy as np

from .. import physics
from .accuracy_gate import EXACT_CACHE_DIR

L = 128
TIME = 5.0          # ns — the stiff window, where all fields move
T0 = 200            # base refinement level (dt = 25 ps, production dt)
RTOL, ATOL = 1e-8, 1e-12


def corner_matrix() -> np.ndarray:
    """32 production-box corners: Sf/Sb in {0.1, 1e5} cm/s (1e5 = the
    Highsurf regime, beyond the sampling box's 100 — the hard corner),
    B in {1e-11, 1e-9}, tau_n=tau_p in {1, 2000} ns, lambda in {0.1, 10}."""
    corners = []
    for Sf, Sb, B, tau, lam in itertools.product(
            (0.1, 1e5), (0.1, 1e5), (1e-11, 1e-9), (1.0, 2000.0), (0.1, 10.0)):
        corners.append([1e8, 1e15, 20.0, 20.0, B, Sf, Sb, 1e-29, 1e-29,
                        tau, tau, lam])
    mat_user = np.asarray(corners)
    return mat_user * physics.UNIT_CONVERSIONS[:12]


def e_corner_matrix() -> np.ndarray:
    """16 mu-ASYMMETRIC corners where the electric field is dynamically
    significant (every corner of :func:`corner_matrix` has mu_n == mu_p,
    so transport there is ambipolar and the true E is identically zero).

    With mu_n != mu_p space charge develops: max |E| of 2-4e-4 V/nm at
    every corner, 5-6 orders above the oracle's integration-noise floor
    (~7e-10 V/nm at rtol 1e-8), so a wrong-sign or wrong-scale field
    assembly cannot pass.  Spans both mobility orderings (35/5 and 5/35
    cm^2/Vs), Highsurf front vs back (Sf/Sb anti-correlated at {0.1, 1e5}
    cm/s), lifetimes {1, 2000} ns and lambda {0.1, 10}; B at 1e-9."""
    corners = []
    for (mun, mup), Sf, tau, lam in itertools.product(
            ((35.0, 5.0), (5.0, 35.0)), (0.1, 1e5), (1.0, 2000.0),
            (0.1, 10.0)):
        Sb = 1e5 if Sf == 0.1 else 0.1
        corners.append([1e8, 1e15, mun, mup, 1e-9, Sf, Sb, 1e-29, 1e-29,
                        tau, tau, lam])
    mat_user = np.asarray(corners)
    return mat_user * physics.UNIT_CONVERSIONS[:12]


def corner_sweep(mat: np.ndarray, T: int) -> dict:
    return dict(mat_par=mat, length=311.0, time=TIME, L=L, T=T,
                tol_exp=9.0, max_iters=500, init_mode="exp",
                ini_par=np.array([1e18 / 1e7 ** 3, 100.0]))


def cache_path(sweep: dict, rtol: float = RTOL, atol: float = ATOL) -> str:
    """Deterministic cache file for an oracle run of ``sweep`` (keyed on
    the corner matrix + grid + tolerances; any change means a new file)."""
    key = hashlib.sha1(
        np.ascontiguousarray(np.asarray(sweep["mat_par"])).tobytes()
        + f'{sweep["T"]}_{sweep["time"]}_{sweep["L"]}_{rtol}_{atol}'.encode()
    ).hexdigest()[:10]
    return os.path.join(str(EXACT_CACHE_DIR), f"corner_oracle_T{sweep['T']}_{key}.npz")


def load_oracle(sweep: dict, rtol: float = RTOL, atol: float = ATOL) -> dict:
    """Load the shipped oracle result; raise with instructions if absent."""
    path = cache_path(sweep, rtol, atol)
    if not os.path.exists(path):
        raise FileNotFoundError(
            f"corner-gate oracle cache missing: {path}\n"
            "This file ships with the repo; if the corner matrix, grid, or "
            "tolerances changed, regenerate it (~2 h on one CPU core) with:\n"
            "    python -m bayesian_inference_trpl_tpu_torch.tools.corner_cache "
            "--matrix box|e --out FILE\n"
            f"and store it as {os.path.basename(path)}.")
    return dict(np.load(path))


def main(argv=None):
    import argparse
    import time

    from .run_sweep import run_oracle

    ap = argparse.ArgumentParser(
        description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--matrix", choices=["box", "e"], default="box",
                    help="'box' = 32 production-box corners (ambipolar); "
                         "'e' = 16 mu-asymmetric E-significant corners")
    ap.add_argument("--out", required=True,
                    help="the .npz to write (the shipped file's name is "
                         "printed)")
    args = ap.parse_args(argv)
    mat = e_corner_matrix() if args.matrix == "e" else corner_matrix()
    sweep = corner_sweep(mat, T0 * 4)
    t0 = time.time()
    out = run_oracle(sweep, rtol=RTOL, atol=ATOL)
    np.savez_compressed(args.out, **out)
    print(f"wrote {args.out} in {time.time() - t0:.0f}s (shipped as "
          f"{os.path.basename(cache_path(sweep))})")


if __name__ == "__main__":
    main()
