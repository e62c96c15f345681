"""Cartesian parameter-sweep generator.

Headless equivalent of the reference's Testing/pvSetup.py (pvSetup.py:9-90):
takes per-parameter value lists, emits every combination as a (batch, 12)
matrix in (V, nm, ns) units plus the grid/initial-condition metadata, as an
npz sweep file consumed by ``tools.run_sweep``.

Parameter flags take comma-separated value lists in the reference's user
units (cm-based, like the main pipeline's ParamSpace); mobilities are given
as mu [cm^2/Vs] and converted to diffusivities via the Einstein relation
exactly like the entry script (parallel_bayes_gpu.py:27-33).
"""
from __future__ import annotations

import argparse
import itertools

import numpy as np

from .. import physics

PARAMS = ["n0", "p0", "mun", "mup", "B", "Sf", "Sb", "CN", "CP",
          "taun", "taup", "lam"]
DEFAULTS = {
    "n0": "1e8", "p0": "1e16",
    "mun": "0.389, 38.9", "mup": "0.389, 38.9",   # ~0.1, 10 nm^2/ns
    "B": "1e-10, 1e-12", "Sf": "1e2, 1e5", "Sb": "1e2, 1e5",
    "CN": "0", "CP": "0",
    "taun": "0.5, 50", "taup": "0.5, 50", "lam": "10",
}


def make_sweep(values_per_param):
    """All combinations of the 12 per-parameter value lists -> (batch, 12)
    user-unit matrix (the reference's get_all_combinations,
    pvSetup.py:9-47)."""
    combos = list(itertools.product(*values_per_param))
    return np.asarray(combos, dtype=float)


def build(args) -> dict:
    values = [[float(v) for v in getattr(args, p).split(",")] for p in PARAMS]
    mat_user = make_sweep(values)
    mat = mat_user * physics.UNIT_CONVERSIONS[:12]
    return dict(
        mat_par=mat,
        length=args.length, time=args.time, L=args.L, T=args.T,
        tol_exp=args.tol_exp, max_iters=args.max_iters,
        init_mode="exp", ini_par=np.array([args.amp, args.decay]),
    )


def main(argv=None):
    ap = argparse.ArgumentParser(
        description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("out", help="output sweep .npz")
    for p in PARAMS:
        ap.add_argument(f"--{p}", default=DEFAULTS[p],
                        help=f"comma-separated values (default {DEFAULTS[p]})")
    ap.add_argument("--length", type=float, default=1000.0, help="film [nm]")
    ap.add_argument("--time", type=float, default=100.0, help="horizon [ns]")
    ap.add_argument("--L", type=int, default=128)
    ap.add_argument("--T", type=int, default=4000)
    ap.add_argument("--tol-exp", type=float, default=5.0, dest="tol_exp")
    ap.add_argument("--max-iters", type=int, default=500, dest="max_iters")
    ap.add_argument("--amp", type=float, default=1e18,
                    help="initial dN amplitude [cm^-3]")
    ap.add_argument("--decay", type=float, default=100.0,
                    help="initial dN decay length [nm]")
    args = ap.parse_args(argv)
    args.amp = args.amp / 1e7 ** 3                      # cm^-3 -> nm^-3
    data = build(args)
    np.savez(args.out, **data)
    print(f"wrote sweep of {len(data['mat_par'])} parameter sets to {args.out}")


if __name__ == "__main__":
    main()
