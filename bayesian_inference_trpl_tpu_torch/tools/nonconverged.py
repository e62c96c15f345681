"""Characterize the non-converged samples of a finished inference run.

The reference aborts ALL blocks when any sample fails to converge
(reference: pvSimPCR.py:269-292, the ``race[-1]`` global-abort flag);
this framework instead surfaces per-sample failures as NaN likelihoods
(parallel/runner.py), which makes the failure set *analyzable*: this tool
loads a ``*_BAYRAN_X/_P.npy`` pair and reports WHERE in the 13-dim
parameter box the NaN samples live, so a "0.5% non-converged" headline can
be turned into a concrete corner signature (e.g. "Sf and Sb jointly in
their top decade with tau_n at the bottom of its range").

Method: for every parameter, compare the NaN subset's distribution against
the full sample set via the normalized position u in [0, 1] along the
sampling axis (log10 for log-sampled parameters — the same axis the
sampler draws uniformly on, utils/sampling.py).  Reported per parameter:

* mean-u shift (NaN mean minus overall mean, in box widths) and its
  z-score against the null of uniform sampling (sigma = 1/sqrt(12 n)),
* enrichment of the NaN set in the top and bottom deciles of the axis
  (ratio of observed to expected counts).

Parameters whose |z| exceeds the threshold form the corner signature,
printed as one line plus a JSON blob for docs/PRECISION.md.

Usage:
    python -m bayesian_inference_trpl_tpu_torch.tools.nonconverged OUT_DIR \
        [--min-x ...] [--max-x ...] [--z 5]
"""
from __future__ import annotations

import argparse
import json
import sys

import numpy as np

PARAM_NAMES = ["n0", "p0", "mu_n", "mu_p", "B", "Sf", "Sb", "C_n", "C_p",
               "tau_n", "tau_p", "lambda", "mag_offset"]


def axis_positions(X: np.ndarray, min_x, max_x, do_log) -> np.ndarray:
    """Normalized positions u in [0, 1] of each sample along each sampling
    axis (log10 axis for log-sampled parameters).  Pinned parameters
    (min == max) get u = 0.5."""
    X = np.asarray(X, float)
    lo = np.asarray(min_x, float)
    hi = np.asarray(max_x, float)
    do_log = np.asarray(do_log, bool)
    with np.errstate(divide="ignore", invalid="ignore"):
        a = np.where(do_log, np.log10(np.where(X > 0, X, 1.0)), X)
        lo_a = np.where(do_log, np.log10(np.where(lo > 0, lo, 1.0)), lo)
        hi_a = np.where(do_log, np.log10(np.where(hi > 0, hi, 1.0)), hi)
        width = hi_a - lo_a
        u = np.where(width[None, :] > 0, (a - lo_a[None, :]) / width[None, :],
                     0.5)
    return np.clip(u, 0.0, 1.0)


def characterize(X: np.ndarray, P: np.ndarray, min_x, max_x, do_log,
                 z_threshold: float = 5.0) -> dict:
    """Corner report for the NaN-likelihood subset of (X, P).

    P: (num_exp, n) or (n,) log-likelihoods; a sample is non-converged
    when ANY experiment's entry is NaN (runner semantics: NaN marks the
    sample, and sums propagate it).
    """
    P = np.asarray(P)
    bad = np.isnan(P if P.ndim == 1 else P.sum(axis=0))
    n, nb = len(bad), int(bad.sum())
    rep = {"num_samples": n, "num_nonconverged": nb,
           "frac_nonconverged": nb / max(n, 1), "params": {},
           "signature": []}
    if nb == 0:
        return rep
    u = axis_positions(X, min_x, max_x, do_log)
    ub = u[bad]
    for j, name in enumerate(PARAM_NAMES[:u.shape[1]]):
        col = u[:, j]
        if col.std() < 1e-12:          # pinned parameter
            continue
        shift = float(ub[:, j].mean() - col.mean())
        z = shift / (np.sqrt(1.0 / 12.0) / np.sqrt(nb))
        top = float((ub[:, j] > 0.9).mean() / max((col > 0.9).mean(), 1e-12))
        bot = float((ub[:, j] < 0.1).mean() / max((col < 0.1).mean(), 1e-12))
        rep["params"][name] = {"mean_shift": round(shift, 4),
                               "z": round(float(z), 2),
                               "top_decile_enrichment": round(top, 2),
                               "bottom_decile_enrichment": round(bot, 2)}
        if abs(z) >= z_threshold:
            side = "top" if shift > 0 else "bottom"
            rep["signature"].append(f"{name}:{side}")
    return rep


def main(argv=None):
    ap = argparse.ArgumentParser(
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("path", help="BAYRAN output dir or member file")
    ap.add_argument("--z", type=float, default=5.0,
                    help="z-score threshold for the corner signature")
    ap.add_argument("--min-x", type=lambda s: [float(v) for v in s.split(",")],
                    default=None,
                    help="comma-separated lower bounds of the run's sampling "
                         "box (defaults to the production ParamSpace)")
    ap.add_argument("--max-x", type=lambda s: [float(v) for v in s.split(",")],
                    default=None,
                    help="comma-separated upper bounds of the run's sampling box")
    args = ap.parse_args(argv)

    from ..config import ParamSpace
    from ..utils.io import load_bayran
    P, X = load_bayran(args.path)
    ps = ParamSpace()          # production box (reference defaults)
    min_x = ps.min_x if args.min_x is None else np.asarray(args.min_x, float)
    max_x = ps.max_x if args.max_x is None else np.asarray(args.max_x, float)
    if len(min_x) != len(ps.min_x) or len(max_x) != len(ps.max_x):
        ap.error(f"--min-x/--max-x need {len(ps.min_x)} comma-separated values")
    rep = characterize(X, P, min_x, max_x, ps.do_log, args.z)
    print(json.dumps(rep, indent=2))
    if rep["num_nonconverged"]:
        sig = ", ".join(rep["signature"]) or "no single-parameter corner"
        print(f"non-converged: {rep['num_nonconverged']}/"
              f"{rep['num_samples']} ({100 * rep['frac_nonconverged']:.2f}%)"
              f" — signature: {sig}", file=sys.stderr)


if __name__ == "__main__":
    main()
