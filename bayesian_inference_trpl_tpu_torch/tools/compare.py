"""Per-field relative-norm comparator for sweep results.

Headless equivalent of the reference's Testing/compare.py (compare.py:22-59):
mean relative L2 error of N, P, E (the reference's own test suite never
reported E in the repo's tests — here it is first-class) and PL between two
result files, sampled at the reference's fractional space locations
(10/30/50/70/90 %L) and PL times (0/1/3/10/30/100 %T).  Exits nonzero when
``--tol`` is given and any field exceeds it.
"""
from __future__ import annotations

import argparse
import sys

import numpy as np

SPACE_FRACS = (0.1, 0.3, 0.5, 0.7, 0.9)      # compare.py:24
TIME_FRACS = (0.0, 0.01, 0.03, 0.1, 0.3, 1.0)  # compare.py:32


def _locs(L, fracs, last_minus_one=False):
    idx = np.array([int(f * L) for f in fracs])
    return np.minimum(idx, L - 1)


def field_errors(a: dict, b: dict, reduce: str = "mean") -> dict:
    """Relative L2 per field; ``b`` is the reference run.

    ``reduce``: "mean" (the reference comparator's average over samples,
    compare.py:41-57), "max" (worst sample — the gating mode), or "none"
    (per-sample arrays, for dt-refinement fits)."""
    red = {"mean": np.nanmean, "max": np.nanmax,
           "none": np.asarray}[reduce]
    out = {}
    for f in ("N", "P", "E"):
        A, B = np.asarray(a[f]), np.asarray(b[f])
        # Fractional locations on the COMMON grid prefix: the solver's E
        # lives on edges 0..L-1 while the oracle's has all L+1 edges, and
        # both index physical edge j at x = j*dx — sampling each array by
        # its own length would compare DIFFERENT physical edges at the
        # 70%/90% fractions (off by one dx), an O(1) dt-independent
        # discrepancy where E is steep (caught by the corner gate's
        # refinement assertion, tests/test_corner_gate.py).
        Lc = min(A.shape[-1], B.shape[-1])
        la = lb = _locs(Lc, SPACE_FRACS)
        errs = []
        for i in range(len(A)):
            x = A[i][:, la].ravel()
            y = B[i][:, lb].ravel()
            ny = np.linalg.norm(y)
            errs.append(np.linalg.norm(x - y) / ny if ny > 0 else np.nan)
        out[f] = red(errs) if reduce == "none" else float(red(errs))
    pa, pb = np.asarray(a["pl"]), np.asarray(b["pl"])
    ta = _locs(pa.shape[-1], TIME_FRACS)
    tb = _locs(pb.shape[-1], TIME_FRACS)
    errs = []
    for i in range(len(pa)):
        y = pb[i][tb]
        errs.append(np.linalg.norm(pa[i][ta] - y) / np.linalg.norm(y))
    out["PL"] = red(errs) if reduce == "none" else float(red(errs))
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(
        description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("actual", help="result .npz under test")
    ap.add_argument("reference", help="reference result .npz (e.g. oracle)")
    ap.add_argument("--tol", type=float, default=None,
                    help="fail (exit 1) if any field error exceeds this")
    args = ap.parse_args(argv)
    a = dict(np.load(args.actual))
    b = dict(np.load(args.reference))
    errs = field_errors(a, b)
    worst = 0.0
    for name, e in errs.items():
        print(f"Average norm_error {name}: {e:.6e}")
        worst = max(worst, e)
    if args.tol is not None and not (worst <= args.tol):
        print(f"FAIL: worst field error {worst:.3e} > tol {args.tol:.3e}")
        sys.exit(1)


if __name__ == "__main__":
    main()
