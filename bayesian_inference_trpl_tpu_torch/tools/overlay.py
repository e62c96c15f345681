"""Solver-vs-reference overlay plots.

Headless replacement for the reference's Tk viewer
(Testing/pvPlt_interface.py:19-179): for each parameter set, draw the N, P,
E spatial profiles at every snapshot time plus the PL transient, with the
run under test solid and the reference dashed, one PNG per set.
"""
from __future__ import annotations

import argparse
import os

import numpy as np


def overlay_sample(a: dict, b: dict, i: int, out_png: str):
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fields = ("N", "P", "E")
    fig, axes = plt.subplots(2, 2, figsize=(10, 7))
    times = np.asarray(a["times"])
    for ax, f in zip(axes.flat, fields):
        A, B = np.asarray(a[f])[i], np.asarray(b[f])[i]
        xa = np.linspace(0, 1, A.shape[-1])
        xb = np.linspace(0, 1, B.shape[-1])
        for j, t in enumerate(times):
            (line,) = ax.plot(xa, A[j], lw=1.2, label=f"t={t:g} ns")
            ax.plot(xb, B[j], "--", lw=1.0, color=line.get_color())
        ax.set_yscale("log" if f != "E" else "linear")
        ax.set_title(f"{f}(x) — solid: actual, dashed: reference")
        ax.set_xlabel("x / length")
    ax = axes.flat[3]
    pa, pb = np.asarray(a["pl"])[i], np.asarray(b["pl"])[i]
    ax.plot(np.asarray(a["pl_times"]), np.maximum(pa, 1e-300), lw=1.2,
            label="actual")
    ax.plot(np.asarray(b["pl_times"]), np.maximum(pb, 1e-300), "--", lw=1.0,
            label="reference")
    ax.set_yscale("log")
    ax.set_title("PL(t)")
    ax.set_xlabel("t [ns]")
    ax.legend(fontsize=7)
    axes.flat[0].legend(fontsize=6)
    fig.suptitle(f"parameter set #{i}")
    fig.tight_layout()
    fig.savefig(out_png, dpi=110)
    plt.close(fig)


def main(argv=None):
    ap = argparse.ArgumentParser(
        description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("actual")
    ap.add_argument("reference")
    ap.add_argument("--out-dir", default="overlays")
    ap.add_argument("--samples", default=None,
                    help="comma-separated set indices (default: all)")
    args = ap.parse_args(argv)
    a = dict(np.load(args.actual))
    b = dict(np.load(args.reference))
    n = len(np.asarray(a["pl"]))
    idx = (range(n) if args.samples is None
           else [int(s) for s in args.samples.split(",")])
    os.makedirs(args.out_dir, exist_ok=True)
    for i in idx:
        path = os.path.join(args.out_dir, f"overlay_{i:04d}.png")
        overlay_sample(a, b, i, path)
        print("wrote", path)


if __name__ == "__main__":
    main()
