"""Command-line posterior analysis.

The JAX package's posterior/cli.py (the headless replacement of the
reference's Tk marginalization GUI, Visualization/marginalization_visual.py)
with the same arguments and outputs, plus ``--device`` (default ``cuda``):
load a BAYRAN result, apply a viz config, and write a corner plot, a
covariance heatmap and a stats report.

Usage:
    python -m bayesian_inference_trpl_tpu_torch.posterior.cli RESULT_DIR \\
        [--config config.txt] [--out-prefix out/posterior] [--bins 96] \\
        [--device cpu]

:func:`report` is the headless part (load, secondary parameters, limits,
temperature, ESS, stats, 95% credible intervals) and needs no matplotlib;
:func:`write_outputs` draws ``{prefix}_corner.png`` and ``{prefix}_cov.png``
(matplotlib) and writes ``{prefix}_stats.json``.
"""
from __future__ import annotations

import argparse
import json
import os
from dataclasses import dataclass
from typing import List, Optional

import torch

from .data import PosteriorData
from .plotting import corner_plot, covariance_heatmap
from .vizconfig import VizConfig, load_vizconfig

DEFAULT_PARAMS = ("p0", "B", "Sf", "Sb", "tau_n", "tau_p")


@dataclass
class Report:
    data: PosteriorData
    params: List[str]
    viz: VizConfig
    summary: dict       # what {prefix}_stats.json holds


def report(result: str, config: Optional[str] = None, thickness: Optional[float] = None,
           num_observations: Optional[int] = None, params: Optional[List[str]] = None,
           t_factor: str = "auto", device="cuda") -> Report:
    """Load ``result`` (a BAYRAN dir or member file) on ``device`` and
    summarize it as the CLI does; ``t_factor`` is 'auto', 'points' or a
    float (see ``--t-factor``)."""
    viz = load_vizconfig(config) if config else VizConfig()
    thickness = thickness if thickness is not None else viz.thickness
    num_obs = num_observations if num_observations is not None else viz.num_observations

    data = PosteriorData.load(result, thickness=thickness, num_observations=num_obs,
                              device=device)
    data.compute_secondary()
    if viz.ranges:
        data.exclude_limits({p: r for p, r in viz.ranges.items() if p in data.X})

    params = params or viz.enabled_params() or [p for p in DEFAULT_PARAMS if p in data.X]
    params = [p for p in params if p in data.X]

    t_mu = None
    if t_factor == "auto":
        # Max-uncertainty temperature (reference utils.py:172-183), with an
        # ESS >= 100 floor on top (PosteriorData.temperature_for_ess).
        t_mu = data.auto_temperature(params)
        temperature = max(t_mu, data.temperature_for_ess(100.0))
        data.normalize_temperature(temperature)
    elif t_factor == "points":
        data.normalize()
        temperature = None
    else:
        temperature = float(t_factor)
        data.normalize_temperature(temperature)
    ess = data.ess()
    if ess < 100:
        print(f"WARNING: effective sample size {ess:.1f} < 100 — the "
              f"weights are (near-)degenerate; posterior summaries "
              f"describe only the top sample(s).  Raise the temperature "
              f"(--t-factor) or score more samples.")
    summary = {
        "num_samples": int(len(data.LL)),
        "ess": round(ess, 2),
        "temperature": None if temperature is None else float(temperature),
        "temperature_max_uncertainty": None if t_mu is None else float(t_mu),
        "stats": {p: {"mean": float(m), "std": float(s)}
                  for p, (m, s, _) in data.stats_summary().items() if p in params},
        "credible_95": {p: [float(a), float(b)]
                        for p, (a, b) in data.credible_intervals().items()
                        if p in params},
    }
    return Report(data, params, viz, summary)


def write_outputs(rep: Report, out_prefix: str = "posterior", bins: int = 96,
                  scatter_top_n: int = 0):
    """Draw the corner plot and the covariance heatmap (matplotlib) and
    write the stats JSON under ``out_prefix``."""
    os.makedirs(os.path.dirname(out_prefix) or ".", exist_ok=True)
    corner_plot(rep.data, rep.params, do_log=rep.viz.do_log, marks=rep.viz.marks,
                bins=bins, top_n_scatter=scatter_top_n,
                out_file=f"{out_prefix}_corner.png")
    covariance_heatmap(rep.data, rep.params, out_file=f"{out_prefix}_cov.png")
    with open(f"{out_prefix}_stats.json", "w") as f:
        json.dump(rep.summary, f, indent=2)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("result", help="BAYRAN output dir or *_BAYRAN_*.npy path")
    ap.add_argument("--config", help="viz config file (reference config.txt format)")
    ap.add_argument("--out-prefix", default="posterior")
    ap.add_argument("--bins", type=int, default=96)
    ap.add_argument("--thickness", type=float, default=None)
    ap.add_argument("--num-observations", type=int, default=None)
    ap.add_argument("--params", nargs="*", help="parameters to analyze")
    ap.add_argument("--scatter-top-n", type=int, default=0)
    ap.add_argument("--t-factor", default="auto",
                    help="likelihood temperature: 'auto' (default; the "
                         "reference GUI's max-uncertainty search, median "
                         "over analyzed parameters — utils.py:172-183), "
                         "'points' (per-point temperature ~1, the r3 "
                         "heuristic), or a float (direct temperature, "
                         "P = normalize(LL / t))")
    ap.add_argument("--device", default="cuda",
                    help="torch device to run on (default: cuda)")
    args = ap.parse_args(argv)
    if torch.device(args.device).type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("posterior.cli: CUDA requested but no CUDA device is "
                         "available (pass --device cpu to run on the CPU)")
    rep = report(args.result, config=args.config, thickness=args.thickness,
                 num_observations=args.num_observations, params=args.params,
                 t_factor=args.t_factor, device=args.device)
    write_outputs(rep, args.out_prefix, bins=args.bins, scatter_top_n=args.scatter_top_n)
    print(json.dumps(rep.summary, indent=2))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
