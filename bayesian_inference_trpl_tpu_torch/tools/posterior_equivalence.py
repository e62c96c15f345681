"""Posterior-equivalence gate: does the fast multi-phase path RANK samples
the way exact fixed-dt stepping does?

The accuracy gate (tools/accuracy_gate.py) bounds per-curve log10-PL error
against a float64 oracle, but Bayesian inference only consumes the
relative ordering (and normalized weights) of the likelihoods, so the
decisive question for the fast path is whether P_fast induces the same
posterior as P_exact.  This tool runs BOTH paths over the same sample
matrix and observations (a config's [paths]) and gates:

* Spearman rank correlation of the finite log-likelihoods, per experiment
  (>= --min-rho, default 0.999);
* top-1% sample-set agreement (Jaccard >= --min-top-jaccard, default
  0.99, or top-k recall against the other path's top-2k = 1);
* identical finiteness pattern up to --max-finite-diff samples.

The exact side is the config with no stride ladder (``fast_fine_steps``
None) and --exact-method: one phase over the whole horizon (on-grid: one
stride-1 launch per chunk and curve under the throughput chord profile;
off-grid: one off-grid phase).  The counterpart of the JAX package's
``tools/posterior_equivalence.py``, plus ``--device cuda|cpu`` (default
``cuda``); exact stepping over 4,096 samples takes a minute on the card
and hours on a CPU:

    python -m bayesian_inference_trpl_tpu_torch.tools.posterior_equivalence \\
        --config examples/power_scan.toml --num-samples 4096
"""
import argparse
import dataclasses
import json
import sys
import time

import numpy as np
import torch


def run_path(cfg, e_data, init_params, X, device="cuda"):
    """Evaluate P (num_exp, n) for one solver configuration on the
    devices of type ``device`` that ``cfg.device`` names; returns (P, wall
    seconds)."""
    from ..parallel.mesh import make_mesh
    from ..parallel.runner import Runner
    from ..pipeline import simulate
    from ..utils.validate import connect_to_devices

    runner = Runner(chunk=cfg.device.chunk_per_device,
                    mesh=make_mesh(connect_to_devices(cfg.device, device)))
    P = np.zeros((len(e_data), len(X)))
    t0 = time.perf_counter()
    simulate(cfg, e_data, init_params, X, P, runner)
    return P, time.perf_counter() - t0


def compare_posteriors(P_fast, P_exact, top_frac=0.01):
    """Per-experiment rank/top-set agreement between two likelihood runs."""
    from scipy.stats import spearmanr

    rows = []
    for e in range(P_fast.shape[0]):
        a, b = P_fast[e], P_exact[e]
        fin_a, fin_b = np.isfinite(a), np.isfinite(b)
        both = fin_a & fin_b
        rho = float(spearmanr(a[both], b[both]).statistic)
        k = max(int(round(top_frac * both.sum())), 1)
        idx = np.where(both)[0]
        top_a = set(idx[np.argsort(a[both])[-k:]].tolist())
        top_b = set(idx[np.argsort(b[both])[-k:]].tolist())
        jac = len(top_a & top_b) / len(top_a | top_b)
        # Near-boundary robustness: a rank-(k vs k+1) tie swap halves no
        # posterior mass but costs 2/(k+1) of Jaccard; top-k recall
        # against the OTHER path's top-2k forgives boundary ties while
        # still catching real top-set divergence.
        top_a2 = set(idx[np.argsort(a[both])[-2 * k:]].tolist())
        top_b2 = set(idx[np.argsort(b[both])[-2 * k:]].tolist())
        recall = min(len(top_a & top_b2), len(top_b & top_a2)) / k
        rows.append(dict(
            spearman_rho=rho,
            top_frac=top_frac, top_k=k,
            top_jaccard=float(jac),
            top_recall_2k=float(recall),
            top_identical=bool(top_a == top_b),
            finite_fast=int(fin_a.sum()), finite_exact=int(fin_b.sum()),
            finite_mismatch=int((fin_a != fin_b).sum()),
            n=int(len(a))))
    return rows


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--config", default="examples/power_scan.toml")
    ap.add_argument("--num-samples", type=int, default=4096)
    ap.add_argument("--seed", type=int, default=None,
                    help="override the config's sample seed")
    ap.add_argument("--min-rho", type=float, default=0.999)
    ap.add_argument("--min-top-jaccard", type=float, default=0.99)
    ap.add_argument("--top-frac", type=float, default=0.01)
    ap.add_argument("--max-finite-diff", type=int, default=None,
                    help="max samples finite on one path only "
                         "(default: 1%% of num-samples)")
    ap.add_argument("--exact-method", default="fused_horizon_chord",
                    help="solver method for the exact single-phase run")
    ap.add_argument("--use-uncertainty", action="store_true",
                    help="sigma-weighted SSE on BOTH paths "
                         "(sim_flags.use_uncertainty)")
    ap.add_argument("--device", default="cuda",
                    help="torch device to run on (default: cuda)")
    args = ap.parse_args(argv)

    from ..config import load_config
    from ..utils import io as bio
    from ..utils import sampling

    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("posterior_equivalence: CUDA requested but no CUDA "
                         "device is available (pass --device cpu to run on "
                         "the CPU)")
    cfg = load_config(args.config)
    sf = dataclasses.replace(cfg.sim_flags, num_points=args.num_samples,
                             use_uncertainty=bool(args.use_uncertainty
                                                  or cfg.sim_flags
                                                  .use_uncertainty),
                             **({} if args.seed is None
                                else dict(seed=args.seed)))
    cfg = dataclasses.replace(cfg, sim_flags=sf, checkpoint=False,
                              resume=False)

    rng = np.random.default_rng(cfg.sim_flags.seed)
    init_params = bio.get_initpoints(cfg.paths.init_file,
                                     cfg.ic_flags.as_dict())
    e_data = bio.get_data(cfg.paths.observation_files, cfg.ic_flags.as_dict(),
                          cfg.sim_flags.as_dict(), rng=rng)

    min_x, max_x = cfg.params.bounds_converted()
    _, _, X = sampling.make_grid(
        len(e_data), min_x, max_x, cfg.params.do_log, cfg.sim_flags.as_dict(),
        rng=np.random.RandomState(cfg.sim_flags.seed))

    # Exact fixed-dt: same tolerance, predictor and method family, no
    # stride ladder.
    grid_exact = dataclasses.replace(
        cfg.grid, fast_fine_steps=None, method=args.exact_method)
    cfg_exact = dataclasses.replace(cfg, grid=grid_exact)

    P_fast, t_fast = run_path(cfg, e_data, init_params, X, device)
    P_exact, t_exact = run_path(cfg_exact, e_data, init_params, X, device)

    rows = compare_posteriors(P_fast, P_exact, top_frac=args.top_frac)
    max_fd = (args.max_finite_diff if args.max_finite_diff is not None
              else max(args.num_samples // 100, 1))
    ok = all(r["spearman_rho"] >= args.min_rho
             and (r["top_jaccard"] >= args.min_top_jaccard
                  or r["top_recall_2k"] >= 1.0)
             and r["finite_mismatch"] <= max_fd for r in rows)
    report = dict(config=args.config, num_samples=args.num_samples,
                  seed=cfg.sim_flags.seed, exact_method=args.exact_method,
                  fast_seconds=round(t_fast, 1),
                  exact_seconds=round(t_exact, 1),
                  device=(torch.cuda.get_device_name(device)
                          if device.type == "cuda" else "cpu"),
                  experiments=rows, ok=ok)
    print(json.dumps(report))
    if not ok:
        worst = min(r["spearman_rho"] for r in rows)
        print(f"FAIL: min rho {worst:.6f} (need >= {args.min_rho}) or "
              f"top-set/finiteness gate", file=sys.stderr)
        return 1
    print(f"PASS: min rho {min(r['spearman_rho'] for r in rows):.6f}, "
          f"min top-{args.top_frac:.0%} Jaccard "
          f"{min(r['top_jaccard'] for r in rows):.3f}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
