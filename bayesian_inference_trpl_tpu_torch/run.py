"""Command-line inference entry point.

Usage:
    python -m bayesian_inference_trpl_tpu_torch.run config.toml [--resume] \
        [--num-points N] [--log-dir Logs] [--device cuda|cpu]

The configuration format is the JAX package's (examples/*.toml).  The run
goes on every visible GPU (``[device] n_devices`` caps them) unless
``--device cpu`` is given.  With ``checkpoint = true`` it checkpoints after
every chunk into the first output directory; ``--resume`` (or ``resume =
true``) continues from that checkpoint.  Under torchrun every process runs
this same command (parallel/distributed.py), here on the CPU:

    python -m torch.distributed.run --nproc-per-node 2 \
        -m bayesian_inference_trpl_tpu_torch.run config.toml --device cpu

and only process 0 writes the run log under ``--log-dir``; the others log
to stderr, their rank in each line.  On the card each process uses every
GPU it sees: for one process per GPU set ``CUDA_VISIBLE_DEVICES`` per
process (README); processes that share a card log a warning.
"""
from __future__ import annotations

import argparse
import json
import logging
import os
from datetime import datetime

from .config import dump_config, load_config
from .parallel import distributed as dist
from .pipeline import bayes


def start_logging(log_dir: str = "Logs", rank: int = 0):
    """Timestamped file + stderr logging (reference:
    parallel_bayes_gpu.py:37-57); a process other than the primary
    (``rank`` > 0) logs to stderr only, its rank in each line."""
    logger = logging.getLogger("bayes-trpl-torch")
    logger.setLevel(logging.DEBUG)
    prefix = f"[rank {rank}] " if rank else ""
    fmt = logging.Formatter(fmt=prefix + "%(asctime)s %(levelname)s: %(message)s",
                            datefmt="%Y-%m-%d %H:%M:%S")
    if not rank:
        os.makedirs(log_dir, exist_ok=True)
        tstamp = str(datetime.now()).replace(":", "-").replace(" ", "_")
        fh = logging.FileHandler(os.path.join(log_dir, f"{tstamp}.log"))
        fh.setFormatter(fmt)
        logger.addHandler(fh)
    sh = logging.StreamHandler()
    sh.setLevel(logging.INFO)
    sh.setFormatter(fmt)
    logger.addHandler(sh)
    return logger


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("config", help="TOML inference config")
    ap.add_argument("--resume", action="store_true",
                    help="resume from the checkpoint in the output dir")
    ap.add_argument("--num-points", type=int, default=None)
    ap.add_argument("--log-dir", default="Logs")
    ap.add_argument("--device", default="cuda",
                    help="device type to run on: every visible GPU (cuda, the "
                         "default; cuda:i for one) or the CPU (cpu)")
    ap.add_argument("--dump-config", action="store_true",
                    help="print the resolved config and exit")
    args = ap.parse_args(argv)

    cfg = load_config(args.config)
    if args.resume:
        cfg.resume = True
    if args.num_points is not None:
        cfg.sim_flags.num_points = args.num_points
    if args.dump_config:
        print(dump_config(cfg))
        return 0

    dist.maybe_initialize_from_env()
    logger = start_logging(args.log_dir, dist.process_index())
    logger.info("Config: %s", args.config)
    P, X, info = bayes(cfg, logger=logger, device=args.device)
    logger.info("Done: %s", json.dumps(info))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
