"""Pay a configuration's first-run cost up front.

The port compiles nothing per shape: its first-run cost is building the
CUDA kernel library (ops/kernel_lib.build_library: one ``nvcc`` per
source part, all in parallel; 24-39 s on an NVIDIA H100 80GB HBM3 at
700 W) the first time a kernel launches after a change to csrc/ or to
the compiler flags, plus the first launches themselves.  The library is
kept under build/ with a hash of its sources and flags in its name, so a
later run of the same tree loads it in a fraction of a second.  This tool
pays that cost at install time instead of inside a production run: it
runs the given config's inference pipeline on exactly ONE chunk of
samples per curve (chunk_per_device x devices, drawn at random whatever
the config's sampler), with checkpointing off and its output written to
a temporary directory that is removed afterwards, and prints the seconds
it took.

Usage (once after install or after changing csrc/):

    python -m bayesian_inference_trpl_tpu_torch.tools.warmup examples/power_scan.toml

``--device cpu`` runs the kernels' plain versions on the CPU (nothing is
built there).
"""
from __future__ import annotations

import argparse
import sys
import tempfile
import time


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("config", help="production config TOML")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="run on the card (default) or on the CPU")
    args = ap.parse_args(argv)

    from ..config import load_config
    from ..ops import kernel_lib
    from ..pipeline import bayes
    from ..utils.validate import connect_to_devices

    cfg = load_config(args.config)
    n_dev = len(connect_to_devices(cfg.device, args.device))
    chunk = cfg.device.chunk_per_device * n_dev
    # Exactly one chunk per curve; the legacy grid's num_points counts
    # cells per free dimension, so the chunk is drawn at random instead
    # (the same kernels run).
    cfg.sim_flags.random_sample = True
    cfg.sim_flags.num_points = chunk
    cfg.checkpoint = False
    cfg.resume = False
    with tempfile.TemporaryDirectory() as td:
        cfg.paths.out_dirs = [td]
        t0 = time.time()
        bayes(cfg, device=args.device)
        secs = time.time() - t0
    build = kernel_lib.build_info.get("seconds")
    print(f"warmup: one chunk per curve of {args.config} in {secs:.1f}s "
          f"(chunk={chunk}, devices={n_dev}, device={args.device}"
          + ("" if build is None else f"; kernel library build {build:.1f}s") + ")")
    return 0


if __name__ == "__main__":
    sys.exit(main())
