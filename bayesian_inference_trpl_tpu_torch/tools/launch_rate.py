"""The host's launch rate on the card.

    python -m bayesian_inference_trpl_tpu_torch.tools.launch_rate

Prints one JSON object: microseconds per launch of a fixed loop of
one-element ``add_`` launches (launch-bound: each kernel takes ~2 us),
timed ``repeats`` times, each loop ended by a synchronize; ``min`` is the
fastest loop (the rate with the least interference from the rest of the
host, which a one-card machine shares) and ``median`` the middle one.
chip_smoke.py's ``main_profile`` reads it in a fresh process beside the
rates it reads in its own process with :func:`launch_us`.  It needs CUDA.
"""
from __future__ import annotations

import json
import statistics
import time

import torch

LAUNCHES = 2000
REPEATS = 25


def launch_us(launches: int = LAUNCHES, repeats: int = REPEATS, device="cuda") -> dict:
    """{"min", "median"} microseconds per launch over ``repeats`` loops of
    ``launches`` one-element adds."""
    x = torch.zeros(1, device=device)
    for _ in range(100):
        x.add_(1.0)
    torch.cuda.synchronize(device)
    times = []
    for _ in range(repeats):
        t0 = time.perf_counter()
        for _ in range(launches):
            x.add_(1.0)
        torch.cuda.synchronize(device)
        times.append((time.perf_counter() - t0) / launches * 1e6)
    return {"min": min(times), "median": statistics.median(times)}


def main():
    if not torch.cuda.is_available():
        raise SystemExit("launch_rate: CUDA is not available")
    out = {"device": torch.cuda.get_device_name(0), "rate": launch_us()}
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
