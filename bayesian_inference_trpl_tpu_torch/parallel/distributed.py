"""More than one process: one program over every process's devices.

The reference scaled out with independent SLURM array tasks, one process
per GPU, and never merged their result strides (bayeslib.py:231).  Here
every process runs the same ``bayes`` with the same seed, so every
process draws the identical sample matrix; rank r solves rows
[r c, (r + 1) c) of each global chunk on its own devices
(parallel/runner.py), and one gather per chunk puts the (num_exp, chunk)
likelihoods and the (chunk,) convergence flags back together in rank
order on every process.  Every process then holds the merged (X, P); only
the primary writes checkpoints and exports.  The JAX package's
``parallel/distributed.py`` does the same with ``jax.distributed``.

The gather runs on the host over ``gloo``, whatever device computes.  The
block is tiny (a few KB per experiment at chunk 1,024, once per chunk and
curve), the runner copies it to the host anyway, and next to a chunk's
tens of milliseconds of kernel it costs nothing.  NCCL is not used: it
wants one rank per GPU and refuses two ranks on one device, which is how
a one-card machine runs two processes.

Processes join through torchrun's environment (``MASTER_ADDR``,
``MASTER_PORT``, ``WORLD_SIZE``, ``RANK``; ``init_method="env://"``), as
in two processes on the CPU:

    python -m torch.distributed.run --nproc-per-node 2 \\
        -m bayesian_inference_trpl_tpu_torch.run cfg.toml --device cpu

``bayes`` calls :func:`maybe_initialize_from_env` first.  A process's
devices are the CUDA devices it sees, whatever its ``LOCAL_RANK``: for
one process per GPU give each its own card with ``CUDA_VISIBLE_DEVICES``
(as SLURM's ``--gpus-per-task`` does; README).  Processes that share a
card still give the one-process result, slower; :func:`check_layout`
names the shared cards and ``bayes`` logs a warning.  With one process
every function here is the identity.
"""
from __future__ import annotations

import collections
import datetime
import logging
import os

import numpy as np
import torch
import torch.distributed as dist

logger = logging.getLogger(__name__)

# How long the rendezvous and each gather may wait for the other
# processes before raising.  A chunk takes well under a second on the
# card; the first one also builds or loads the kernel library.
TIMEOUT_S = 600.0


def initialize() -> None:
    """Join the process group described by the environment (``env://``),
    over gloo.  Raises when the group does not form within TIMEOUT_S."""
    dist.init_process_group(backend="gloo", init_method="env://",
                            timeout=datetime.timedelta(seconds=TIMEOUT_S))
    logger.info("distributed: process %d of %d via %s:%s", dist.get_rank(),
                dist.get_world_size(), os.environ.get("MASTER_ADDR"),
                os.environ.get("MASTER_PORT"))


def maybe_initialize_from_env() -> bool:
    """Join the group when ``WORLD_SIZE`` > 1 is set.  Returns True when
    more than one process runs.  Idempotent: a second ``bayes`` call in
    the same process (config sweeps) finds the group formed."""
    if dist.is_initialized():
        return dist.get_world_size() > 1
    if int(os.environ.get("WORLD_SIZE", "1")) <= 1:
        return False
    initialize()
    return True


def process_index() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def process_count() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def is_primary() -> bool:
    """True on the process that owns host-side side effects (checkpoint
    writes, exports, the run log)."""
    return process_index() == 0


def broadcast_from_primary(tree):
    """Process 0's tuple of host values on every process (the resume
    point and the checkpointed P and X, which only the primary reads: the
    chunk loops of all processes must agree on them, or the per-chunk
    gather pairs different chunks).  Numpy arrays come back writable
    copies (the runner adds into the resumed P)."""
    if process_count() == 1:
        return tree
    objs = list(tree)
    dist.broadcast_object_list(objs, src=0)
    return tuple(np.array(o) if isinstance(o, np.ndarray) else o for o in objs)


def allgather_to_host(x: np.ndarray, axis: int = 0) -> np.ndarray:
    """Every process's ``x`` (same shape and dtype on each) concatenated
    along ``axis`` in rank order, on every process."""
    if process_count() == 1:
        return x
    x = np.ascontiguousarray(x)
    flat = torch.from_numpy(x.view(np.uint8) if x.dtype == np.bool_ else x)
    parts = [torch.empty_like(flat) for _ in range(process_count())]
    dist.all_gather(parts, flat)
    out = np.concatenate([p.numpy() for p in parts], axis=axis)
    return out.view(np.bool_) if x.dtype == np.bool_ else out


def check_layout(mesh) -> list:
    """Raise unless every process's mesh has as many entries as this one's
    (the layout of a global chunk assumes it).  Returns the UUIDs of this
    process's CUDA cards that another process uses too."""
    if process_count() == 1:
        return []
    cards = sorted({str(torch.cuda.get_device_properties(d).uuid)
                    for d in mesh if d.type == "cuda"})
    per_process = [None] * process_count()
    dist.all_gather_object(per_process, (len(mesh), cards))
    counts = [n for n, _ in per_process]
    if any(n != len(mesh) for n in counts):
        raise RuntimeError(f"every process must have the same number of "
                           f"devices; per process: {counts}")
    return shared_cards([c for _, c in per_process], cards)


def shared_cards(per_process, cards) -> list:
    """The entries of ``cards`` that more than one of ``per_process``
    (each process's distinct cards) holds."""
    users = collections.Counter(c for p in per_process for c in p)
    return [c for c in cards if users[c] > 1]
