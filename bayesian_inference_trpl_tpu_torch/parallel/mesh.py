"""The sample mesh: the devices one process runs its chunks on.

The workload is embarrassingly parallel over parameter samples, so the
parallelism is data parallelism over a 1-D sample axis: each device of
the mesh solves its share of every chunk, with no communication inside
the solve; the per-chunk likelihoods come back to the host and are merged
there (parallel/distributed.py across processes).  This replaces the
reference's one-process-per-GPU SLURM strides (reference: bayeslib.py:131,
:231), as the JAX package's ``parallel/mesh.py`` does.

A mesh is a tuple of ``torch.device``, in the order the devices take the
rows of a chunk.  It may name one device more than once: ``("cpu",) * 4``
is a four-device mesh on the CPU (the counterpart of the JAX tests'
``--xla_force_host_platform_device_count``), and ``(cuda:0, cuda:0)``
splits every chunk into two launches on one card.
"""
from __future__ import annotations

from typing import Sequence

import torch


def make_mesh(devices: Sequence) -> tuple:
    """A 1-D sample mesh over ``devices`` (anything ``torch.device``
    takes; ``utils/validate.connect_to_devices`` lists a process's
    devices).  All are CUDA or all are CPU; a CUDA device given without
    an index is the current one."""
    mesh = []
    for d in devices:
        d = torch.device(d)
        if d.type == "cuda" and d.index is None:
            d = torch.device("cuda", torch.cuda.current_device())
        mesh.append(d)
    kinds = {d.type for d in mesh}
    if not mesh or len(kinds) > 1 or not kinds <= {"cuda", "cpu"}:
        raise ValueError(f"make_mesh: a mesh is one or more CUDA devices or "
                         f"one or more CPU devices, got {mesh}")
    return tuple(mesh)


def synchronize(mesh) -> None:
    """Wait for the work queued on every CUDA device of ``mesh``."""
    for dev in dict.fromkeys(mesh):
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
