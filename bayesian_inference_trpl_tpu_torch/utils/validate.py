"""Startup validation of inputs (reference: bayes_validate.py:10-55); a copy
of the JAX package's checks."""
from __future__ import annotations

import numpy as np
import torch


def validate_ic(ics, L: int):
    for ic in ics:
        if len(ic) != L:
            raise ValueError(f"IC length {len(ic)} != declared L {L}")


def validate_ic_flags(ic_flags):
    tc = ic_flags.time_cutoff
    if tc is not None:
        if not isinstance(tc, (int, float)) or tc <= 0:
            raise ValueError("invalid time cutoff")
    sel = ic_flags.select_obs_sets
    if sel is not None and not isinstance(sel, list):
        raise ValueError("invalid observation set selection")
    nl = ic_flags.noise_level
    if nl is not None and not isinstance(nl, (int, float)):
        raise ValueError("invalid noise level")


def validate_params(num_params: int, unit_conversions, do_log, min_x, max_x):
    if len(unit_conversions) != num_params:
        raise ValueError("unit conversion array is missing entries")
    if len(do_log) != num_params:
        raise ValueError("do_log mask is missing values")
    if len(min_x) != num_params or len(max_x) != num_params:
        raise ValueError("missing min/max param values")
    if not np.all(np.asarray(min_x) <= np.asarray(max_x)):
        raise ValueError("min params larger than max params")


SOLVER_METHODS = ("gauss_seidel", "coupled_newton", "coupled_newton_pallas",
                  "fused_horizon", "fused_horizon_chord")
PREDICTORS = ("previous", "linear", "quadratic", "geometric")


def validate_solver(method: str, predictor: str):
    """Fail fast on solver knobs before any sampling or IO work."""
    if method not in SOLVER_METHODS:
        raise ValueError(f"unknown solver method {method!r}; "
                         f"choose one of {SOLVER_METHODS}")
    if predictor not in PREDICTORS:
        raise ValueError(f"unknown Newton predictor {predictor!r}; "
                         f"choose one of {PREDICTORS}")


def connect_to_devices(device_cfg, device="cuda"):
    """This process's devices; replaces ``connect_to_gpu`` (reference:
    bayes_validate.py:45-55) as the JAX package's ``connect_to_devices``
    does.  ``device="cuda"``: the first ``device_cfg.n_devices`` visible
    CUDA devices, all of them when it is None; asking for more than are
    visible raises.  A CUDA device with an index is that device alone.
    ``device="cpu"``: the CPU ``n_devices`` times (default once), a
    virtual mesh whose devices share the host."""
    device = torch.device(device)
    n = device_cfg.n_devices
    if device.type == "cpu":
        return [device] * (n or 1)
    if device.type != "cuda":
        raise ValueError(f"unsupported device {device}: cuda or cpu")
    visible = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if visible == 0:
        raise RuntimeError("CUDA requested but no CUDA device is available "
                           "(pass device='cpu' to run on the CPU)")
    if device.index is not None:
        if n not in (None, 1):
            raise ValueError(f"n_devices = {n} with the single device {device}")
        return [device]
    n = visible if n is None else int(n)
    if not 1 <= n <= visible:
        raise RuntimeError(f"requested {n} devices, only {visible} present")
    return [torch.device("cuda", i) for i in range(n)]
