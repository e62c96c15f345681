"""The interpolation fallback's ``bayes`` against JAX ``bayes`` where the
JAX chunk program's static arguments change (each case compiles its own
program, so they live apart from tests/test_torch_interp_bayes.py for
xdist to spread): PL recorded every 2 steps, and the likelihood on linear
PL (sim_flags.log_pl false).  P within 1e-6 relative, same NaN pattern.
"""
import numpy as np
import torch

from test_torch_interp_bayes import LOG_TIMES, compare_with_jax, write_inputs

torch.set_num_threads(1)


def test_pl_stride_2(tmp_path, monkeypatch):
    obs, exc = write_inputs(tmp_path, [LOG_TIMES, LOG_TIMES])
    P = compare_with_jax(tmp_path, monkeypatch, obs, exc,
                         grid=dict(offgrid_fused=False, pl_stride=2))
    assert np.isfinite(P).all()


def test_log_pl_false(tmp_path, monkeypatch):
    obs, exc = write_inputs(tmp_path, [LOG_TIMES, LOG_TIMES])
    P = compare_with_jax(tmp_path, monkeypatch, obs, exc,
                         grid=dict(offgrid_fused=False),
                         sim_flags=dict(log_pl=False))
    assert np.isfinite(P).all()
