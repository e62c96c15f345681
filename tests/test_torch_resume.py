"""Checkpoint resume through the port's CLI, on every route a curve can
take: on-grid (the stride ladder), off-grid (slot tables), the
interpolation fallback, and adaptive tau routing stopped inside its fine
pass.  A run whose checkpoint write raises after chunk k is resumed with
``--resume``; its P and exported files equal an uninterrupted run's bit
for bit (mirroring tests/test_pipeline.py:147/:181/:216 and
tests/test_adaptive.py:72).  Per-sample Newton decisions make a resumed
chunk the same computation as the uninterrupted one, and a sample that
failed in a completed chunk is already NaN in the checkpoint, so resume
needs no curve-start baseline.  JAX-free.
"""
import functools
import logging

import numpy as np
import pytest
import torch

from bayesian_inference_trpl_tpu_torch import config as tcfg
from bayesian_inference_trpl_tpu_torch import run
from bayesian_inference_trpl_tpu_torch.parallel import runner as trunner
from bayesian_inference_trpl_tpu_torch.parallel.checkpoint import CheckpointManager
from bayesian_inference_trpl_tpu_torch.utils import io as bio

from test_torch_interp_bayes import (LOG_TIMES, T, TIME, make_config, sample_matrix,
                                     write_inputs)

torch.set_num_threads(1)

ON_GRID = np.arange(T + 1) * (TIME / T)


class Stop(Exception):
    pass


def _run_cli(tmp_path, cfg, name, *extra):
    path = tmp_path / f"{name}.toml"
    tcfg.save_config(cfg, str(path))
    try:
        return run.main([str(path), "--device", "cpu", "--log-dir",
                         str(tmp_path / "Logs"), *extra])
    finally:
        logging.getLogger("bayes-trpl-torch").handlers.clear()


def _outputs(root, num_exp):
    """The exported files' bytes, by name, and P (num_exp, n) and X as
    loaded from them (one output directory per experiment)."""
    dirs = [root / f"OUT{k}" for k in range(num_exp)]
    files = {p.name: p.read_bytes() for d in dirs for p in sorted(d.glob("*_BAYRAN_*"))}
    assert len(files) == 2 * num_exp
    loaded = [bio.load_bayran(str(d)) for d in dirs]
    return files, np.stack([P for P, _ in loaded]), loaded[0][1]


def _resume_equals_uninterrupted(tmp_path, monkeypatch, obs, exc, stop_at,
                                 grid=None, num_points=16):
    """Uninterrupted CLI run; a run stopped after the checkpoint of
    ``stop_at`` = (curve, next chunk); its ``--resume``.  Returns the
    Runner calls of the resumed run (method, start_chunk, offset)."""
    def cfg(root):
        c = make_config(tcfg, tmp_path, obs, exc, "OUT", grid=grid,
                        sim_flags=dict(num_points=num_points), checkpoint=True)
        c.paths.out_dirs = [str(tmp_path / root / f"OUT{k}") for k in range(len(obs))]
        return c

    assert _run_cli(tmp_path, cfg("ref"), "ref") == 0
    orig = CheckpointManager.save_progress

    def stopping(self, state, P):
        orig(self, state, P)
        if (state.curve_index, state.chunk_index) == stop_at:
            raise Stop(stop_at)
    monkeypatch.setattr(CheckpointManager, "save_progress", stopping)
    with pytest.raises(Stop):
        _run_cli(tmp_path, cfg("ckpt"), "ckpt")
    assert not list((tmp_path / "ckpt" / "OUT0").glob("*_BAYRAN_*"))
    monkeypatch.setattr(CheckpointManager, "save_progress", orig)

    calls = []
    for name in ("run_curve", "run_curve_offgrid", "run_curve_interp"):
        meth = getattr(trunner.Runner, name)

        def spy(self, *a, _meth=meth, _name=name, **k):
            calls.append((_name, k.get("start_chunk", 0), k.get("chunk_index_offset", 0)))
            return _meth(self, *a, **k)
        monkeypatch.setattr(trunner.Runner, name, functools.wraps(meth)(spy))
    assert _run_cli(tmp_path, cfg("ckpt"), "ckpt", "--resume") == 0
    (f_ref, P_ref, X_ref), (f_res, P_res, X_res) = (
        _outputs(tmp_path / d, len(obs)) for d in ("ref", "ckpt"))
    assert f_res == f_ref
    assert P_res.tobytes() == P_ref.tobytes() and X_res.tobytes() == X_ref.tobytes()
    return calls, P_ref, X_ref


def test_resume_on_grid(tmp_path, monkeypatch):
    obs, exc = write_inputs(tmp_path, [ON_GRID])
    calls, P, _ = _resume_equals_uninterrupted(tmp_path, monkeypatch, obs, exc,
                                               stop_at=(1, 2))
    assert calls == [("run_curve", 2, 0)]          # curve 1 from chunk 2 of 4
    assert np.isfinite(P).all()


def test_resume_off_grid(tmp_path, monkeypatch):
    obs, exc = write_inputs(tmp_path, [LOG_TIMES])
    calls, P, _ = _resume_equals_uninterrupted(tmp_path, monkeypatch, obs, exc,
                                               stop_at=(0, 3))
    assert calls == [("run_curve_offgrid", 3, 0), ("run_curve_offgrid", 0, 0)]
    assert np.isfinite(P).all()


def test_resume_interpolation(tmp_path, monkeypatch):
    """With a time beyond the horizon in the second experiment, its row
    of NaN comes back from the checkpoint as it was."""
    late = LOG_TIMES.copy()
    late[-1] = 1.25 * TIME
    obs, exc = write_inputs(tmp_path, [LOG_TIMES, late])
    calls, P, _ = _resume_equals_uninterrupted(tmp_path, monkeypatch, obs, exc,
                                               stop_at=(1, 1),
                                               grid=dict(offgrid_fused=False))
    assert calls == [("run_curve_interp", 1, 0)]
    assert np.isfinite(P[0]).all() and np.isnan(P[1]).all()


def test_resume_adaptive_inside_fine_pass(tmp_path, monkeypatch):
    """16 samples, chunk 4, the tau_n threshold at the median: the bulk pass
    has 2 chunks and the fine pass 2, sharing one checkpoint sequence; the
    run stops after the first fine chunk of curve 1 and resumes there."""
    obs, exc = write_inputs(tmp_path, [ON_GRID])
    c = make_config(tcfg, tmp_path, obs, exc, "X", sim_flags=dict(num_points=16))
    X = sample_matrix(c)
    tau = float(np.median(X[:, 9]))
    grid = dict(adaptive_fine_tau=tau, adaptive_fine_steps=24, adaptive_max_stride=4)
    calls, P, X_ref = _resume_equals_uninterrupted(tmp_path, monkeypatch, obs, exc,
                                                   stop_at=(1, 3), grid=grid)
    assert int((X_ref[:, 9] < tau).sum()) == 8
    assert calls == [("run_curve", 1, 2)]          # fine pass, its chunk 1
    assert np.isfinite(P).all()
