"""The port's sample mesh: a 4-device virtual CPU mesh against one device,
bit for bit, on every route a curve takes (mirroring tests/test_sharding.py
and the JAX dry run, __graft_entry__.py:67-197), and the port's mesh
against JAX's 8-device ``ShardedRunner``.

Every route of the port takes its Newton decisions per sample, so a
sample's result does not depend on the device or the batch that ran it:
the 4 x 2 layout equals the 1 x 8 one exactly, NaN for NaN.
"""
import dataclasses

import numpy as np
import pytest
import torch

from bayesian_inference_trpl_tpu.parallel.mesh import make_mesh as jmake_mesh
from bayesian_inference_trpl_tpu.parallel.runner import ShardedRunner
from bayesian_inference_trpl_tpu_torch import config as tcfg
from bayesian_inference_trpl_tpu_torch.models.driver import SimParams
from bayesian_inference_trpl_tpu_torch.parallel import distributed
from bayesian_inference_trpl_tpu_torch.parallel.checkpoint import CheckpointManager
from bayesian_inference_trpl_tpu_torch.parallel.mesh import make_mesh
from bayesian_inference_trpl_tpu_torch.parallel.runner import Runner
from bayesian_inference_trpl_tpu_torch.pipeline import bayes
from bayesian_inference_trpl_tpu_torch.tools import dryrun_multichip as dry
from bayesian_inference_trpl_tpu_torch.utils.validate import connect_to_devices

from test_sharding import _problem as jax_problem
from test_torch_multiprocess import make_config, write_inputs

torch.set_num_threads(1)

MESH4 = ["cpu"] * 4
CPD = 2                      # 4 x 2 against 1 x 8


def _both(run, *a, **kw):
    """``run(runner, ckpts, *a, **kw)`` on the 4-device mesh at 2 per
    device and on one device at 8; returns both (out, conv, ckpts)."""
    res = []
    for mesh, cpd in ((MESH4, CPD), (["cpu"], 4 * CPD)):
        runner = Runner(chunk=cpd, mesh=make_mesh(mesh))
        assert runner.chunk == 8 and runner.n_devices == len(mesh)
        ckpts = []
        out, conv = run(runner, ckpts, *a, **kw)
        res.append((out, conv, ckpts))
    return res


def _assert_bitwise(res_n, res_1):
    (out_n, conv_n, ck_n), (out_1, conv_1, ck_1) = res_n, res_1
    assert ck_n == ck_1
    np.testing.assert_array_equal(conv_n, conv_1)
    assert out_n.tobytes() == out_1.tobytes()


def _ongrid(runner, ckpts, prob, X, **kw):
    return runner.run_curve(X, prob.sim, prob.ini, prob.obs_vals, obs_mask=prob.obs_mask,
                            dtype=prob.dtype, chunk_done=lambda ci, ll: ckpts.append(ci),
                            **kw)


def _route(route):
    def run(runner, ckpts, prob):
        out, conv, ck, _ = dry.run_route(route, runner.mesh, runner.chunk_per_device, prob)
        ckpts.extend(ck)
        return out, conv
    return run


@pytest.fixture(scope="module")
def prob():
    """12 samples: no multiple of the chunk (8), so the second chunk is a
    ragged tail, two devices' shares of it padding alone."""
    return dry.problem(T=24, num=12, interp_num=12)


@pytest.mark.parametrize("route", dry.ROUTES)
def test_routes_four_devices_equal_one(prob, route):
    """On-grid ladder with a masked short curve, off-grid slot tables with
    a ragged curve, and the interpolation fallback with an experiment
    beyond the horizon (NaN on both meshes), over 2 chunks, the second a
    ragged tail whose padded rows leak into nothing."""
    res_n, res_1 = _both(_route(route), prob)
    assert dry.check_route(route, res_n + (0.0,), res_1 + (0.0,), 2)
    _assert_bitwise(res_n, res_1)
    assert res_n[0].shape == (2, 12)


def test_adaptive_subset(prob):
    """The adaptive routing's second pass: a subset of the samples, its
    columns scattered into ``out``, its chunk indices offset."""
    idx = np.array([10, 2, 7, 11, 0, 5])
    res_n, res_1 = _both(_ongrid, prob, prob.X, sample_idx=idx, chunk_index_offset=3)
    _assert_bitwise(res_n, res_1)
    assert res_n[2] == [3]
    untouched = np.setdiff1d(np.arange(12), idx)
    assert (res_n[0][:, untouched] == 0).all() and np.isfinite(res_n[0][:, idx]).all()


def test_start_chunk(prob):
    """Resume at chunk 1: chunk 0's columns keep what ``out`` held."""
    def run(runner, ckpts, prob):
        out = np.full((2, 12), 7.0)
        return _ongrid(runner, ckpts, prob, prob.X, out=out, start_chunk=1)
    res_n, res_1 = _both(run, prob)
    _assert_bitwise(res_n, res_1)
    assert res_n[2] == [1] and (res_n[0][:, :8] == 7.0).all()


def test_port_mesh_against_jax_sharded_runner():
    """The port's 4-device CPU mesh against JAX's 8-device ShardedRunner,
    method coupled_newton (an XLA scan, no Pallas), at test_sharding's
    problem: P within 1e-9 relative (tests/test_sharding.py:41), conv
    equal."""
    X, jsim, init_dn, obs = jax_problem(np.random.default_rng(1234), 16)
    jsim = dataclasses.replace(jsim, method="coupled_newton")
    P_j, conv_j = ShardedRunner(jmake_mesh(), chunk_per_device=2).run_curve(
        X, jsim, init_dn, obs)
    sim = SimParams(**{f.name: getattr(jsim, f.name) for f in dataclasses.fields(SimParams)})
    runner = Runner(chunk=4, mesh=make_mesh(MESH4))
    P_t, conv_t = runner.run_curve(X, sim, init_dn, obs, dtype=torch.float64)
    assert runner.chunk == 16
    np.testing.assert_array_equal(conv_t, np.asarray(conv_j))
    assert conv_t.all()
    np.testing.assert_allclose(P_t, np.asarray(P_j), rtol=1e-9, atol=1e-9)


def test_mesh_and_devices(monkeypatch):
    """connect_to_devices: the CPU n_devices times; on CUDA (four cards
    made visible here), None means every visible card, more than are
    visible raise, and none visible raises.  make_mesh refuses a mixed
    mesh; one process gathers and broadcasts nothing and shares no card;
    a card that two processes hold is shared."""
    dcfg = tcfg.DeviceConfig
    assert connect_to_devices(dcfg(n_devices=None), "cpu") == [torch.device("cpu")]
    assert connect_to_devices(dcfg(n_devices=3), "cpu") == [torch.device("cpu")] * 3
    assert make_mesh(["cpu"] * 2) == (torch.device("cpu"),) * 2
    with pytest.raises(ValueError):
        make_mesh(["cpu", "meta"])
    with pytest.raises(ValueError):
        connect_to_devices(dcfg(), "meta")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    cards = [torch.device("cuda", i) for i in range(4)]
    assert connect_to_devices(dcfg(), "cuda") == cards
    assert connect_to_devices(dcfg(n_devices=2), "cuda") == cards[:2]
    assert connect_to_devices(dcfg(), "cuda:3") == cards[3:]
    with pytest.raises(RuntimeError, match="requested 5 devices, only 4"):
        connect_to_devices(dcfg(n_devices=5), "cuda")
    assert make_mesh(connect_to_devices(dcfg(n_devices=3), "cuda")) == tuple(cards[:3])
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 0)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        connect_to_devices(dcfg(), "cuda")
    x = np.arange(6.0).reshape(2, 3)
    assert distributed.process_count() == 1 and distributed.is_primary()
    assert distributed.allgather_to_host(x, axis=1) is x
    assert distributed.broadcast_from_primary((x, 1)) == (x, 1)
    assert distributed.check_layout(make_mesh(MESH4)) == []
    assert distributed.shared_cards([["a", "b"], ["b"], []], ["a", "b"]) == ["b"]
    assert distributed.shared_cards([["a"], ["b"]], ["a"]) == []


def test_bayes_on_every_device_and_unported_method(tmp_path):
    """bayes with n_devices = None runs on every visible device (one CPU)
    and with n_devices = 3 on three; gauss_seidel (which raised naming
    ROADMAP A13 until it was ported) on three devices equals one device
    bit for bit."""
    obs, exc = write_inputs(tmp_path)
    cfg = make_config(tmp_path, obs, exc, "A", n_devices=None, num_points=4)
    _, _, info = bayes(cfg, device="cpu")
    assert info["num_devices"] == 1 and info["device"] == "cpu"
    cfg = make_config(tmp_path, obs, exc, "B", n_devices=3, num_points=4)
    _, _, info = bayes(cfg, device="cpu")
    assert info["num_devices"] == 3 and info["device"] == "cpu,cpu,cpu"
    res = []
    for out, n, cpd in (("GS3", 3, 2), ("GS1", 1, 6)):
        cfg = make_config(tmp_path, obs, exc, out, n_devices=n, num_points=4,
                          chunk_per_device=cpd)
        cfg.grid.method, cfg.grid.max_iters = "gauss_seidel", 300
        P, X, info = bayes(cfg, device="cpu")
        assert info["num_devices"] == n and np.isfinite(P).all()
        res.append((P, X))
    assert res[0][0].tobytes() == res[1][0].tobytes()
    assert res[0][1].tobytes() == res[1][1].tobytes()


class Stop(Exception):
    pass


@pytest.mark.parametrize("n_devices, chunk_per_device", [(2, 2), (2, 4)])
def test_resume_under_another_layout(tmp_path, monkeypatch, n_devices, chunk_per_device):
    """A checkpoint written on one device at chunk 4, stopped after chunk 0
    of curve 0, resumed on two: at 2 per device (the same global chunk)
    the result equals an uninterrupted run bit for bit; at 4 per device
    (global chunk 8, where chunk index 1 names other samples) it raises
    before any work."""
    obs, exc = write_inputs(tmp_path)

    def cfg(out, n, cpd, checkpoint):
        return make_config(tmp_path, obs, exc, out, n_devices=n, chunk_per_device=cpd,
                           num_points=8, checkpoint=checkpoint)
    P_ref, X_ref, _ = bayes(cfg("REF", 1, 4, False), device="cpu")
    orig = CheckpointManager.save_progress

    def stopping(self, state, P):
        orig(self, state, P)
        if (state.curve_index, state.chunk_index) == (0, 1):
            raise Stop
    monkeypatch.setattr(CheckpointManager, "save_progress", stopping)
    with pytest.raises(Stop):
        bayes(cfg("CK", 1, 4, True), device="cpu")
    monkeypatch.setattr(CheckpointManager, "save_progress", orig)
    resumed = cfg("CK", n_devices, chunk_per_device, True)
    if n_devices * chunk_per_device != 4:
        with pytest.raises(ValueError, match="global chunk of 4 samples, this run's is 8"):
            bayes(resumed, device="cpu")
        return
    P, X, info = bayes(resumed, device="cpu")
    assert info["num_devices"] == n_devices
    assert P.tobytes() == P_ref.tobytes() and X.tobytes() == X_ref.tobytes()
