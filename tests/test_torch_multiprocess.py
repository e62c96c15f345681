"""More than one process (parallel/distributed.py): two processes of two
CPU devices each run the port's ``bayes`` as one program over gloo, and
each ends with the merged (X, P) of an in-process 4-device run, bit for
bit; only the primary exports and checkpoints, and a run killed after its
first chunk resumes from the primary's checkpoint, broadcast to both
(mirroring tests/test_multiprocess.py).  JAX-free: the workers are plain
scripts that import torch and the port, and join through torchrun's
environment variables on a localhost port.
"""
import os
import socket
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from bayesian_inference_trpl_tpu_torch import config as tcfg
from bayesian_inference_trpl_tpu_torch import physics
from bayesian_inference_trpl_tpu_torch.parallel import distributed
from bayesian_inference_trpl_tpu_torch.parallel.checkpoint import CheckpointManager
from bayesian_inference_trpl_tpu_torch.pipeline import bayes
from bayesian_inference_trpl_tpu_torch.utils import io as bio

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
L, T, TIME = 32, 24, 0.6


def write_inputs(tmp_path, num_curves=2, seed=5):
    """Excitations for ``num_curves`` curves and one observation file on
    the simulation grid (t = k dt).  Returns ([obs file], excitation file)."""
    xg = (np.arange(L) + 0.5) * (311.0 / L)
    exc = tmp_path / "exc.csv"
    with open(exc, "w") as f:
        for c in range(num_curves):
            dn = (0.5 + c) * 1e18 / 1e7 ** 3 * np.exp(-xg / 100.0)
            f.write(",".join(f"{v / 1e-21:.8e}" for v in dn) + "\n")
    rng = np.random.default_rng(seed)
    t = np.arange(T + 1) * (TIME / T)
    obs = tmp_path / "obs.csv"
    with open(obs, "w") as f:
        for c in range(num_curves):
            pl = 2e-3 * (1 + c) * np.exp(-t / (0.3 + c)) * (1 + 0.01 * rng.standard_normal(t.size))
            f.write("".join(f"{float(ti)!r},{pi / 1e-23:.10e},1e13\n" for ti, pi in zip(t, pl)))
        f.write("END,,\n")
    return [str(obs)], str(exc)


def make_config(tmp_path, obs, exc, out, n_devices=2, num_points=16, chunk_per_device=2,
                checkpoint=False):
    """The stride ladder (8 fine steps, strides 2 and 4), float64, chunk
    ``chunk_per_device`` per device."""
    return tcfg.InferenceConfig(
        grid=tcfg.GridConfig(thickness=311.0, time=TIME, num_nodes=L, num_steps=T,
                             tol_exp=7, max_iters=8, method="fused_horizon_chord",
                             predictor="quadratic", step_tol=1e-9, fast_fine_steps=8,
                             fast_coarse_stride=2, fast_max_stride=4,
                             fast_steps_per_phase=4),
        params=tcfg.ParamSpace(
            min_x=[1e8, 1e14, 1.0, 1.0, 1e-11, 1.0, 1.0, 1e-30, 1e-30, 20.0, 20.0, 0.1, -0.5],
            max_x=[1e8, 1e16, 50.0, 50.0, 1e-9, 100.0, 100.0, 1e-28, 1e-28, 1000.0, 2000.0,
                   0.1, 0.5]),
        ic_flags=tcfg.IcFlags(time_cutoff=None),
        sim_flags=tcfg.SimFlags(num_points=num_points, seed=42),
        device=tcfg.DeviceConfig(chunk_per_device=chunk_per_device, n_devices=n_devices,
                                 dtype="float64"),
        paths=tcfg.Paths(init_file=exc, observation_files=obs,
                         out_dirs=[str(tmp_path / out)]),
        checkpoint=checkpoint, resume=checkpoint)


def _free_port():
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


_WORKER = textwrap.dedent("""
    import os, sys
    sys.path.insert(0, sys.argv[1])
    import numpy as np
    import torch
    torch.set_num_threads(1)
    from bayesian_inference_trpl_tpu_torch.config import load_config
    from bayesian_inference_trpl_tpu_torch.parallel import runner
    from bayesian_inference_trpl_tpu_torch import pipeline

    rank = int(os.environ["RANK"])
    exports = []
    orig_export = pipeline.bio.export
    pipeline.bio.export = lambda *a, **k: (exports.append(a[0]), orig_export(*a, **k))
    if sys.argv[4] == "kill":
        # Die right after the first chunk is gathered (and, on the primary,
        # checkpointed), at the same point in both processes.
        orig_run = runner.Runner._run
        def _run(self, chunk_fn, X, sim, ini, num_exp, dtype, progress, chunk_done,
                 *a, **k):
            def done(ci, ll):
                chunk_done(ci, ll)
                raise SystemExit(17)
            return orig_run(self, chunk_fn, X, sim, ini, num_exp, dtype, progress, done,
                            *a, **k)
        runner.Runner._run = _run
    P, X, info = pipeline.bayes(load_config(sys.argv[2]), device="cpu")
    assert info["num_devices"] == 4, info
    np.savez(sys.argv[3] + f".proc{rank}.npz", P=P, X=X)
    print("WORKER_OK", rank, "exports", len(exports))
""")


def _run_workers(tmp_path, cfg, mode):
    """Both workers on ``cfg``; returns [(returncode, output)] by rank."""
    cfg_path = tmp_path / "mp.toml"
    tcfg.save_config(cfg, str(cfg_path))
    worker = tmp_path / "worker.py"
    worker.write_text(_WORKER)
    env = dict(os.environ, MASTER_ADDR="localhost", MASTER_PORT=str(_free_port()),
               WORLD_SIZE="2", OMP_NUM_THREADS="1")
    procs = [subprocess.Popen([sys.executable, str(worker), REPO, str(cfg_path),
                               str(tmp_path / "mp_out"), mode],
                              env=dict(env, RANK=str(r)), stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT)
             for r in range(2)]
    try:
        outs = [p.communicate(timeout=120)[0].decode() for p in procs]
    finally:
        for p in procs:
            p.kill()
    return [(p.returncode, o) for p, o in zip(procs, outs)]


def _check_merged(tmp_path, results, P_ref, X_ref, num_exp):
    for rank, (rc, out) in enumerate(results):
        assert rc == 0, f"rank {rank}:\n{out[-3000:]}"
        assert f"WORKER_OK {rank} exports {num_exp if rank == 0 else 0}" in out, out[-3000:]
        d = np.load(tmp_path / f"mp_out.proc{rank}.npz")
        assert d["X"].tobytes() == X_ref.tobytes()
        assert d["P"].tobytes() == P_ref.tobytes()
    P_mp, X_mp = bio.load_bayran(str(tmp_path / "MP"))
    assert P_mp.tobytes() == P_ref[0].tobytes() and X_mp.tobytes() == X_ref.tobytes()


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    """The inputs, and an uninterrupted in-process run on 4 CPU devices
    (one curve, 2 chunks of 8); checkpointing does not change P."""
    tmp_path = tmp_path_factory.mktemp("mp")
    obs, exc = write_inputs(tmp_path, num_curves=1)
    P_ref, X_ref, info = bayes(make_config(tmp_path, obs, exc, "SP", n_devices=4),
                               device="cpu")
    assert info["num_devices"] == 4 and np.isfinite(P_ref).all()
    return obs, exc, P_ref, X_ref


def test_two_processes_equal_four_devices(tmp_path, reference):
    """2 processes x 2 CPU devices against one process of 4: the merged
    X and P on both processes bitwise equal; only rank 0 exported."""
    obs, exc, P_ref, X_ref = reference
    results = _run_workers(tmp_path, make_config(tmp_path, obs, exc, "MP"), "run")
    _check_merged(tmp_path, results, P_ref, X_ref, 1)


def test_two_processes_killed_and_resumed(tmp_path, reference):
    """Both processes die after chunk 0 of curve 0 (rc 17); the primary's
    checkpoint is at (0, 1); the resumed run's merged result equals an
    uninterrupted in-process 4-device run bit for bit."""
    obs, exc, P_ref, X_ref = reference
    cfg = make_config(tmp_path, obs, exc, "MP", checkpoint=True)
    for rank, (rc, out) in enumerate(_run_workers(tmp_path, cfg, "kill")):
        assert rc == 17, f"rank {rank}: rc {rc}\n{out[-3000:]}"
    st, P_ck, X_ck, _ = CheckpointManager(str(tmp_path / "MP")).load()
    assert (st.curve_index, st.chunk_index) == (0, 1) and st.chunk == 8
    assert (X_ck / physics.UNIT_CONVERSIONS).tobytes() == X_ref.tobytes()
    assert np.isfinite(P_ck[:, :8]).all() and (P_ck[:, 8:] == 0).all()
    results = _run_workers(tmp_path, cfg, "resume")
    _check_merged(tmp_path, results, P_ref, X_ref, 1)


def test_world_that_cannot_form_raises(monkeypatch):
    """WORLD_SIZE 2 with no peer: the rendezvous times out and raises; it
    does not hang and does not fall back to one process."""
    for k, v in dict(MASTER_ADDR="localhost", MASTER_PORT=str(_free_port()),
                     WORLD_SIZE="2", RANK="0").items():
        monkeypatch.setenv(k, v)
    monkeypatch.setattr(distributed, "TIMEOUT_S", 1.0)
    with pytest.raises(torch.distributed.DistError):
        distributed.maybe_initialize_from_env()
    assert not torch.distributed.is_initialized() and distributed.process_count() == 1


def test_profile_trace_on_the_cpu(tmp_path):
    """[device] profile_dir on the CPU: a Chrome trace of simulate with CPU
    events, named by the process index."""
    import json
    obs, exc = write_inputs(tmp_path, num_curves=1)
    cfg = make_config(tmp_path, obs, exc, "PR", n_devices=1, num_points=2)
    cfg.device.profile_dir = str(tmp_path / "trace")
    bayes(cfg, device="cpu")
    assert sorted(os.listdir(tmp_path / "trace")) == ["trace_rank0.json"]
    with open(tmp_path / "trace" / "trace_rank0.json") as f:
        events = json.load(f)["traceEvents"]
    names = {e.get("name") for e in events}
    assert "simulate" in names
    assert any(e.get("cat") == "cpu_op" for e in events)
    assert not any(e.get("cat") == "kernel" for e in events)
