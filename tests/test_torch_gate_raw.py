"""The port's ``run_gate`` against the JAX package's on the unperturbed
JAX exact curves (see tests/test_torch_gate.py for the setup).  Here the
rms values are the float32 ladder's own error (~4e-4), and the two float32
solvers differ by float32 rounding (the port's step loop and the JAX XLA
scan sum in different orders), so they agree absolutely: within 2e-6
decades, ~7x the largest difference measured here (3.0e-7 on the maxima,
0.07% of them; 3.0e-8 on the mean)."""
import numpy as np
import torch

from test_torch_gate import GATE, RMS_KEYS, gate_reports, jax_lp64  # noqa: F401

torch.set_num_threads(1)


def test_run_gate_matches_jax_raw_curves(jax_lp64):  # noqa: F811
    rt, rj = gate_reports(jax_lp64)
    for k in RMS_KEYS:
        np.testing.assert_allclose(rt[k], rj[k], rtol=0, atol=2e-6, err_msg=k)
    assert rj["non_converged"] == 0
