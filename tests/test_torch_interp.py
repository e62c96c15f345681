"""``ops/likelihood.interp_pl`` against the JAX package's (``jnp.interp``
with NaN outside the simulated range, vmapped over the batch), float64 and
float32, at the points the interpolation fallback meets: interior points,
points on the nodes, the last node, times before 0 and beyond the horizon
(NaN), and the time-0 padding of ragged experiments.  XLA contracts
fp[i-1] + r * df into one fused multiply-add where PyTorch rounds twice, so
the values agree within 1e-15 relative in float64 (2 ulp in float32), with
the same NaN positions.
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from bayesian_inference_trpl_tpu.ops.likelihood import interp_pl as jinterp
from bayesian_inference_trpl_tpu_torch.ops.likelihood import interp_pl as tinterp

torch.set_num_threads(1)

T, TIME = 64, 1.6
SIM_TIMES = np.linspace(0.0, TIME, T + 1)
rng = np.random.default_rng(21)
# log10-PL-like curves (the fallback interpolates log PL): decaying, < 0.
CURVES = (-2.0 - np.cumsum(rng.uniform(0.01, 0.2, (5, T + 1)), axis=1))
CASES = {
    "interior": rng.uniform(0.0, TIME, 40),
    "on_nodes": SIM_TIMES[[1, 7, 30, 63]],
    "last_node": np.array([TIME, SIM_TIMES[-2], 0.0]),
    "outside": np.array([-1e-9, -0.5, TIME * (1 + 1e-12), 2.0 * TIME, 0.3]),
    "padding": np.concatenate([np.geomspace(0.01, 1.5, 9), np.zeros(4)]),
}
TOL = {np.float64: 1e-15, np.float32: 2.4e-7}


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("case", sorted(CASES))
def test_interp_pl_matches_jnp_interp(case, dtype):
    x = CASES[case].astype(dtype)
    xp, fp = SIM_TIMES.astype(dtype), CURVES.astype(dtype)
    want = np.asarray(jinterp(jnp.asarray(xp), jnp.asarray(fp), jnp.asarray(x)))
    got = tinterp(torch.as_tensor(xp), torch.as_tensor(fp), torch.as_tensor(x)).numpy()
    assert got.shape == want.shape == (5, len(x)) and got.dtype == dtype
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    np.testing.assert_allclose(got, want, rtol=TOL[dtype], atol=0)
    outside = (x < xp[0]) | (x > xp[-1])
    assert np.isnan(got[:, outside]).all() and np.isfinite(got[:, ~outside]).all()
    if case == "on_nodes":
        idx = np.searchsorted(xp, x)
        np.testing.assert_array_equal(got, fp[:, idx])
    if case == "padding":
        np.testing.assert_array_equal(got[:, -4:], np.repeat(fp[:, :1], 4, 1))
