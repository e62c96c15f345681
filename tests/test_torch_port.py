"""The PyTorch port (bayesian_inference_trpl_tpu_torch): import isolation
from JAX, and the numpy copies of the JAX package's host-side helpers."""
import os
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from bayesian_inference_trpl_tpu.models import twophase as jtwo
from bayesian_inference_trpl_tpu.utils import sampling as jsamp
from bayesian_inference_trpl_tpu_torch.models import twophase as ttwo
from bayesian_inference_trpl_tpu_torch.utils import sampling as tsamp

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "bayesian_inference_trpl_tpu_torch"


def test_port_imports_without_jax():
    """Every module of the port imports with jax blocked (sys.modules
    entry None makes ``import jax`` raise)."""
    mods = sorted(
        "bayesian_inference_trpl_tpu_torch."
        + str((p.parent if p.name == "__init__.py" else p.with_suffix(""))
              .relative_to(PORT)).replace(os.sep, ".")
        for p in PORT.rglob("*.py") if p.parent != PORT or p.name != "__init__.py")
    code = ("import sys, importlib\n"
            "sys.modules['jax'] = None\n"
            f"for m in {mods!r}:\n"
            "    importlib.import_module(m)\n"
            "assert not any(k == 'bayesian_inference_trpl_tpu' or "
            "k.startswith('bayesian_inference_trpl_tpu.') for k in sys.modules)\n"
            "print('ok', len(sys.argv))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert len(mods) >= 30
    assert {"bayesian_inference_trpl_tpu_torch." + m for m in (
        "ops.kernel_lib", "ops.newton_kernel", "tools.accuracy_gate",
        "tools.posterior_equivalence", "models.oracle", "tools.sweep", "tools.run_sweep",
        "tools.compare", "tools.overlay", "tools.corner_cache",
        "tools.nonconverged", "native", "ops.histogram", "posterior", "posterior.stats",
        "posterior.data", "posterior.vizconfig", "posterior.plotting", "posterior.cli",
        "posterior.explorer", "tools.timeshift_demo")} <= set(mods)


def test_port_sources_name_no_jax():
    """No port source (nor chip_smoke.py) imports jax or the JAX package."""
    pat = re.compile(r"^\s*(import|from)\s+(jax\b|bayesian_inference_trpl_tpu(?!_torch)\b)",
                     re.M)
    files = list(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]
    bad = [str(f) for f in files if pat.search(f.read_text())]
    assert not bad, bad
    # The host parser's loader builds the port's own copy of the C++ source
    # (native/src/trpl_native.cpp) and names no path of the JAX package;
    # no C++ or CUDA source of the port includes a file of it.
    loader = PORT / "native" / "__init__.py"
    assert (PORT / "native" / "src" / "trpl_native.cpp").exists()
    assert '"src" / "trpl_native.cpp"' in loader.read_text()
    assert not re.search(r"bayesian_inference_trpl_tpu(?!_torch)", loader.read_text())
    include = re.compile(r'^\s*#\s*include\s*[<"]([^>"]+)[>"]', re.M)
    for src in [*PORT.rglob("*.cpp"), *PORT.rglob("*.cu"), *PORT.rglob("*.cuh")]:
        for name in include.findall(src.read_text()):
            assert "bayesian_inference_trpl_tpu/" not in name and ".." not in name, (src, name)


def test_make_grid_bitwise_equal_to_jax():
    min_x = np.array([1e8, 1e14, 0.0, 0.0, 1e-11, 0.1, 0.1, 1e-30, 1e-30, 1.0,
                      1.0, 0.1, 0.0])
    max_x = np.array([1e8, 1e16, 50.0, 50.0, 1e-9, 100.0, 100.0, 1e-28,
                      1e-28, 1000.0, 2000.0, 0.1, 0.0])
    do_log = [1, 1, 0, 0, 1, 1, 1, 1, 1, 0, 0, 1, 0]
    for flags in (dict(num_points=4096),
                  dict(num_points=257, override_equal_mu=True,
                       override_equal_s=True, override_equal_auger=True)):
        _, Pj, Xj = jsamp.make_grid(3, min_x, max_x, do_log, flags,
                                    rng=np.random.RandomState(42))
        _, Pt, Xt = tsamp.make_grid(3, min_x, max_x, do_log, flags,
                                    rng=np.random.RandomState(42))
        assert Xt.tobytes() == Xj.tobytes()
        assert Pt.shape == Pj.shape


def test_legacy_sampler_copies_equal_jax():
    """The numpy copies of the legacy coarse-grid sampler (index_grid,
    param_grid, refine_grid) and make_grid's random_sample = false branch
    return the JAX package's arrays bit for bit."""
    refs = [np.array([2, 3, 1]), np.array([2, 1, 2])]
    N = tsamp.refine_grid(tsamp.refine_grid(np.array([0]), refs[0])[1::2], refs[1])
    assert N.tobytes() == jsamp.refine_grid(
        jsamp.refine_grid(np.array([0]), refs[0])[1::2], refs[1]).tobytes()
    ind = tsamp.index_grid(N, refs)
    assert ind.tobytes() == jsamp.index_grid(N, refs).tobytes()
    args = (ind, refs, np.array([1.0, 0.0, 5.0]), np.array([100.0, 50.0, 5.0]),
            np.array([1, 0, 0]))
    assert tsamp.param_grid(*args).tobytes() == jsamp.param_grid(*args).tobytes()
    flags = dict(random_sample=False, num_points=3, override_equal_mu=True)
    box = (np.array([1e8, 1.0, 1.0, 2.0]), np.array([1e8, 50.0, 20.0, 2000.0]),
           [1, 0, 0, 0])
    _, _, Xt = tsamp.make_grid(1, *box, flags)
    _, _, Xj = jsamp.make_grid(1, *box, flags)
    assert Xt.shape == (27, 4) and Xt.tobytes() == Xj.tobytes()


@pytest.mark.parametrize("S", [8, 16, 32, 64])
def test_ladder_tables_equal_to_jax(S):
    np.testing.assert_array_equal(ttwo._lagrange_weight_table(S),
                                  jtwo._lagrange_weight_table(S))
    args = (80000, 256)
    kw = dict(base_stride=16, coarse_steps_per_phase=512, max_stride=S)
    assert ttwo.geometric_schedule(*args, **kw) == jtwo.geometric_schedule(*args, **kw)
