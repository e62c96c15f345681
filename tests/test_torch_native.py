"""The port's host CSV parser (bayesian_inference_trpl_tpu_torch/native) and
``get_data``'s native route against the JAX package's: the parsed arrays
and every curve bitwise equal to JAX ``native.parse_obs_csv`` / ``get_data``
and to the port's own ``csv.reader`` route (``_read_rows``, which
get_data takes for a file the parser refuses)."""
import numpy as np
import pytest
import torch

from bayesian_inference_trpl_tpu import native as jnative
from bayesian_inference_trpl_tpu.utils import io as jio
from bayesian_inference_trpl_tpu_torch import native as tnative
from bayesian_inference_trpl_tpu_torch.utils import io as tio

torch.set_num_threads(1)


def _rows(rng, curves=3, points=40):
    """Rows (t, PL, sigma) of several decays, each starting at t = 0, with
    values that need all 17 significant digits and exponents both ways."""
    out = []
    for c in range(curves):
        t = np.concatenate([[0.0], np.sort(rng.uniform(1e-3, 2000.0, points - 1))])
        pl = 10 ** rng.uniform(12, 17, points) * (1 + c)
        unc = pl * rng.uniform(1e-3, 1e-1, points)
        out += list(zip(t, pl, unc))
    return out


def _write(path, rows, newline="\n", end=True, trailing_newline=True, blank_every=0,
           fmt=repr):
    lines = []
    for k, r in enumerate(rows):
        lines.append(",".join(fmt(float(v)) for v in r))
        if blank_every and k % blank_every == blank_every - 1:
            lines.append("")
    if end:
        lines += ["END,,", "9,9,9"]          # rows past the sentinel are ignored
    text = newline.join(lines) + (newline if trailing_newline else "")
    with open(path, "w", newline="") as f:
        f.write(text)
    return str(path)


CASES = {
    "curves_end": dict(),
    "crlf_blank_lines": dict(newline="\r\n", blank_every=7),
    "no_trailing_newline": dict(trailing_newline=False),
    "no_end_sentinel": dict(end=False, trailing_newline=False),
    "e_notation": dict(fmt=lambda v: f"{v:.10e}"),
}


def _row_route(files, flags, sflags, rng=None):
    """The port's csv.reader route on each file, with get_data's options."""
    args = tio._curve_args(flags, sflags, rng=rng)
    return [tio._read_rows(f, *args) for f in files]


def _same(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        assert x.dtype == y.dtype == np.float64
        assert x.tobytes() == y.tobytes()


def _same_data(d1, d2):
    assert len(d1) == len(d2)
    for f1, f2 in zip(d1, d2):
        for c1, c2 in zip(f1, f2):        # times, values, uncertainties
            _same(c1, c2)


@pytest.mark.parametrize("case", sorted(CASES))
def test_parser_bitwise_equal_to_jax_and_csv_route(tmp_path, case):
    path = _write(tmp_path / "obs.csv", _rows(np.random.default_rng(3)), **CASES[case])
    parsed = tnative.parse_obs_csv(path)
    _same(parsed, jnative.parse_obs_csv(path))
    assert len(parsed[0]) == 120
    flags, sflags = {"time_cutoff": None}, {"log_pl": False}
    nat = tio.get_data([path], flags, sflags)
    _same_data(nat, _row_route([path], flags, sflags))
    _same_data(nat, jio.get_data([path], flags, sflags, use_native=True))
    assert len(nat[0][0]) == 3


def test_header_row_is_code_minus_2(tmp_path):
    """A header row is not numeric: both parsers refuse it (code -2), and
    both packages' get_data then read it row by row, which raises on it."""
    path = tmp_path / "obs.csv"
    _write(path, _rows(np.random.default_rng(4), curves=1))
    path.write_text("t,PL,sigma\n" + path.read_text())
    for parse in (tnative.parse_obs_csv, jnative.parse_obs_csv):
        with pytest.raises(ValueError, match="code -2"):
            parse(str(path))
    for get_data in (tio.get_data, jio.get_data):
        with pytest.raises(ValueError):
            get_data([str(path)], {}, {})


def test_quoted_fields_fall_back_to_row_parser(tmp_path):
    """Quoted fields are refused by the byte scan (code -2) and read by
    csv.reader: the result equals the csv route's and JAX's, bitwise."""
    path = _write(tmp_path / "obs.csv", _rows(np.random.default_rng(5), curves=2),
                  fmt=lambda v: f'"{v!r}"')
    with pytest.raises(ValueError, match="code -2"):
        tnative.parse_obs_csv(path)
    flags, sflags = {"time_cutoff": 1000.0}, {}
    nat = tio.get_data([path], flags, sflags)
    _same_data(nat, _row_route([path], flags, sflags))
    _same_data(nat, jio.get_data([path], flags, sflags))
    assert len(nat[0][0]) == 2


FLAGS = {
    "cutoff_log": ({"time_cutoff": 1500.0}, {"log_pl": True}),
    "select_normalize": ({"time_cutoff": 2000.0, "select_obs_sets": [2, 0]},
                         {"log_pl": True, "self_normalize": True}),
    "noise": ({"time_cutoff": None, "noise_level": 1e14}, {"log_pl": True}),
    "linear": ({"time_cutoff": 500.0, "select_obs_sets": [1]}, {"log_pl": False}),
}


@pytest.mark.parametrize("name", sorted(FLAGS))
def test_get_data_native_equal_to_jax(tmp_path, name):
    """Two files; the same time_cutoff, select_obs_sets, noise seed and
    self_normalize on both packages' native routes: bitwise equal."""
    rng = np.random.default_rng(6)
    files = [_write(tmp_path / f"obs{k}.csv", _rows(rng), newline=nl)
             for k, nl in enumerate(("\n", "\r\n"))]
    flags, sflags = FLAGS[name]
    port = tio.get_data(files, flags, sflags, rng=np.random.default_rng(11))
    _same_data(port, jio.get_data(files, flags, sflags, rng=np.random.default_rng(11)))
    _same_data(port, _row_route(files, flags, sflags, rng=np.random.default_rng(11)))


def test_build_failure_raises(tmp_path, monkeypatch):
    """A source the compiler refuses raises at first use, and get_data's
    native route raises with it rather than falling back."""
    bad = tmp_path / "broken.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(tnative, "_SRC", bad)
    monkeypatch.setattr(tnative, "_BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(tnative, "_lib", None)
    path = _write(tmp_path / "obs.csv", _rows(np.random.default_rng(7), curves=1))
    with pytest.raises(RuntimeError, match="failed"):
        tnative.parse_obs_csv(path)
    with pytest.raises(RuntimeError, match="failed"):
        tio.get_data([path], {}, {})
    assert not list((tmp_path / "build").glob("*.so"))


def test_missing_file_raises(tmp_path):
    with pytest.raises(FileNotFoundError):
        tnative.parse_obs_csv(str(tmp_path / "absent.csv"))
    with pytest.raises(FileNotFoundError):
        tio.get_data([str(tmp_path / "absent.csv")], {}, {})


def test_library_builds_under_build_from_port_source():
    """The port loads its own build (build/trpl_native/, named by a hash of
    its source and flags), never the JAX package's library."""
    root = tnative._BUILD_DIR.parents[1]
    path = tnative.build()
    assert path.parent == root / "build" / "trpl_native"
    assert path.name.endswith("-libtrpl_native.so")
    assert tnative._SRC == (root / "bayesian_inference_trpl_tpu_torch" / "native" / "src"
                            / "trpl_native.cpp")
    assert tnative.build() == path
