"""Observation/excitation CSV ingest and BAYRAN result export.

Reproduces the reference's data-format semantics exactly
(reference: bayes_io.py:15-140):

* Observation files are 3-column CSV rows ``t, PL, sigma``; a new curve
  starts at every ``t == 0`` row and the file ends with an ``END`` sentinel
  row.
* PL and sigma scale by ``scale_f`` (1e-23: [cm^-2 s^-1] -> [nm^-2 ns^-1]);
  optional Gaussian noise injection, time cutoff, per-curve
  self-normalization; log10 with a clamp at ``sys.float_info.min`` and
  sigma -> sigma / PL / 2.3 when comparing in log space.
* Excitation files hold one row of L node densities per curve, scaled by
  1e-21 ([cm^-3] -> [nm^-3]).
"""
from __future__ import annotations

import csv
import os
import sys
from typing import Sequence

import numpy as np

from ..native import parse_obs_csv

BVAL_CUTOFF = sys.float_info.min


def _finish_curve(next_t, next_pl, next_unc, scale_f, noise_level, normalize,
                  log_pl, rng, logger):
    t = np.array(next_t, dtype=float)
    pl = np.array(next_pl, dtype=float) * scale_f
    if noise_level is not None:
        pl = pl + noise_level * scale_f * rng.standard_normal(len(pl))
    unc = np.array(next_unc, dtype=float) * scale_f
    if normalize and len(pl):
        pl = pl / pl.max()
    if log_pl:
        if logger is not None:
            logger.info("Num exp points affected by cutoff: %d",
                        int(np.sum(pl < BVAL_CUTOFF)))
        pl = np.abs(pl)
        pl[pl < BVAL_CUTOFF] = BVAL_CUTOFF
        unc = unc / pl / 2.3  # log10 error propagation (bayes_io.py:75-76)
        pl = np.log10(pl)
    return t, pl, unc


def get_data(exp_files: Sequence[str], ic_flags: dict, sim_flags: dict,
             logger=None, scale_f: float = 1e-23, rng=None):
    """Load observation files.  Returns, per file, a tuple
    (times, values, uncertainties) of per-curve arrays.

    Each file's bytes are scanned by the host C++ parser
    (native/src/trpl_native.cpp, built at first use; a failed build
    raises); a file it rejects as not numeric (a quoted field, say) is read
    row by row with ``csv.reader`` (``_read_rows``).  Curve splitting and
    preprocessing are the same on both routes, and the arrays bitwise
    equal: ``strtod`` and ``float()`` both round correctly.
    """
    args = _curve_args(ic_flags, sim_flags, scale_f, rng, logger)
    all_data = []
    for exp_file in exp_files:
        try:
            parsed = parse_obs_csv(exp_file)
        except ValueError:
            all_data.append(_read_rows(exp_file, *args))
        else:
            all_data.append(_package_curves(*parsed, *args))
    return all_data


def _curve_args(ic_flags, sim_flags, scale_f=1e-23, rng=None, logger=None):
    """The preprocessing options of ``_package_curves`` and ``_read_rows``,
    in their order, from the config's flags."""
    return (ic_flags.get("time_cutoff"), ic_flags.get("select_obs_sets"),
            ic_flags.get("noise_level"), sim_flags.get("self_normalize", False),
            sim_flags.get("log_pl", True), scale_f,
            np.random.default_rng() if rng is None else rng, logger)


def _read_rows(exp_file, early_cut, select, noise_level, normalize, log_pl,
               scale_f, rng, logger):
    """One file read row by row with ``csv.reader`` (bayes_io.py:42-98):
    the route for files the native parser refuses."""
    t, pl, unc = [], [], []
    next_t, next_pl, next_unc = [], [], []
    with open(exp_file, newline="") as f:
        for row in csv.reader(f):
            if not row:
                continue
            eof = row[0] == "END"
            finished = eof or (float(row[0]) == 0 and len(next_t) > 0)
            if finished:
                curve = _finish_curve(next_t, next_pl, next_unc, scale_f,
                                      noise_level, normalize, log_pl, rng, logger)
                t.append(curve[0])
                pl.append(curve[1])
                unc.append(curve[2])
                next_t, next_pl, next_unc = [], [], []
                if logger is not None:
                    logger.info("PL curve #%d finished reading (%d points)",
                                len(t), len(curve[0]))
            if eof:
                break
            if early_cut is not None and float(row[0]) > early_cut:
                continue
            next_t.append(float(row[0]))
            next_pl.append(float(row[1]))
            next_unc.append(float(row[2]))
    if next_t:  # file without END sentinel: flush trailing curve
        curve = _finish_curve(next_t, next_pl, next_unc, scale_f,
                              noise_level, normalize, log_pl, rng, logger)
        t.append(curve[0])
        pl.append(curve[1])
        unc.append(curve[2])
    if select is not None:
        idx = list(select)
        t = [t[i] for i in idx]
        pl = [pl[i] for i in idx]
        unc = [unc[i] for i in idx]
    return t, pl, unc


def _package_curves(t_all, pl_all, unc_all, early_cut, select, noise_level,
                    normalize, log_pl, scale_f, rng, logger):
    """Split flat parsed rows into curves at t == 0 and preprocess them as
    the row-by-row route does (bayes_io.py:42-98 semantics)."""
    if early_cut is not None:
        keep = t_all <= early_cut
        t_all, pl_all, unc_all = t_all[keep], pl_all[keep], unc_all[keep]
    starts = list(np.flatnonzero(t_all == 0.0))
    if not starts or starts[0] != 0:
        starts = [0] + starts
    starts.append(len(t_all))
    t, pl, unc = [], [], []
    for a, b in zip(starts[:-1], starts[1:]):
        if b <= a:
            continue
        curve = _finish_curve(t_all[a:b], pl_all[a:b], unc_all[a:b], scale_f,
                              noise_level, normalize, log_pl, rng, logger)
        t.append(curve[0])
        pl.append(curve[1])
        unc.append(curve[2])
    if select is not None:
        idx = list(select)
        t = [t[i] for i in idx]
        pl = [pl[i] for i in idx]
        unc = [unc[i] for i in idx]
    return t, pl, unc


def get_initpoints(init_file: str, ic_flags: dict, scale_f: float = 1e-21):
    """Load per-curve initial excitation profiles: (num_curves, L) [nm^-3]."""
    select = ic_flags.get("select_obs_sets")
    rows = []
    with open(init_file, newline="") as f:
        for row in csv.reader(f):
            if len(row) == 0:
                continue
            rows.append([float(v) for v in row])
    pts = np.array(rows, dtype=float)
    if select is not None:
        pts = pts[list(select)]
    return pts * scale_f


def export(out_filename: str, P, X, logger=None):
    """Write ``{base}_BAYRAN_P.npy`` / ``{base}_BAYRAN_X.npy`` into a
    directory named ``out_filename`` (bit-compatible with the reference's
    posterior loader, Visualization/utils.py:22-28)."""
    os.makedirs(out_filename, exist_ok=True)
    base = os.path.basename(out_filename)
    np.save(os.path.join(out_filename, f"{base}_BAYRAN_P.npy"), np.asarray(P))
    np.save(os.path.join(out_filename, f"{base}_BAYRAN_X.npy"), np.asarray(X))
    if logger is not None:
        logger.info("Exported BAYRAN files to %s", out_filename)


def load_bayran(path: str):
    """Load a BAYRAN output pair given either member file or the directory."""
    if os.path.isdir(path):
        base = os.path.basename(os.path.normpath(path))
        p_file = os.path.join(path, f"{base}_BAYRAN_P.npy")
        x_file = os.path.join(path, f"{base}_BAYRAN_X.npy")
    else:
        dname = os.path.dirname(path)
        bname = os.path.basename(path)
        bname = bname[:bname.find("_BAYRAN_")]
        p_file = os.path.join(dname, f"{bname}_BAYRAN_P.npy")
        x_file = os.path.join(dname, f"{bname}_BAYRAN_X.npy")
    return np.load(p_file), np.load(x_file)
