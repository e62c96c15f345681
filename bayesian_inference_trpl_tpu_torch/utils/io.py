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
    (times, values, uncertainties) of per-curve arrays."""
    early_cut = ic_flags.get("time_cutoff")
    select = ic_flags.get("select_obs_sets")
    noise_level = ic_flags.get("noise_level")
    log_pl = sim_flags.get("log_pl", True)
    normalize = sim_flags.get("self_normalize", False)
    if rng is None:
        rng = np.random.default_rng()

    all_data = []
    for exp_file in exp_files:
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
        all_data.append((t, pl, unc))
    return all_data


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
