"""Posterior data model: load BAYRAN results, derive secondary parameters,
marginalize, and summarize, on a torch device.

The JAX package's posterior/data.py (the headless equivalent of the
reference's Tk-bound ``LikelihoodData``, Visualization/utils.py:17-143).
The columns, the log-likelihoods and the weights are float64 tensors on
``device`` (default ``cuda``); summaries come back as host floats.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from .. import physics
from ..utils.io import load_bayran
from . import stats

# Primary parameter labels in BAYRAN column order (matches the reference's
# PARAM_ORDER in Visualization/marginalization_visual.py).
PRIMARY_PARAMS = [
    "n0", "p0", "mu_n", "mu_p", "B", "Sf", "Sb", "Cn", "Cp",
    "tau_n", "tau_p", "lambda", "m",
]
SECONDARY_PARAMS = [
    "tau_eff", "tau_rad", "Sf+Sb", "mu_eff", "epsilon", "tau_n+tau_p",
]


@dataclass
class PosteriorData:
    X: Dict[str, torch.Tensor] = field(default_factory=dict)
    LL: torch.Tensor = None                 # raw log-likelihoods
    P: Optional[torch.Tensor] = None        # normalized weights
    thickness: float = 311.0
    num_observations: int = 1

    @classmethod
    def load(cls, path: str, thickness: float = 311.0, num_observations: int = 1,
             device="cuda"):
        LL, Xmat = load_bayran(path)
        return cls.from_arrays(LL, Xmat, thickness, num_observations, device=device)

    @classmethod
    def from_arrays(cls, LL, Xmat, thickness: float = 311.0,
                    num_observations: int = 1, device="cuda"):
        self = cls(thickness=thickness, num_observations=num_observations)
        LL = torch.as_tensor(np.asarray(LL, dtype=float), device=device)
        Xmat = torch.as_tensor(np.asarray(Xmat, dtype=float), device=device)
        keep = ~torch.isnan(LL)             # NaN filter (utils.py:33-38)
        LL, Xmat = LL[keep], Xmat[keep]
        if len(LL) == 0:
            raise ValueError(
                "no finite log-likelihoods in result (all samples filtered "
                "as NaN — every sample failed to converge; check the solver "
                "tolerance against the precision floor, docs/PRECISION.md)")
        self.LL = LL
        self.X = {p: Xmat[:, i].contiguous()
                  for i, p in enumerate(PRIMARY_PARAMS[:Xmat.shape[1]])}
        return self

    # -- transformations ----------------------------------------------------
    def exclude_limits(self, limits: Dict[str, Tuple[float, float]]):
        """Drop samples outside per-parameter limits (utils.py:48-52, 145-155)."""
        keep = torch.ones(len(self.LL), dtype=torch.bool, device=self.LL.device)
        for p, (lo, hi) in limits.items():
            if p in self.X:
                keep &= (self.X[p] >= lo) & (self.X[p] <= hi)
        self.LL = self.LL[keep]
        self.X = {p: v[keep] for p, v in self.X.items()}
        if self.P is not None:
            self.P = self.P[keep]
        return int(keep.sum())

    def compute_secondary(self, which: Optional[List[str]] = None):
        """Derived physics quantities (utils.py:54-79; secondary_parameters.py)."""
        X = self.X
        want = set(which) if which is not None else set(SECONDARY_PARAMS)
        if "mu_eff" in want:
            X["mu_eff"] = physics.mu_eff(X["mu_n"], X["mu_p"])
        if "tau_eff" in want:
            mu_t = physics.mu_eff(X["mu_n"], X["mu_p"])
            X["tau_eff"] = physics.LI_tau_eff(
                X["B"], X["p0"], X["tau_n"], X["Sf"], X["Sb"], X["Cp"],
                self.thickness, mu_t)
        if "tau_rad" in want:
            X["tau_rad"] = physics.t_rad(X["B"], X["p0"])
        if "Sf+Sb" in want:
            X["Sf+Sb"] = physics.s_eff(X["Sf"], X["Sb"])
        if "epsilon" in want:
            X["epsilon"] = physics.epsilon(X["lambda"])
        if "tau_n+tau_p" in want:
            X["tau_n+tau_p"] = X["tau_n"] + X["tau_p"]
        return self

    def normalize(self, t_factor: Optional[float] = None):
        """Normalize weights: P = normalize(LL / (num_observations * c))
        (reference: marginalization_visual.py:589-591); ``c`` defaults to
        num_observations / 2000, a per-point temperature of ~1 for the
        reference's ~2,000 retained points per curve (the JAX package's
        data.py says why)."""
        c = t_factor if t_factor is not None else self.num_observations / 2000.0
        self.P = stats.normalize(self.LL / (self.num_observations * c)
                                 if c else self.LL)
        return self

    def ess(self) -> float:
        """Kish effective sample size 1 / sum(w^2) of the normalized
        weights (ESS ~ 1: the posterior is a delta at the best sample)."""
        assert self.P is not None, "call normalize() first"
        return float(1.0 / torch.sum(self.P ** 2))

    def auto_temperature(self, params: Optional[List[str]] = None) -> float:
        """The median over parameters of each one's max-uncertainty
        temperature (the reference's search, utils.py:172-183); use as
        ``data.normalize_temperature(data.auto_temperature())``."""
        params = [p for p in (params or list(self.X)) if p in self.X]
        tfs = [stats.find_best_tf_bracketed(self.X[p], self.LL)[0]
               for p in params]
        return float(np.median(tfs))

    def temperature_for_ess(self, target: float = 100.0) -> float:
        """Smallest temperature whose normalized weights reach the target
        Kish ESS (bisection on log-temperature, 60 halvings; an addition of
        the JAX package, not reference parity)."""
        LL = self.LL
        spread = float(stats.nanmax(LL)) - stats.nanmedian(LL)
        if not np.isfinite(spread) or spread <= 0:
            return 1.0
        target = min(float(target), 0.5 * len(LL))

        def ess_at(tau):
            w = stats.normalize(LL / tau)
            return float(1.0 / torch.sum(w ** 2))

        lo, hi = spread * 1e-6, spread * 1e3
        for _ in range(60):
            mid = np.sqrt(lo * hi)
            if ess_at(mid) < target:
                lo = mid
            else:
                hi = mid
        return float(hi)

    def normalize_temperature(self, temperature: float):
        """Normalize weights as P = normalize(LL / temperature)."""
        self.P = stats.normalize(self.LL / float(temperature))
        return self

    # -- summaries ----------------------------------------------------------
    def stats_summary(self) -> Dict[str, Tuple[float, float, float]]:
        """(weighted mean, sample std, sum w^2) per parameter (utils.py:119-126)."""
        assert self.P is not None, "call normalize() first"
        ws = torch.sum(self.P ** 2)
        out = {p: torch.stack((stats.w_mean(v, self.P),
                               stats.w_sample_var(v, self.P, ws), ws))
               for p, v in self.X.items()}
        host = torch.stack(list(out.values())).cpu().tolist() if out else []
        return {p: tuple(h) for p, h in zip(out, host)}

    def credible_intervals(self, lo=0.025, hi=0.975):
        assert self.P is not None
        return {p: stats.credible_interval(v, self.P, lo, hi)
                for p, v in self.X.items()}

    def max_uncertainty(self) -> Dict[str, Tuple[float, float]]:
        """Per-parameter worst-case uncertainty over the likelihood
        temperature (utils.py:128-133)."""
        return {p: stats.find_best_tf(v, self.LL, self.num_observations / 2000.0)
                for p, v in self.X.items()}

    def covariance(self, params: Optional[List[str]] = None) -> torch.Tensor:
        assert self.P is not None
        params = params or list(self.X)
        return stats.covariance_matrix([self.X[p] for p in params], self.P)

    def _values(self, param, log):
        return torch.log10(self.X[param]) if log else self.X[param]

    def marginal_1d(self, param: str, bounds=None, bins: int = 96,
                    log: bool = False):
        assert self.P is not None
        v = self._values(param, log)
        if bounds is None:
            bounds = (float(torch.min(v)), float(torch.max(v)))
        corr = param in SECONDARY_PARAMS or "mu" in param
        return stats.marginalize_1d(self.P, bounds, bins, v, density_correct=corr)

    def marginal_2d(self, px: str, py: str, bounds_x=None, bounds_y=None,
                    bins: int = 96, log_x: bool = False, log_y: bool = False):
        assert self.P is not None
        vx, vy = self._values(px, log_x), self._values(py, log_y)
        if bounds_x is None:
            bounds_x = (float(torch.min(vx)), float(torch.max(vx)))
        if bounds_y is None:
            bounds_y = (float(torch.min(vy)), float(torch.max(vy)))
        return stats.marginalize_2d(self.P, bounds_x, bounds_y, bins, vx, vy)
