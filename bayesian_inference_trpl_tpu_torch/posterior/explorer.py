"""Interactive posterior explorer (the JAX package's posterior/explorer.py):
the live toggle/limits/marks/replot workflow of the reference's Tk
marginalization GUI, rebuilt on matplotlib widgets (reference: Visualization/marginalization_visual.py:27-640 — param
enable checkboxes :396-430, scale/range/mark entries :432-488 persisted to
config.txt, plot pipeline :500-611 with the user-entered temperature factor
at :589-591, stats readout :538-556, covariance view :613-636).

Design: all state transitions live in :class:`ExplorerSession` (pure, no
GUI, its posterior on ``device``, default ``cuda``), which owns the
ORIGINAL sample arrays (host numpy) and rebuilds the filtered /
normalized :class:`~..posterior.data.PosteriorData` on demand — unlike the
destructive ``PosteriorData.exclude_limits``, limits here are re-applied
from scratch on every change, so widening a range restores samples exactly
as the reference GUI does.  :class:`PosteriorExplorer` is a thin matplotlib
widget shell over the session; it renders on any backend (TkAgg/QtAgg for
live use, Agg headless in tests, where callbacks are invoked directly).

Launch:
    python -m bayesian_inference_trpl_tpu_torch.posterior.explorer RESULT_DIR \
        [--config config.txt] [--device cpu]
"""
from __future__ import annotations

import argparse
from typing import Optional, Tuple

import numpy as np
import torch

from .data import PosteriorData
from .plotting import draw_corner
from .vizconfig import VizConfig, load_vizconfig, save_vizconfig


class ExplorerSession:
    """GUI-independent explorer state: enabled set, scales, ranges, marks,
    temperature factor; rebuilds the posterior view after every change."""

    def __init__(self, LL, Xmat, viz: Optional[VizConfig] = None,
                 thickness: Optional[float] = None,
                 num_observations: Optional[int] = None, device="cuda"):
        self.viz = viz or VizConfig()
        self.device = device
        if thickness is not None:
            self.viz.thickness = thickness
        if num_observations is not None:
            self.viz.num_observations = num_observations
        self._LL = np.asarray(LL, dtype=float)
        self._Xmat = np.asarray(Xmat, dtype=float)
        base = PosteriorData.from_arrays(
            self._LL, self._Xmat, thickness=self.viz.thickness,
            num_observations=self.viz.num_observations, device=device)
        base.compute_secondary()
        self._base = base                      # NaN-filtered, unclipped
        self.t_factor: Optional[float] = None  # None -> reference default
        for p, v in base.X.items():
            finite = v[~torch.isnan(v)]
            lo, hi = ((float(finite.min()), float(finite.max())) if finite.numel()
                      else (np.nan, np.nan))
            self.viz.enabled.setdefault(p, p in (
                "p0", "B", "Sf", "Sb", "tau_n", "tau_p"))
            self.viz.do_log.setdefault(p, bool(lo > 0 and hi > 100 * max(lo, 1e-300)))
            self.viz.marks.setdefault(p, None)
        self.data: PosteriorData = None
        self.rebuild()

    @classmethod
    def load(cls, path: str, viz: Optional[VizConfig] = None, **kw):
        """A session on a BAYRAN result (``kw``: thickness,
        num_observations, device)."""
        from ..utils.io import load_bayran
        LL, Xmat = load_bayran(path)
        return cls(LL, Xmat, viz=viz, **kw)

    # -- state transitions (one per GUI control) ---------------------------
    def set_enabled(self, param: str, on: bool):
        self.viz.enabled[param] = bool(on)

    def set_scale(self, param: str, log: bool):
        self.viz.do_log[param] = bool(log)

    def set_range(self, param: str, lo: float, hi: float):
        """Clip to [lo, hi]; pass lo > hi or NaN to clear (full range).

        A range that excludes every sample is rolled back (and the error
        re-raised) rather than committed — otherwise every later rebuild()
        from any control would re-raise from the stored bad range and Save
        would persist it."""
        prev = self.viz.ranges.get(param)
        had = param in self.viz.ranges
        if not (np.isfinite(lo) and np.isfinite(hi)) or lo > hi:
            self.viz.ranges.pop(param, None)
        else:
            self.viz.ranges[param] = (float(lo), float(hi))
        try:
            self.rebuild()
        except ValueError:
            if had:
                self.viz.ranges[param] = prev
            else:
                self.viz.ranges.pop(param, None)
            self.rebuild()
            raise

    def set_mark(self, param: str, value: Optional[float]):
        self.viz.marks[param] = None if value is None else float(value)

    def set_t_factor(self, value: Optional[float]):
        """Likelihood temperature (reference: the user-entered ``c`` at
        marginalization_visual.py:589-591; None = num_observations/2000,
        the reference GUI's prefilled default)."""
        self.t_factor = None if value is None else float(value)
        self.rebuild()

    def rebuild(self):
        """Re-filter from the original arrays and renormalize."""
        d = PosteriorData.from_arrays(
            self._LL, self._Xmat, thickness=self.viz.thickness,
            num_observations=self.viz.num_observations, device=self.device)
        d.compute_secondary()
        if self.viz.ranges:
            d.exclude_limits({p: r for p, r in self.viz.ranges.items()
                              if p in d.X})
        if len(d.LL) == 0:
            raise ValueError("limits exclude every sample")
        d.normalize(self.t_factor)
        self.data = d
        return d

    # -- views --------------------------------------------------------------
    def enabled_params(self):
        return [p for p in self.data.X if self.viz.enabled.get(p)]

    def stats_text(self, param: str) -> str:
        """Per-plot readout (reference: marginalization_visual.py:538-556):
        weighted mean +/- sample std, 95% credible interval, mark."""
        d = self.data
        summ = d.stats_summary()[param]
        lo, hi = d.credible_intervals()[param]
        mark = self.viz.marks.get(param)
        lines = [f"{param}: mean {summ[0]:.4g} +/- {summ[1]:.3g}",
                 f"95% CI [{lo:.4g}, {hi:.4g}]",
                 f"n = {len(d.LL)}"]
        if mark is not None:
            lines.append(f"mark = {mark:.4g}")
        return "\n".join(lines)

    def max_uncertainty(self, param: str) -> Tuple[float, float]:
        """(best T-factor, max std) for one parameter (utils.py:172-183)."""
        return self.data.max_uncertainty()[param]

    def save_config(self, path: str):
        save_vizconfig(self.viz, path)


class PosteriorExplorer:
    """matplotlib-widget shell: checkbox column (enable), radio column
    (select), scale/range/mark/T-factor entries for the selected parameter,
    Replot / Covariance / Save buttons, and a live stats readout."""

    def __init__(self, session: ExplorerSession, config_path: str = None,
                 bins: int = 64, backend: Optional[str] = None):
        import matplotlib
        if backend:
            matplotlib.use(backend)
        import matplotlib.pyplot as plt
        from matplotlib.widgets import Button, CheckButtons, TextBox

        self.s = session
        self.bins = bins
        self.config_path = config_path or "config.txt"
        self.mode = "corner"
        self.plot_axes = []
        self.fig = plt.figure(figsize=(14, 9))
        names = list(self.s.data.X)
        self.selected = names[0]

        ax_check = self.fig.add_axes([0.005, 0.32, 0.085, 0.66])
        ax_check.set_title("enabled", fontsize=8)
        self.w_enabled = CheckButtons(
            ax_check, names, [self.s.viz.enabled.get(p, False)
                              for p in names])
        self.w_enabled.on_clicked(self._on_toggle)

        ax_radio = self.fig.add_axes([0.10, 0.32, 0.085, 0.66])
        ax_radio.set_title("edit param", fontsize=8)
        from matplotlib.widgets import RadioButtons
        self.w_select = RadioButtons(ax_radio, names)
        self.w_select.on_clicked(self._on_select)

        def box(y, label):
            ax = self.fig.add_axes([0.065, y, 0.12, 0.035])
            return TextBox(ax, label, textalignment="left")

        self.w_lo = box(0.27, "min ")
        self.w_hi = box(0.225, "max ")
        self.w_mark = box(0.18, "mark ")
        self.w_tf = box(0.135, "T-fac ")
        for w in (self.w_lo, self.w_hi, self.w_mark):
            w.on_submit(self._on_entries)
        self.w_tf.on_submit(self._on_tfactor)

        ax_log = self.fig.add_axes([0.005, 0.09, 0.08, 0.035])
        self.w_log = CheckButtons(ax_log, ["log scale"],
                                  [self.s.viz.do_log.get(self.selected, False)])
        self.w_log.on_clicked(self._on_log)

        def button(x, label, cb):
            ax = self.fig.add_axes([x, 0.04, 0.055, 0.04])
            b = Button(ax, label)
            b.on_clicked(cb)
            return b

        self.w_replot = button(0.005, "Replot", lambda _ev: self.replot())
        self.w_cov = button(0.065, "Cov", self._on_cov)
        self.w_save = button(0.125, "Save", self._on_save)

        self.ax_stats = self.fig.add_axes([0.005, 0.005, 0.19, 0.03])
        self.ax_stats.axis("off")
        self._stats_artist = self.ax_stats.text(0, 0, "", fontsize=7,
                                                va="bottom")
        self._sync_entries()
        self.replot()

    # -- widget callbacks ---------------------------------------------------
    def _on_toggle(self, label):
        self.s.set_enabled(label, not self.s.viz.enabled.get(label, False))

    def _on_select(self, label):
        self.selected = label
        self._sync_entries()
        self._update_stats()
        self.fig.canvas.draw_idle()

    def _on_log(self, _label):
        self.s.set_scale(self.selected,
                         not self.s.viz.do_log.get(self.selected, False))

    def _on_entries(self, _text):
        def val(w):
            t = w.text.strip()
            try:
                return float(t)
            except ValueError:
                return float("nan")
        self.s.set_range(self.selected, val(self.w_lo), val(self.w_hi))
        mv = val(self.w_mark)
        self.s.set_mark(self.selected, None if np.isnan(mv) else mv)

    def _on_tfactor(self, text):
        try:
            self.s.set_t_factor(float(text))
        except ValueError:
            self.s.set_t_factor(None)

    def _on_cov(self, _ev):
        self.mode = "cov" if self.mode == "corner" else "corner"
        self.replot()

    def _on_save(self, _ev):
        self.s.save_config(self.config_path)

    def _sync_entries(self):
        p = self.selected
        rng = self.s.viz.ranges.get(p)
        mark = self.s.viz.marks.get(p)
        # set_val fires on_submit; silence it while reflecting state INTO
        # the boxes, else selecting a param would re-submit (and clear)
        # its own range.
        for w, txt in ((self.w_lo, "" if rng is None else f"{rng[0]:g}"),
                       (self.w_hi, "" if rng is None else f"{rng[1]:g}"),
                       (self.w_mark, "" if mark is None else f"{mark:g}")):
            w.eventson = False
            w.set_val(txt)
            w.eventson = True
        want = self.s.viz.do_log.get(p, False)
        if self.w_log.get_status()[0] != want:
            self.w_log.eventson = False
            self.w_log.set_active(0)
            self.w_log.eventson = True

    def _update_stats(self):
        self._stats_artist.set_text(self.s.stats_text(self.selected))

    # -- plotting -----------------------------------------------------------
    def _clear_plots(self):
        for ax in self.plot_axes:
            ax.remove()
        self.plot_axes = []

    def replot(self):
        """Redraw the plot region from current session state (the
        reference GUI's Plot button, marginalization_visual.py:500-611)."""
        self._clear_plots()
        d = self.s.data
        if self.mode == "cov":
            params = self.s.enabled_params() or list(d.X)[:1]
            ax = self.fig.add_axes([0.30, 0.08, 0.62, 0.88])
            self.plot_axes = [ax]
            cov = d.covariance(params).cpu().numpy()
            im = ax.imshow(cov, cmap="coolwarm")
            ax.set_xticks(range(len(params)))
            ax.set_xticklabels(params, rotation=90, fontsize=7)
            ax.set_yticks(range(len(params)))
            ax.set_yticklabels(params, fontsize=7)
        else:
            params = self.s.enabled_params() or list(d.X)[:1]
            k = len(params)
            gs = self.fig.add_gridspec(k, k, left=0.24, right=0.995,
                                       bottom=0.06, top=0.995)
            axes = [[self.fig.add_subplot(gs[i, j]) for j in range(k)]
                    for i in range(k)]
            self.plot_axes = [ax for row in axes for ax in row]
            bounds = {p: self.s.viz.ranges[p] for p in params
                      if p in self.s.viz.ranges}
            draw_corner(axes, d, params, do_log=self.s.viz.do_log,
                        bounds=bounds, marks=self.s.viz.marks,
                        bins=self.bins)
        self._update_stats()
        self.fig.canvas.draw_idle()
        return params


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("result", help="BAYRAN output dir or *_BAYRAN_*.npy path")
    ap.add_argument("--config", default=None,
                    help="viz config file (reference config.txt format); "
                         "also the Save button's destination")
    ap.add_argument("--bins", type=int, default=64)
    ap.add_argument("--thickness", type=float, default=None)
    ap.add_argument("--num-observations", type=int, default=None)
    ap.add_argument("--device", default="cuda",
                    help="torch device of the posterior (default: cuda)")
    args = ap.parse_args(argv)

    viz = load_vizconfig(args.config) if args.config else None
    session = ExplorerSession.load(
        args.result, viz=viz, thickness=args.thickness,
        num_observations=args.num_observations, device=args.device)
    explorer = PosteriorExplorer(session, config_path=args.config,
                                 bins=args.bins)
    import matplotlib.pyplot as plt
    plt.show()
    return explorer


if __name__ == "__main__":
    main()
