"""Reader/writer for the posterior-visualization settings file.

File-format compatible with the reference GUI's persisted ``config.txt``
(reference: Visualization/marginalization_visual.py:396-488,
Visualization/config.txt): tab-separated key/value lines under
``!Parameter Scales`` / ``!Parameter Ranges`` / ``!Parameter Enabled`` /
``!Parameter Marks`` sections plus scalar ``!Thickness`` and
``!Num_observations`` entries.  Parameter keys keep the reference's LaTeX
labels; ``LABEL_TO_NAME`` maps them onto this package's plain names.
A copy of the JAX package's posterior/vizconfig.py (file I/O only): both
write the same bytes.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, Optional, Tuple

LABEL_TO_NAME = {
    r"$n_0$": "n0", r"$p_0$": "p0", r"$\mu_n$": "mu_n", r"$\mu_p$": "mu_p",
    r"$k^*$": "B", r"$S_F$": "Sf", r"$S_B$": "Sb", r"$C_n$": "Cn",
    r"$C_p$": "Cp", r"$\tau_n$": "tau_n", r"$\tau_p$": "tau_p",
    r"$\lambda$": "lambda", r"$m$": "m",
    r"$\tau_{eff}$": "tau_eff", r"$\tau_{rad}$": "tau_rad",
    r"$(S_F+S_B)$": "Sf+Sb", r"$\mu\prime$": "mu_eff",
    r"$\epsilon$": "epsilon", r"$\tau_n+\tau_p$": "tau_n+tau_p",
}
NAME_TO_LABEL = {v: k for k, v in LABEL_TO_NAME.items()}


@dataclass
class VizConfig:
    do_log: Dict[str, bool] = field(default_factory=dict)
    ranges: Dict[str, Tuple[float, float]] = field(default_factory=dict)
    enabled: Dict[str, bool] = field(default_factory=dict)
    marks: Dict[str, Optional[float]] = field(default_factory=dict)
    thickness: float = 311.0
    num_observations: int = 1

    def enabled_params(self):
        return [p for p, on in self.enabled.items() if on]


def _name(label: str) -> str:
    return LABEL_TO_NAME.get(label, label)


def load_vizconfig(path: str) -> VizConfig:
    cfg = VizConfig()
    section = None
    with open(path) as f:
        for raw in f:
            line = raw.rstrip("\n")
            if not line.strip():
                continue
            if line.startswith("!"):
                head = line.split("\t")
                tag = head[0]
                if tag == "!Thickness":
                    cfg.thickness = float(head[1])
                    section = None
                elif tag == "!Num_observations":
                    cfg.num_observations = int(float(head[1]))
                    section = None
                else:
                    section = tag
                continue
            parts = line.split("\t")
            key = _name(parts[0])
            val = parts[1] if len(parts) > 1 else ""
            if section == "!Parameter Scales":
                cfg.do_log[key] = bool(int(float(val)))
            elif section == "!Parameter Ranges":
                cfg.ranges[key] = (float(parts[1]), float(parts[2]))
            elif section == "!Parameter Enabled":
                cfg.enabled[key] = bool(int(float(val)))
            elif section == "!Parameter Marks":
                cfg.marks[key] = float(val) if val.strip() else None
    return cfg


def save_vizconfig(cfg: VizConfig, path: str):
    def label(p):
        return NAME_TO_LABEL.get(p, p)

    with open(path, "w") as f:
        f.write("!Parameter Scales\n")
        for p, v in cfg.do_log.items():
            f.write(f"{label(p)}\t{int(v)}\n")
        f.write("!Parameter Ranges\n")
        for p, (lo, hi) in cfg.ranges.items():
            f.write(f"{label(p)}\t{lo}\t{hi}\n")
        f.write(f"!Thickness\t{cfg.thickness}\n")
        f.write(f"!Num_observations\t{float(cfg.num_observations)}\n")
        f.write("!Parameter Enabled\n")
        for p, v in cfg.enabled.items():
            f.write(f"{label(p)}\t{int(v)}\n")
        f.write("!Parameter Marks\n")
        for p, v in cfg.marks.items():
            f.write(f"{label(p)}\t{'' if v is None else v}\n")
