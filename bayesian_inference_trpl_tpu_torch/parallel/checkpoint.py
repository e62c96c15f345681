"""Chunk-level checkpoint/resume of inference runs.

The reference documented a ``[new|new+|load]`` resume mode that was never
implemented (README.md:6; bayeslib.py:163-164 raises NotImplementedError;
bayes_io.py:142-158 is deprecated).  Here it is real: after every completed
chunk the accumulated (X, P, progress) state is flushed to disk, and a rerun
with the same output directory picks up at the first incomplete chunk.
"""
from __future__ import annotations

import json
import os
from dataclasses import dataclass
from typing import Optional

import numpy as np

STATE_FILE = "checkpoint_state.json"
P_FILE = "checkpoint_P.npy"
X_FILE = "checkpoint_X.npy"
PSTART_FILE = "checkpoint_P_curve_start.npy"


@dataclass
class CheckpointState:
    num_samples: int
    num_exp: int
    num_curves: int
    chunk: int
    curve_index: int = 0       # next curve to run
    chunk_index: int = 0       # next chunk within that curve

    def to_dict(self):
        return self.__dict__.copy()


class CheckpointManager:
    def __init__(self, out_dir: str):
        self.out_dir = out_dir
        os.makedirs(out_dir, exist_ok=True)

    def _paths(self):
        return (os.path.join(self.out_dir, STATE_FILE),
                os.path.join(self.out_dir, P_FILE),
                os.path.join(self.out_dir, X_FILE))

    def load(self) -> Optional[tuple]:
        """Returns (state, P, X, P_curve_start) if a resumable checkpoint
        exists.  ``P_curve_start`` is the accumulator snapshot taken at the
        start of the in-progress curve — the baseline the non-converged
        retry pass repairs against on resume (a failed sample's running sum
        is NaN in P, so the pre-curve value is not recoverable from P
        alone).  Falls back to P itself for pre-r4 checkpoints."""
        sp, pp, xp = self._paths()
        if not (os.path.exists(sp) and os.path.exists(pp) and os.path.exists(xp)):
            return None
        with open(sp) as f:
            state = CheckpointState(**json.load(f))
        P = np.load(pp)
        psp = os.path.join(self.out_dir, PSTART_FILE)
        P_start = np.load(psp) if os.path.exists(psp) else P.copy()
        return state, P, np.load(xp), P_start

    def save_curve_start(self, P):
        """Snapshot the accumulator at the start of a curve (atomic)."""
        psp = os.path.join(self.out_dir, PSTART_FILE)
        tmp = psp + ".tmp.npy"
        np.save(tmp, P)
        os.replace(tmp, psp)

    def init(self, X, num_exp: int, num_curves: int, chunk: int) -> tuple:
        """Start a fresh run; persists X immediately (it fully determines
        the sample stream)."""
        state = CheckpointState(num_samples=len(X), num_exp=num_exp,
                                num_curves=num_curves, chunk=chunk)
        P = np.zeros((num_exp, len(X)))
        sp, pp, xp = self._paths()
        np.save(xp, np.asarray(X))
        np.save(pp, P)
        with open(sp, "w") as f:
            json.dump(state.to_dict(), f)
        return state, P

    def save_progress(self, state: CheckpointState, P):
        sp, pp, _ = self._paths()
        tmp = pp + ".tmp.npy"
        np.save(tmp, P)
        os.replace(tmp, pp)
        with open(sp + ".tmp", "w") as f:
            json.dump(state.to_dict(), f)
        os.replace(sp + ".tmp", sp)

    def clear(self):
        for p in self._paths() + (os.path.join(self.out_dir, PSTART_FILE),):
            if os.path.exists(p):
                os.remove(p)
