"""The forward model: the TRPL equations (trpl), Newton (newton), the BDF
solve (solver), the stride ladder (twophase), the off-grid path (offgrid)
and the host driver (driver: pvsim).  The JAX package's exports, resolved
at first use: ops/ imports submodules of this package, and solver imports
ops/, so an eager import here would be circular."""
import importlib

_EXPORTS = {
    "SimParams": "driver", "initial_excess_density": "driver",
    "nondim_state": "driver", "pl_log_scale": "driver", "pvsim": "driver",
    "redim_state": "driver", "FusedObs": "solver", "SolveResult": "solver",
    "SolverConfig": "solver", "solve": "solver", "BDF_TABLE": "trpl",
    "MatParams": "trpl",
}


def __getattr__(name):
    if name not in _EXPORTS:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    return getattr(importlib.import_module(f".{_EXPORTS[name]}", __name__), name)
