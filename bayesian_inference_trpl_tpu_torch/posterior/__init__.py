"""Posterior analysis of BAYRAN results on a torch device: weighted
statistics, marginals (ops/histogram), the viz config, plots, the CLI and
the explorer (the JAX package's posterior/)."""
from .data import PosteriorData, PRIMARY_PARAMS, SECONDARY_PARAMS  # noqa: F401
from .vizconfig import VizConfig, load_vizconfig, save_vizconfig  # noqa: F401
from . import stats  # noqa: F401
