"""PyTorch port of bayesian_inference_trpl_tpu for NVIDIA Hopper GPUs.

The same Bayesian inference over TRPL decay curves as the JAX package beside
it: batched implicit drift-diffusion-decay simulation, a fused
log-likelihood against every observed curve, chunked evaluation over the
sampled parameter box, and BAYRAN (X, P) export.  Plain tensor code is
PyTorch; the fused-horizon chord kernel is hand-written CUDA
(csrc/horizon_kernel.cu).  Entry points run on ``cuda`` unless the caller
passes ``device="cpu"``, where each kernel's plain PyTorch version runs.
"""
__version__ = "0.1.0"

from . import physics  # noqa: F401
