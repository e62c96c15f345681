"""Verification instruments of the port, run on the card or the CPU.

* ``accuracy_gate``: the float32 fast ladder against float64 exact
  single-phase curves, windowed rms of log10-PL (the JAX package's gate,
  same flags, thresholds and exit code).
* ``posterior_equivalence``: the fast ladder against exact fixed-dt
  stepping over one sample matrix, ranked likelihoods compared.

Each takes ``--device cuda|cpu`` (default ``cuda``), as ``run.py`` does.
"""
