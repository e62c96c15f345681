"""Verification instruments of the port, run on the card or the CPU.

* ``accuracy_gate``: the float32 fast ladder against float64 exact
  single-phase curves, windowed rms of log10-PL (the JAX package's gate,
  same flags, thresholds and exit code).
* ``posterior_equivalence``: the fast ladder against exact fixed-dt
  stepping over one sample matrix, ranked likelihoods compared.
* ``sweep`` -> ``run_sweep --backend solver|oracle`` -> ``compare`` /
  ``overlay``: the reference's Testing/ pipeline over one npz format (a
  Cartesian sweep file; result files with N/P/E snapshots and the PL
  trace), the solver through models/driver.pvsim and the oracle through
  the scipy integrator of models/oracle.py.
* ``corner_cache``: the corner gate's parameter matrices and its shipped
  oracle results.
* ``nonconverged``: where in the parameter box a run's NaN samples lie.
* ``warmup``: one chunk per curve of a config, so that the kernel
  library's build and the first launches are paid before a production run.

Each tool that runs the solver takes ``--device cuda|cpu`` (default
``cuda``), as ``run.py`` does.
"""
