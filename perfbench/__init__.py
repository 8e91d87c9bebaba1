"""The benchmark of pilosa_tpu_torch: one cell a run (``run.py``)."""
