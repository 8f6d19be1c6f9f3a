"""The benchmark of ``classpose_tpu_torch`` (``run.py``)."""
