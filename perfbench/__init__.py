"""The benchmark of ``pcrcg_tpu_torch`` (see ``run.py``)."""
