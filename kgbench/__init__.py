"""The benchmark of ``ultra_torchdrug_tpu_torch`` (``python3 kgbench/run.py``)."""
