"""portbench: the benchmark of medicalsemseg_tpu_torch on NVIDIA GPUs
(``python3 portbench/run.py``; see ``harness.py``)."""
