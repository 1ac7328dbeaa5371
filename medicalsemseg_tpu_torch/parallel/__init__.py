"""Multi-GPU data parallelism: the process group and the data-parallel
layout (counterpart of medicalsemseg_tpu.parallel)."""
