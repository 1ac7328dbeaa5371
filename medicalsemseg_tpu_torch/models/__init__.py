"""The flagship model in PyTorch (counterpart of medicalsemseg_tpu.models)."""
