"""Sliding-window inference (counterpart of medicalsemseg_tpu.infer)."""
