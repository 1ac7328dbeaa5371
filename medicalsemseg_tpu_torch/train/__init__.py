"""Training: losses, metrics, schedule, optimizer and steps, epoch loops
(counterpart of medicalsemseg_tpu.train)."""
