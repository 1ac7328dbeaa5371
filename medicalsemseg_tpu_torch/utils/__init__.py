"""Parameter conversion and checkpoints."""
