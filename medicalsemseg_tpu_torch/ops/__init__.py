"""Tensor ops of the port: window primitives and the hand-written kernels."""
