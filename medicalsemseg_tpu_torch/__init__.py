"""medicalsemseg_tpu_torch — the PyTorch / CUDA port of medicalsemseg_tpu.

The port runs on one NVIDIA H100. It mirrors the JAX package's layout
(``ops``, ``models``, ``infer``, ``train``, ``data``, ``utils``, ``cli``) so
that each
module's counterpart is found by name, and keeps the JAX package's public
layouts: channels-last volumes (B, D, H, W, C) in, channels-last fp32 logits
out. Every kernel the JAX package wrote in Pallas for the TPU becomes a CUDA
C++ kernel for ``sm_90a`` under ``csrc/``, built at first use
(``ops/kernels``); plain tensor code is PyTorch.

This package imports ``torch`` and never ``jax`` or ``flax``, and nothing of
the JAX package: what it needs of that package's jax-free modules
(``config``, ``data.nifti``, ``data.datalist``, ``data.native``,
``utils.logger``, ``utils.tags``) it keeps as its own copies.
"""

__version__ = "0.1.0"
