"""The yardstick's arithmetic on the CPU: the model FLOPs counted from the
reference against the XLA count of the JAX package, the kernel names, the
bounds."""

from __future__ import annotations

import json
import os

import pytest
import torch

from portbench.reference import nnformer_unetr
from portbench.roofline import kernels
from portbench.roofline.model_flops import model_flops
from portbench.tests.conftest import ROOT

FLAGS = dict(vol_size=96, patch_size=2, depths=[2, 2, 2, 2],
             num_heads=[3, 6, 12, 24], window_size=6, hidden_dim=48,
             drop_path_rate=0.2)


def _shapes():
    from medicalsemseg_tpu_torch.config import get_args
    from medicalsemseg_tpu_torch.models.factory import build_model

    cfg = get_args(["--output_dim", "14", "--device", "cpu"])
    with torch.device("meta"):
        model = build_model(cfg)
    return {k: tuple(v.shape) for k, v in model.state_dict().items()}


def test_flagship_flops_against_model_flops_json():
    """FlopCounterMode counts the products (matmuls, convolutions) alone;
    the JAX package's XLA count adds the elementwise work (norms, softmax,
    GELU, the loss), so it reads a few percent higher."""
    with open(os.path.join(ROOT, "MODEL_FLOPS.json")) as f:
        xla = json.load(f)
    ours = model_flops(nnformer_unetr.forward, FLAGS, _shapes(), (96,) * 3,
                       train=True)
    fwd = model_flops(nnformer_unetr.forward, FLAGS, _shapes(), (96,) * 3,
                      train=False)
    assert 0.90 * xla["flops_per_crop_fwd_bwd"] < ours \
        < xla["flops_per_crop_fwd_bwd"]
    assert 0.88 * xla["flops_per_crop_fwd"] < fwd < xla["flops_per_crop_fwd"]
    assert 2.8 * fwd < ours < 3.1 * fwd


def test_kernel_names():
    assert kernels.family("void window_attention_heads_tc<__nv_bfloat16>("
                          "HeadsParams<__nv_bfloat16>)") == "K1"
    assert kernels.family("window_attention_proj_tc") == "K1"
    assert kernels.family("window_attention_bwd_dx_tc") == "K3"
    assert kernels.family("fused_mlp_tc") == "K2"
    assert kernels.family("mlp_tc_finish") == "K2"
    assert kernels.family("fused_mlp_bwd_w_tc") == "K4"
    assert kernels.family("sum_partials_kernel") == "reduce"
    assert kernels.family("sm90_xmma_fprop_implicit_gemm_bf16") == ""
    assert kernels.family("void at::native::vectorized_elementwise_kernel"
                          ) == ""


def test_swin_bound_counts_each_call():
    stages = nnformer_unetr.stages({**FLAGS})
    one = kernels.swin_bound_s(stages, {"K1": 8}, [8])
    assert one > 0
    assert kernels.swin_bound_s(stages, {"K1": 16}, [8]) == \
        pytest.approx(2 * one)
    assert kernels.swin_bound_s(stages, {"K1": 16}, [8, 8]) == \
        pytest.approx(2 * one)
    # stage 1 of a batch of 8: 8 x 512 windows of 216 tokens at C = 48
    f, b = kernels.work("window_attention", 8 * 512, 216, 48, 3)
    assert f == 8 * 8 * 512 * 216 * 48 * 48 + 4 * 8 * 512 * 216 * 216 * 48
