"""Training of the port's SwinSegFormer against the JAX model on the CPU.

A small model (vol 32, hidden 12, depths 2-2-1-1, heads 2-2-2-2, window 2, 3
classes, drop path 0) gets JAX variables filled from a seeded numpy
generator, the BatchNorm running statistics of the head's four fuse blocks
included, and the same batch on both sides, in fp32. The port's Swin blocks
run K1 / K3 and K2 / K4 through the autograd functions (their plain versions
on the CPU); the head's dropout is 0 on both sides. One jitted JAX step. The
CLI trains the model for a few steps, checkpoints and resumes.
"""

import pytest
import torch

from medicalsemseg_tpu_torch.models.factory import build_model, init_weights
from medicalsemseg_tpu_torch.models.layers import BatchNorm
from medicalsemseg_tpu_torch.ops.kernels import mlp as kmlp
from medicalsemseg_tpu_torch.ops.kernels import window_attention as kwa

from tests.test_torch_model import (
    assert_train_step_matches,
    model_inputs,
    small_cfg,
    train_step_both,
)
from tests.test_torch_run_training import train_and_resume

torch.backends.cudnn.allow_tf32 = False
torch.backends.cuda.matmul.allow_tf32 = False

CFG = dict(model="SwinSegFormer", depths=(2, 2, 1, 1), drop_path_rate=0.0)


@pytest.fixture(scope="module")
def both():
    return train_step_both(small_cfg(**CFG), seed=51)


def test_loss_and_every_gradient_match_jax(both):
    assert_train_step_matches(both)


def test_every_fuse_block_moved_its_statistics(both):
    start, moved = both["stats0"], both["port"][2]
    assert sorted(moved) == [f"linear_fuse_{k}" for k in range(4)]
    for k in range(4):
        a = start[f"linear_fuse_{k}"]["BatchNorm_0"]["BatchNorm_0"]["var"]
        b = moved[f"linear_fuse_{k}"]["BatchNorm_0"]["BatchNorm_0"]["var"]
        assert abs(a - b).max() > 1e-4, k


def test_blocks_launch_k1_to_k4_in_training(monkeypatch):
    """Every Swin block runs K1 and K3 (its attention), K2 and K4 (its
    MLP) in a training step; the eval forward without gradients leaves the
    running statistics alone."""
    calls = {n: 0 for n in ("attn", "attn_bwd", "mlp", "mlp_bwd")}
    for mod, name, key in ((kwa, "window_attention", "attn"),
                           (kwa, "window_attention_bwd", "attn_bwd"),
                           (kmlp, "fused_mlp", "mlp"),
                           (kmlp, "fused_mlp_bwd", "mlp_bwd")):
        fn = getattr(mod, name)
        monkeypatch.setattr(mod, name, lambda *a, _f=fn, _k=key, **kw: (
            calls.__setitem__(_k, calls[_k] + 1) or _f(*a, **kw)))
    cfg = small_cfg(**CFG)
    model = init_weights(build_model(cfg), torch.Generator().manual_seed(0))
    x_in = tuple(torch.from_numpy(a) for a in model_inputs(cfg))
    model.train()(x_in).sum().backward()
    assert calls == {"attn": 6, "attn_bwd": 6, "mlp": 6, "mlp_bwd": 6}
    stats = [m.running_var.clone() for m in model.modules()
             if isinstance(m, BatchNorm)]
    with torch.inference_mode():
        model.eval()(x_in)
    assert all(torch.equal(a, m.running_var) for a, m in zip(
        stats, [m for m in model.modules() if isinstance(m, BatchNorm)]))


def test_cli_trains_checkpoints_and_resumes(tmp_path):
    train_and_resume(tmp_path, ["--model", "SwinSegFormer", "--vol_size",
                                "16", "--depths", "1", "1", "1", "1",
                                "--num_heads", "2", "2", "2", "2"])
