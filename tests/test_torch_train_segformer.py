"""Training of the port's SegFormer3D against the JAX model on the CPU.

A small model (vol 64, hidden 12, depths 1-1-1-1, heads 2-2-2-2, 3 classes,
drop path 0; at vol 32 every stage reduces its keys to one and the softmax
is constant, so vol 64: M = 8 reduced keys at every stage) gets JAX
variables filled from a seeded numpy generator, the BatchNorm running
statistics of the head's fuse block included, and the same batch on both
sides, in fp32. K7 has no backward kernel: in training the port's attention
is the module's own unfused form, as the JAX model's is. The head's dropout
is 0 on both sides (the frameworks draw different masks; the layer itself is
tested in ``tests/test_torch_train_layers.py``). One jitted JAX step. The
CLI trains the model for a few steps, checkpoints and resumes.
"""

import pytest
import torch

from medicalsemseg_tpu_torch.models.factory import build_model, init_weights
from medicalsemseg_tpu_torch.models.layers import DropPath, Dropout
from medicalsemseg_tpu_torch.ops.kernels import sr_attention as ksr

from tests.test_torch_model import (
    assert_train_step_matches,
    model_inputs,
    small_cfg,
    train_step_both,
)
from tests.test_torch_run_training import train_and_resume

torch.backends.cudnn.allow_tf32 = False
torch.backends.cuda.matmul.allow_tf32 = False

CFG = dict(model="SegFormer3D", vol_size=64, depths=(1, 1, 1, 1),
           drop_path_rate=0.0)


@pytest.fixture(scope="module")
def both():
    return train_step_both(small_cfg(**CFG), seed=41)


def test_loss_and_every_gradient_match_jax(both):
    assert_train_step_matches(both)


def test_batch_stats_moved_as_flax_moved_them(both):
    """The running statistics after one training apply are flax's (checked
    above) and differ from the ones the step started from."""
    start, moved = both["stats0"], both["port"][2]
    for name in ("mean", "var"):
        a = start["linear_fuse"]["BatchNorm_0"]["BatchNorm_0"][name]
        b = moved["linear_fuse"]["BatchNorm_0"]["BatchNorm_0"][name]
        assert abs(a - b).max() > 1e-4, name


def test_training_runs_no_kernel_without_a_backward(monkeypatch):
    """In training the SR attention never calls K7's wrapper; without
    gradients in eval mode it always does. Drop path rises linearly over the
    blocks (factory's --drop_path_rate) and the head carries a Dropout of
    0.1."""
    calls = []
    orig = ksr.sr_attention
    monkeypatch.setattr(ksr, "sr_attention",
                        lambda *a, **k: calls.append(1) or orig(*a, **k))
    cfg = small_cfg(model="SegFormer3D", depths=(2, 1, 1, 1),
                    drop_path_rate=0.3)
    model = init_weights(build_model(cfg), torch.Generator().manual_seed(0))
    rates = [m.rate for m in model.modules() if isinstance(m, DropPath)]
    assert rates == pytest.approx([0.0, 0.075, 0.15, 0.225, 0.3])
    assert [m.rate for m in model.modules() if isinstance(m, Dropout)] == [0.1]
    x_in = tuple(torch.from_numpy(a) for a in model_inputs(cfg))
    model.train()(x_in).sum().backward()
    assert not calls
    with torch.inference_mode():
        model.eval()(x_in)
    assert len(calls) == 5


def test_cli_trains_checkpoints_and_resumes(tmp_path):
    train_and_resume(tmp_path, ["--model", "SegFormer3D", "--vol_size", "32",
                                "--hidden_dim", "8", "--depths", "1", "1",
                                "1", "1", "--num_heads", "1", "1", "2", "2"])
