"""Training of the port's GCViTUNETR against the JAX model on the CPU.

A small model (vol 32, hidden 12, depths 2-2-2-2, heads 2-2-2-2, window 2,
3 classes, drop path 0) gets JAX parameters filled from a seeded numpy
generator and the same batch on both sides, in fp32. The JAX model trains
every block through XLA (its levels never set ``pallas_train``); the port's
local blocks run K1 / K3 through ``WindowAttentionFn`` and its MLPs K2 / K4
through ``FusedMlpFn`` (their plain versions on the CPU), its global blocks
the module's own unfused attention. One jitted JAX step. The CLI trains the
model for a few steps, checkpoints and resumes.
"""

import numpy as np
import pytest
import torch

from medicalsemseg_tpu_torch.models import gcvit
from medicalsemseg_tpu_torch.models.factory import init_weights
from medicalsemseg_tpu_torch.ops import window as tw
from medicalsemseg_tpu_torch.ops.kernels import global_attention as kga
from medicalsemseg_tpu_torch.ops.kernels import window_attention as kwa

from tests.test_torch_model import (
    assert_train_step_matches,
    flat_tree,
    small_cfg,
    train_step_both,
)
from tests.test_torch_run_training import train_and_resume

torch.backends.cudnn.allow_tf32 = False
torch.backends.cuda.matmul.allow_tf32 = False


@pytest.fixture(scope="module")
def both():
    return train_step_both(small_cfg(model="GCViTUNETR", drop_path_rate=0.0),
                           seed=31)


def test_loss_and_every_gradient_match_jax(both):
    """Every parameter's gradient, the query pyramid's (FeatExtract convs and
    SE gates, reached only through the global blocks) and the bias tables'
    included."""
    assert_train_step_matches(both)
    pyramid = [v for k, v in flat_tree(both["port"][1]).items()
               if "to_q_global" in k]
    assert pyramid and all(np.abs(v).max() > 0 for v in pyramid)


def test_blocks_take_the_training_forms(monkeypatch):
    """In training a local block calls K1's and K3's wrappers (through the
    autograd function) and a global block calls no K6 wrapper; in eval mode
    without gradients both call their kernels' wrappers."""
    calls = {"fwd": 0, "bwd": 0, "global": 0}

    def spy(mod, name, key):
        fn = getattr(mod, name)

        def wrapped(*a, **k):
            calls[key] += 1
            return fn(*a, **k)
        monkeypatch.setattr(mod, name, wrapped)

    spy(kwa, "window_attention", "fwd")
    spy(kwa, "window_attention_bwd", "bwd")
    spy(kga, "global_window_attention", "global")
    enc = init_weights(gcvit.GCViT3D((8, 8, 8), dim=8, depths=(2,),
                                     num_heads=(2,), window_sizes=(2,),
                                     drop_path_rate=0.0),
                       torch.Generator().manual_seed(0))
    vol = torch.randn(2, 8, 8, 8, 1)
    enc.train()(vol)[-1].sum().backward()
    assert calls == {"fwd": 1, "bwd": 1, "global": 0}
    with torch.inference_mode():
        enc.eval()(vol)
    assert calls == {"fwd": 2, "bwd": 1, "global": 1}


def test_ref_quirk_bias_gradient_reaches_the_table():
    """With the reference's colliding index, K3's (nh, N, N) bias gradient
    goes onto the table through that index: the table's gradient equals
    autograd's through the plain forward's gather."""
    torch.manual_seed(0)
    attn = gcvit.GCWindowAttention(8, 2, 2, use_global=False,
                                   ref_quirk_index=True)
    with torch.no_grad():
        attn.relative_position_bias_table.normal_()
    wins = torch.randn(4, 8, 8)
    ln = torch.stack([torch.ones(8), torch.zeros(8)])
    dy = torch.randn(4, 8, 8)
    (attn(wins, None, (2, 2, 1), ln) * dy).sum().backward()
    got = attn.relative_position_bias_table.grad.clone()

    table = attn.relative_position_bias_table.detach().clone()
    table.requires_grad_(True)
    bias = tw.gather_rel_bias(table, attn.rel_index, 8)
    out = kwa.window_attention_plain(
        wins, attn.qkv.weight.detach(), attn.qkv.bias.detach(),
        attn.proj.weight.detach(), attn.proj.bias.detach(), bias,
        grid_dims=(2, 2, 1), window=(2, 2, 2), shift=(0, 0, 0), ln=ln,
        residual=True)
    (out * dy).sum().backward()
    # the quirk index collides: some table rows gather several offsets
    assert len(set(attn.rel_index.tolist())) < attn.rel_index.numel()
    np.testing.assert_allclose(got.numpy(), table.grad.numpy(), rtol=1e-5,
                               atol=1e-6)


def test_cli_trains_checkpoints_and_resumes(tmp_path):
    train_and_resume(tmp_path, ["--model", "GCViTUNETR", "--vol_size", "16",
                                "--hidden_dim", "8", "--depths", "2", "2",
                                "--num_heads", "2", "2"])
