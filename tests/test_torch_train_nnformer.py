"""Training and the CLIs of the port's official nnFormer against the JAX
package on the CPU.

One jitted JAX step of a small model (vol 32, hidden 12, depths 2-2-1-1,
heads 2-2-2-2, window 2, 3 classes, drop path 0, fp32) under
``--deep_supervision`` with ``--ref_quirk_rel_pos``: the loss over the three
heads (``_deep_supervision_loss``) within 1e-4, every gradient leaf within
2e-2 of its norm and all together within 5e-3 (``assert_train_step_matches``).
The JAX model trains through XLA (quirk-index blocks never take its Pallas
VJP); the port's Swin blocks run K1 / K3 with the colliding index (K3's bias
gradient scattered back through it) and every MLP K2 / K4, their plain
versions here. The training CLI trains with deep supervision, checkpoints
and resumes; the prediction CLI agrees with the JAX CLI voxel for voxel but
for ties.
"""

import glob
import os
import types

import numpy as np
import pytest
import torch

import jax

from medicalsemseg_tpu.data import nifti

from medicalsemseg_tpu_torch.cli import run_test as port_cli
from medicalsemseg_tpu_torch.models import swin
from medicalsemseg_tpu_torch.ops import window as tw
from medicalsemseg_tpu_torch.ops.kernels import window_attention as kwa
from medicalsemseg_tpu_torch.utils.params import state_dict_from_jax

from tests.test_torch_model import (
    assert_train_step_matches,
    jax_variables,
    small_cfg,
    train_step_both,
)
from tests.test_torch_run_test import ARGV as TEST_ARGV
from tests.test_torch_run_test import _write_test_set
from tests.test_torch_run_training import train_and_resume

torch.backends.cudnn.allow_tf32 = False
torch.backends.cuda.matmul.allow_tf32 = False


@pytest.fixture(scope="module")
def both():
    cfg = small_cfg(model="nnFormer", depths=(2, 2, 1, 1), drop_path_rate=0.0,
                    deep_supervision=True, ref_quirk_rel_pos=True)
    return train_step_both(cfg, seed=41)


def test_loss_and_every_gradient_match_jax(both):
    """The heads at 1/2 and 1/4 and the decoder's cross blocks reach the
    loss; the last stage's merging does not (a zero gradient on both
    sides)."""
    assert_train_step_matches(both)
    grads = both["port"][1]
    for head in ("final_1", "final_2", "dec_0_cross"):
        assert any(np.abs(v).max() > 0 for v in
                   jax.tree_util.tree_leaves(grads[head])), head
    assert all(not np.any(v) for v in jax.tree_util.tree_leaves(
        grads["layers_3"]["downsample"]))


def test_quirk_bias_gradient_reaches_the_table():
    """A Swin block's attention with the reference's colliding index: K3's
    (nh, N, N) bias gradient goes onto the table through that index, as
    autograd's through the plain forward's gather."""
    torch.manual_seed(0)
    attn = swin.WindowAttention(8, 2, 2, qkv_bias=True, ref_quirk_index=True)
    with torch.no_grad():
        for p in attn.parameters():
            p.normal_(0.0, 0.5)
    wins, dy = torch.randn(4, 8, 8), torch.randn(4, 8, 8)
    (attn(wins, (2, 2, 1), 1) * dy).sum().backward()
    got = attn.relative_position_bias_table.grad.clone()
    table = attn.relative_position_bias_table.detach().clone()
    table.requires_grad_(True)
    out = kwa.window_attention_plain(
        wins, attn.qkv.weight.detach(), attn.qkv.bias.detach(),
        attn.proj.weight.detach(), attn.proj.bias.detach(),
        tw.gather_rel_bias(table, attn.rel_index, 8), grid_dims=(2, 2, 1),
        window=(2, 2, 2), shift=(1, 1, 1))
    (out * dy).sum().backward()
    assert len(set(attn.rel_index.tolist())) < attn.rel_index.numel()
    np.testing.assert_allclose(got.numpy(), table.grad.numpy(), rtol=1e-5,
                               atol=1e-6)


def test_fused_loss_takes_strided_labels():
    """Deep supervision hands the loss strided views of the labels
    (``labels[:, ::2, ::2, ::2]``): K8's autograd function makes them
    contiguous (``reshape``) before its wrapper's checks; loss and logits
    gradient equal the unfused loss's."""
    from medicalsemseg_tpu_torch.ops.kernels.dice_ce import dice_ce_fused
    from medicalsemseg_tpu_torch.train.losses import dice_ce_loss

    gen = torch.Generator().manual_seed(5)
    labels = torch.randint(0, 3, (2, 16, 16, 16), generator=gen)
    lab = labels[:, ::2, ::2, ::2]
    assert not lab.is_contiguous()
    logits = torch.randn(2, 8, 8, 8, 3, generator=gen, requires_grad=True)
    got = dice_ce_fused(logits, lab)
    (g_got,) = torch.autograd.grad(got, logits)
    want = dice_ce_loss(logits, lab.contiguous())
    (g_want,) = torch.autograd.grad(want, logits)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(g_got, g_want, rtol=1e-4, atol=1e-7)


def test_cli_trains_with_deep_supervision_and_resumes(tmp_path):
    """Three stages at roi 16: heads at full resolution and 1/2."""
    train_and_resume(tmp_path, ["--model", "nnFormer", "--hidden_dim", "8",
                                "--depths", "1", "1", "1", "--num_heads",
                                "2", "2", "2", "--deep_supervision"])


def test_prediction_cli_matches_jax(tmp_path, monkeypatch):
    from medicalsemseg_tpu.cli import run_test as jax_cli
    from medicalsemseg_tpu.config import get_args

    _write_test_set(tmp_path)
    argv = TEST_ARGV + ["--model", "nnFormer", "--depths", "2", "2",
                        "--ref_quirk_rel_pos", "--data_path", str(tmp_path)]
    cfg_j = get_args(argv + ["--output_dir", str(tmp_path / "jax")])
    cfg_t = port_cli.get_args(
        argv + ["--output_dir", str(tmp_path / "port"), "--device", "cpu",
                "--resume", str(tmp_path / "w.pth")])
    _, variables = jax_variables(cfg_j, seed=43)
    torch.save({"model": state_dict_from_jax(variables)}, tmp_path / "w.pth")
    state = types.SimpleNamespace(params=variables["params"], batch_stats={})
    monkeypatch.setattr(jax_cli, "create_train_state",
                        lambda *a, **k: (state, None))
    real_devices = jax.local_devices
    monkeypatch.setattr(jax, "local_devices",
                        lambda *a, **k: real_devices()[:1])
    jax_cli.main(cfg_j)
    port_cli.main(cfg_t)
    want = sorted(glob.glob(str(tmp_path / "jax" / "test_output" / "Fold0"
                                / "pred" / "*")))
    got = sorted(glob.glob(str(tmp_path / "port" / "test_output" / "Fold0"
                               / "pred" / "*")))
    assert len(got) == len(want) == 2
    for g, w in zip(got, want):
        assert os.path.basename(g) == os.path.basename(w)
        gi, wi = nifti.load(g), nifti.load(w)
        assert gi.data.shape == wi.data.shape
        assert (gi.data == wi.data).mean() >= 0.999, g
