"""Training of the port's SwinDepth on the CPU.

SwinDepth's step differs from SwInception's only in the token MLP: the
encoder, the blocks' MLP form (LN2 outside, the MLP over the token grid, the
shortcut after it) and the decoder are SwInception's, whose step is held
against one jitted JAX step in ``test_torch_train_swinception.py``; the
depthwise MLP is held alone against the JAX module in training (output,
every gradient, the input's included, and the BatchNorm statistics) in
``test_torch_swin_mlps.py``. Here one training-mode step of the port (vol 32,
C = 12, depths 2-2-1-1, heads 2-2-2-2, window 2, 3 classes, drop path 0):
it reaches every parameter of the encoder and moves every BatchNorm's
running statistics, also with every option of the Swin encoder; and the CLI
trains the model for a few steps, checkpoints and resumes.
"""

import numpy as np
import pytest
import torch

from medicalsemseg_tpu_torch.models.factory import build_model, init_weights
from medicalsemseg_tpu_torch.models.layers import BatchNorm
from medicalsemseg_tpu_torch.train.losses import build_loss

from tests.test_torch_model import small_cfg
from tests.test_torch_run_training import train_and_resume

OPTIONS = dict(learned_cls_vectors=True, lcv_final_layer=True,
               rel_crop_pos_emb=True, abs_pos_emb=True, patch_size=(2, 2, 1),
               rel_pos_bias_affine=True, global_token=True,
               t_fixed_ct_intensity=True)


def port_step(model, options=None):
    """The model (init weights, seed 5), its running variances before one
    training-mode forward and backward on a seeded batch of two with
    per-sample crop positions and spacings, and the loss."""
    cfg = small_cfg(model=model, depths=(2, 2, 1, 1), drop_path_rate=0.0,
                    **(options or {}))
    net = init_weights(build_model(cfg), torch.Generator().manual_seed(5))
    before = {n: b.clone() for n, b in net.named_buffers()
              if n.endswith("running_var")}
    rng = np.random.default_rng(6)
    v = cfg.vol_size3()
    img = torch.from_numpy(rng.normal(size=(2, *v, 1)).astype(np.float32))
    label = torch.from_numpy(rng.integers(0, 3, size=(2, *v)))
    crop = torch.tensor([[0.2, 0.5, 0.9], [0.7, 0.1, 0.4]])
    affine = torch.tensor([[0.8, 0.8, 2.5], [1.5, 1.0, 0.7]])
    loss = build_loss(cfg)(net.train()((img, crop, affine)), label)
    loss.backward()
    return net, before, loss


def test_every_depthwise_batchnorm_moved():
    """18 BatchNorms (3 in each of 6 blocks' depthwise MLP), each with its
    running statistics moved by the step."""
    net, before, _ = port_step("SwinDepth")
    moved = [n for n, b in net.named_buffers()
             if n in before and not torch.equal(b, before[n])]
    assert len(moved) == len(before) == 18
    assert all(".mlp.bns." in n for n in moved)


@pytest.mark.parametrize("model,options", [
    ("SwInception", None), ("SwinDepth", None), ("SwinDepth", OPTIONS),
], ids=["SwInception", "SwinDepth", "SwinDepth_options"])
def test_port_step_reaches_every_parameter(model, options):
    """A finite loss, a non-zero gradient for every parameter of the
    encoder but those whose output no layer reads (the last stage's
    ``gt_upsample``, and its last block's ``gt_proj``, which makes the token
    only ``gt_upsample`` takes), and every BatchNorm's running statistics
    moved."""
    net, before, loss = port_step(model, options)
    assert torch.isfinite(loss)
    last = len(net.encoder.layers[3].blocks) - 1
    unread = (f"encoder.layers.3.blocks.{last}.attn.gt_proj",
              "encoder.layers.3.gt_upsample")
    for n, p in net.encoder.named_parameters(prefix="encoder"):
        reached = p.grad is not None and bool(p.grad.abs().max() > 0)
        assert reached == (not n.startswith(unread)), n
    assert len(before) == sum(isinstance(m, BatchNorm)
                              for m in net.modules())
    for n, b in net.named_buffers():
        if n in before:
            assert not torch.equal(b, before[n]), n


def test_cli_trains_checkpoints_and_resumes(tmp_path):
    first, _ = train_and_resume(tmp_path, ["--model", "SwinDepth"])
    assert any(".mlp.bns.2.running_var" in k for k in first["model"])
