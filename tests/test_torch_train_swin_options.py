"""Training of the small flagship with every option of the Swin encoder
against the JAX model on the CPU.

The embedding options (class vectors with their final layer, the crop
position, the sin-cos table, ``--patch_size 2 2 1``) and the attention
options (the affine-scaled bias, the global token) together, vol 32, C = 12,
depths 2-2-1-1, heads 2-2-2-2, window 2, 3 classes, drop path 0, on a batch
of two with per-sample crop positions and spacings: loss and every gradient
(the class vectors, the crop embedding's, the affine tables and dense
layers, the global token and its projections included) against one jitted
JAX step, in fp32 (the tolerances of ``test_torch_train_step.py``). The CLI
trains the model for a few steps, checkpoints and resumes.
"""

import numpy as np
import pytest
import torch

from tests.test_torch_model import (
    assert_train_step_matches,
    flat_tree,
    small_cfg,
    train_step_both,
)
from tests.test_torch_run_training import train_and_resume

torch.backends.cudnn.allow_tf32 = False
torch.backends.cuda.matmul.allow_tf32 = False

OPTIONS = dict(learned_cls_vectors=True, lcv_final_layer=True,
               rel_crop_pos_emb=True, abs_pos_emb=True, patch_size=(2, 2, 1),
               rel_pos_bias_affine=True, global_token=True,
               t_fixed_ct_intensity=True)
CFG = dict(depths=(2, 2, 1, 1), drop_path_rate=0.0, qkv_bias=True, **OPTIONS)


@pytest.fixture(scope="module")
def both():
    crop = np.array([[0.2, 0.5, 0.9], [0.7, 0.1, 0.4]], np.float32)
    affine = np.array([[0.8, 0.8, 2.5], [1.5, 1.0, 0.7]], np.float32)
    return train_step_both(small_cfg(**CFG), seed=37, crop=crop,
                           affine=affine)


def test_loss_and_every_gradient_match_jax(both):
    assert_train_step_matches(both)


def test_the_option_parameters_have_gradients(both):
    """Each option's parameters reach the loss: a non-zero gradient on
    both sides; but the last stage's ``gt_upsample``, whose token no layer
    reads, and the ``gt_proj`` of that stage's one block, which makes the
    token only ``gt_upsample`` takes, get a zero gradient in both (and
    still decay)."""
    grads, want = flat_tree(both["port"][1]), flat_tree(both["jax"][1])
    for part in ("'lcv'", "'rel_crop_pos_emb'", "'global_token'",
                 "'rel_pos_bias_affine_emb'", "'rel_pos_bias_affine_lin'",
                 "'gt_proj'", "'gt_upsample'"):
        found = [k for k in grads if part in k]
        assert found, part
        for k in found:
            unread = "'layers_3']" in k and ("'gt_upsample'" in k
                                               or "'gt_proj'" in k)
            assert bool(np.abs(grads[k]).max() > 0) == (not unread), k
            assert bool(np.abs(want[k]).max() > 0) == (not unread), k


def test_cli_trains_checkpoints_and_resumes(tmp_path):
    first, _ = train_and_resume(tmp_path, [
        "--learned_cls_vectors", "--lcv_final_layer", "--rel_crop_pos_emb",
        "--abs_pos_emb", "--rel_pos_bias_affine", "--global_token",
        "--patch_size", "2", "2", "1"])
    for key in ("encoder.lcv.vectors", "encoder.global_token",
                "encoder.layers.0.gt_upsample.weight",
                "encoder.layers.1.blocks.0.attn.gt_proj.weight"):
        assert key in first["model"], key
