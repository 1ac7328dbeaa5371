"""The Swin encoder's option sets in the port against the JAX package on
the CPU.

* the small flagship (vol 32, C = 12, depths 2-2-1-1, heads 2-2-2-2, window
  2, 3 classes) with the embedding options together (class vectors with
  their final layer, the crop position, the sin-cos table, ``--patch_size 2
  2 1``) and with the attention options together (the affine-scaled bias
  and the global token), on a batch of two with per-sample crop positions
  and a non-uniform spacing; SwInception and SwinDepth with all of them;
  SwinSegFormer with ``--abs_pos_emb``;
* which blocks run the unfused attention (the options, not a shape), and
  that their MLPs keep K2 / K4;
* GCViTUNETR refuses an anisotropic patch where the JAX model cannot run;
* the prediction CLI with every option against the JAX CLI on the same
  weights: the crop positions and spacings that the sliding window hands
  the model.

fp32 on both sides, ``RTOL = ATOL = 1e-4``.
"""

import glob
import os
import types

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from medicalsemseg_tpu_torch.cli import run_test as port_cli
from medicalsemseg_tpu_torch.data import nifti
from medicalsemseg_tpu_torch.models.factory import build_model, init_weights
from medicalsemseg_tpu_torch.ops.kernels import mlp as kmlp
from medicalsemseg_tpu_torch.ops.kernels import window_attention as kwa

from medicalsemseg_tpu_torch.utils.params import state_dict_from_jax

from tests.test_torch_model import ATOL, RTOL, jax_variables, small_cfg
from tests.test_torch_run_test import ARGV, _write_test_set
from tests.test_torch_swin_options import CFG, logits_both, model_inputs

torch.backends.cudnn.allow_tf32 = False
torch.backends.cuda.matmul.allow_tf32 = False

EMBEDDING = dict(learned_cls_vectors=True, lcv_final_layer=True,
                 rel_crop_pos_emb=True, abs_pos_emb=True, patch_size=(2, 2, 1))
ATTENTION = dict(rel_pos_bias_affine=True, global_token=True)


@pytest.mark.parametrize("model,options", [
    ("nnFormerUNETR", EMBEDDING),
    ("nnFormerUNETR", ATTENTION),
    ("SwInception", {**EMBEDDING, **ATTENTION}),
    ("SwinDepth", {**EMBEDDING, **ATTENTION}),
    ("SwinSegFormer", dict(abs_pos_emb=True)),
], ids=["embedding", "attention", "SwInception_all", "SwinDepth_all",
        "SwinSegFormer_abs"])
def test_option_sets_match_jax(model, options):
    got, want = logits_both(small_cfg(model=model, **{**CFG, **options}),
                             seed=43)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


def test_unfused_attention_by_the_options_alone(monkeypatch):
    """Blocks with the affine bias or the global token run the unfused
    attention at inference and in training, at every stage whatever its
    grid; their MLPs run K2 (K4 in training). Without the options every
    block runs K1 (K3), including the anisotropic patch's grids."""
    calls = {n: 0 for n in ("attn", "attn_bwd", "mlp", "mlp_bwd")}
    for mod, name, key in ((kwa, "window_attention", "attn"),
                           (kwa, "window_attention_bwd", "attn_bwd"),
                           (kmlp, "fused_mlp", "mlp"),
                           (kmlp, "fused_mlp_bwd", "mlp_bwd")):
        fn = getattr(mod, name)
        monkeypatch.setattr(mod, name, lambda *a, _f=fn, _k=key, **kw: (
            calls.__setitem__(_k, calls[_k] + 1) or _f(*a, **kw)))
    x_in = tuple(torch.from_numpy(a)
                 for a in model_inputs(small_cfg(**CFG), 5))
    for options, fused in ((ATTENTION, False), (EMBEDDING, True),
                           (dict(rel_pos_bias_affine=True), False),
                           (dict(global_token=True), False)):
        cfg = small_cfg(**{**CFG, **options})
        model = init_weights(build_model(cfg),
                             torch.Generator().manual_seed(0))
        blocks = [m for m in model.modules() if hasattr(m, "mlp_type")]
        assert len(blocks) == 6
        assert all(b.attn.fused is fused for b in blocks)
        for k in calls:
            calls[k] = 0
        with torch.inference_mode():
            model.eval()(x_in)
        model.train()(x_in).sum().backward()
        n = 6 if fused else 0
        # inference, then training, whose forward runs again in the backward
        # under the default --remat conv (models/layers.py checkpoint_block)
        assert cfg.remat == "conv"
        assert calls == {"attn": 3 * n, "attn_bwd": n, "mlp": 18,
                         "mlp_bwd": 6}, options


def test_gcvit_refuses_an_anisotropic_patch():
    """GC-ViT's stem halves every axis, and the decoder's first up-block
    upsamples by the patch: the JAX model cannot join the full-resolution
    skip at --patch_size 2 2 1, and the port refuses it at build time."""
    from medicalsemseg_tpu.models import build_model as jax_build_model

    cfg = small_cfg(model="GCViTUNETR", patch_size=(2, 2, 1), vol_size=16,
                    depths=(1, 1), num_heads=(2, 2))
    jmodel = jax_build_model(cfg)
    x_in = (jnp.zeros((1, 16, 16, 16, 1)), jnp.zeros((1, 3)),
            jnp.ones((1, 3)))
    with pytest.raises(Exception):
        jax.eval_shape(lambda r, x: jmodel.init(r, x, deterministic=True),
                       jax.random.PRNGKey(0), x_in)
    with pytest.raises(ValueError, match="GCViTUNETR needs --patch_size 2"):
        build_model(cfg)


def test_prediction_cli_with_every_option_matches_jax(tmp_path, monkeypatch):
    """The flagship with all the options through both CLIs (two stages at
    roi 16, fp32): the predicted labels agree voxel for
    voxel but for ties (>= 99.9 %), so every window got the crop position
    and the spacing the JAX sliding window hands its model."""
    from medicalsemseg_tpu.cli import run_test as jax_cli
    from medicalsemseg_tpu.config import get_args

    _write_test_set(tmp_path)
    options = ["--learned_cls_vectors",
               "--lcv_final_layer", "--rel_crop_pos_emb", "--abs_pos_emb",
               "--rel_pos_bias_affine", "--global_token", "--patch_size", "2",
               "2", "1"]
    argv = ARGV + options + ["--data_path", str(tmp_path)]
    cfg_j = get_args(argv + ["--output_dir", str(tmp_path / "jax")])
    cfg_t = port_cli.get_args(
        argv + ["--output_dir", str(tmp_path / "port"), "--device", "cpu",
                "--resume", str(tmp_path / "w.pth")])
    _, variables = jax_variables(cfg_j, seed=47)
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
