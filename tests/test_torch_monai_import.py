"""The port's MONAI and Video-Swin checkpoint imports
(``utils/torch_import.py``) against the JAX package's on the CPU.

Synthetic checkpoints are made from seeded weights of the small models of
``tests/test_torch_swin_official.py`` (vol 32, hidden 12, depths 2-2-1-1):
a MONAI SSL dict (``{'state_dict': {'module.<key>'}}``, the MLP named
``fc`` or ``linear``), a whole MONAI SwinUNETR state_dict (DDP prefix,
``linear1`` / ``linear2``, a ``relative_position_index`` buffer the imports
leave out) and a Video-Swin dict with a flat ``absolute_pos_embed``. The
port's import equals the JAX import carried by ``state_dict_from_jax``, key
for key and bit for bit, and SwinUNETR_Official with the imported weights
gives the JAX model's logits.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from medicalsemseg_tpu.utils import torch_import as jti

from medicalsemseg_tpu_torch.models.factory import build_model
from medicalsemseg_tpu_torch.utils import torch_import as pti
from medicalsemseg_tpu_torch.utils.params import state_dict_from_jax

from tests.test_torch_model import jax_params, model_inputs, small_cfg

DEPTHS = (2, 2, 1, 1)


def _cfg(**kw):
    return small_cfg(depths=DEPTHS, drop_path_rate=0.0, **kw)


def _monai_names(sd, linear: bool):
    """The port's keys as a MONAI file names them: ``linear1`` / ``linear2``
    for a trained model's MLPBlock, ``fc1`` / ``fc2`` for SSL weights."""
    if not linear:
        return dict(sd)
    return {k.replace(".mlp.fc1.", ".mlp.linear1.")
            .replace(".mlp.fc2.", ".mlp.linear2."): v for k, v in sd.items()}


def _assert_same(got, want):
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == torch.float32, k
        torch.testing.assert_close(got[k], want[k], rtol=0, atol=0,
                                   msg=k)


@pytest.fixture(scope="module")
def official():
    cfg = _cfg(model="SwinUNETR_Official")
    jmodel, params = jax_params(cfg, seed=61)
    return cfg, jmodel, params, state_dict_from_jax(params)


@pytest.mark.parametrize("linear", [False, True], ids=["fc", "linear"])
@pytest.mark.parametrize("wrapped", [False, True], ids=["bare", "module"])
def test_ssl_import_equals_jax(official, linear, wrapped):
    cfg, _, params, sd = official
    vit = {k[len("swinViT."):]: v for k, v in sd.items()
           if k.startswith("swinViT.")}
    vit = _monai_names(vit, linear)
    vit["layers1.0.blocks.0.attn.relative_position_index"] = torch.zeros(8)
    if wrapped:
        vit = {"state_dict": {"module." + k: v for k, v in vit.items()}}
    want_tree = dict(params)
    want_tree["swinViT"] = jti.import_swin_unetr_official(
        vit, DEPTHS)["swinViT"]
    want = {k: v for k, v in state_dict_from_jax(want_tree).items()
            if k.startswith("swinViT.")}
    got = pti.import_swin_unetr_official(vit, DEPTHS)
    _assert_same(got, want)
    # the encoder's keys of the model, and no other
    model = build_model(cfg)
    missing, unexpected = model.load_state_dict(got, strict=False)
    assert not unexpected
    assert not [k for k in missing if k.startswith("swinViT.")]


def test_full_import_equals_jax_and_predicts_as_jax(official):
    cfg, jmodel, _, sd = official
    full = {"module." + k: v for k, v in _monai_names(sd, True).items()}
    full["module.swinViT.layers2.0.blocks.1.attn.relative_position_index"] = \
        torch.zeros(3)
    jtree = jti.import_swin_unetr_official_full(full, DEPTHS)
    got = pti.import_swin_unetr_official_full(full, DEPTHS)
    _assert_same(got, state_dict_from_jax(jtree))
    model = build_model(cfg)
    model.load_state_dict(got, strict=True)
    x_in = model_inputs(cfg, batch=1, seed=62)
    want = np.asarray(jax.jit(lambda p, x: jmodel.apply(
        {"params": p}, x, deterministic=True))(
            jtree, tuple(jnp.asarray(a) for a in x_in)))
    with torch.inference_mode():
        logits = model.eval()(tuple(torch.from_numpy(a) for a in x_in))
    np.testing.assert_allclose(logits.numpy(), want, rtol=0,
                               atol=1e-4 * np.abs(want).max())


def test_video_swin_import_equals_jax():
    cfg = _cfg(model="VideoSwinUNETR", abs_pos_emb=True)
    _, params = jax_params(cfg, seed=63)
    enc = {k[len("encoder."):]: v for k, v in
           state_dict_from_jax(params).items() if k.startswith("encoder.")}
    grid = tuple(enc["absolute_pos_embed"].shape[1:4])
    enc["absolute_pos_embed"] = enc["absolute_pos_embed"].reshape(
        1, -1, enc["absolute_pos_embed"].shape[-1])
    enc = {"module." + k: v for k, v in enc.items()}
    want_tree = dict(params)
    want_tree["encoder"] = jti.import_video_swin(enc, DEPTHS, grid)
    want = {k: v for k, v in state_dict_from_jax(want_tree).items()
            if k.startswith("encoder.")}
    got = pti.import_video_swin(enc, DEPTHS, grid)
    _assert_same(got, want)
    build_model(cfg).load_state_dict(
        got | {k: v for k, v in state_dict_from_jax(params).items()
               if not k.startswith("encoder.")}, strict=True)


@pytest.mark.parametrize("extra,src,dst", [(1, (4, 4, 4), (8, 6, 4)),
                                           (0, (3, 3, 3), (5, 5, 5)),
                                           (0, (2, 4, 3), (2, 4, 3))])
def test_resize_abs_pos_embed_equals_jax(extra, src, dst):
    """Against ``tests/test_torch_import.py``'s case: the class token in
    front unchanged, a constant field constant, the JAX values exactly."""
    rng = np.random.default_rng(1)
    pos = rng.normal(size=(1, extra + int(np.prod(src)), 6)).astype(np.float32)
    got = pti.resize_abs_pos_embed(pos, src, dst, num_extra_tokens=extra)
    want = jti.resize_abs_pos_embed(pos, src, dst, num_extra_tokens=extra)
    assert got.shape == (1, extra + int(np.prod(dst)), 6)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got[:, :extra], pos[:, :extra])
    np.testing.assert_array_equal(
        pti.resize_abs_pos_embed(pos[0], src, dst, extra), want[0])
    const = np.full((1, int(np.prod(src)), 5), 3.25, np.float32)
    np.testing.assert_allclose(pti.resize_abs_pos_embed(const, src, dst),
                               3.25, rtol=1e-6)
    with pytest.raises(ValueError, match="do not fill"):
        pti.resize_abs_pos_embed(pos[:, 1:], (9, 9, 9), dst)
