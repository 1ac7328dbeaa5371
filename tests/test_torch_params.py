"""Parameter round trip between the JAX flagship and the port.

JAX tree -> ``state_dict_from_jax`` -> the port's model -> its
``state_dict()`` -> the JAX package's reference importer
``import_swin_unetr_checkpoint`` gives back the same tree, leaf for leaf,
and the port's state_dict keys are exactly the keys the importer reads.
"""

import jax
import numpy as np
import pytest
import torch

from medicalsemseg_tpu.utils.torch_import import import_swin_unetr_checkpoint

from medicalsemseg_tpu_torch.utils.params import (
    load_checkpoint,
    state_dict_from_jax,
)

from tests.test_torch_model import jax_params, port_model, small_cfg


class _RecordingDict(dict):
    """A state_dict that records the keys a reader fetches."""

    def __init__(self, *a, **kw):
        super().__init__(*a, **kw)
        self.read = set()

    def __getitem__(self, k):
        self.read.add(k)
        return super().__getitem__(k)


def _flat(tree):
    return {jax.tree_util.keystr(p): np.asarray(v)
            for p, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


@pytest.mark.parametrize("qkv_bias,window", [(True, 2), (False, 3)])
def test_roundtrip_through_reference_importer(qkv_bias, window):
    cfg = small_cfg(qkv_bias=qkv_bias, window_size=window)
    _, params = jax_params(cfg, seed=11)
    model = port_model(cfg, params)
    sd = _RecordingDict({k: v for k, v in model.state_dict().items()})
    back = import_swin_unetr_checkpoint(sd, num_layers=4)

    want, got = _flat(params), _flat(back)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert sd.read == set(sd.keys())


def test_load_checkpoint_layouts(tmp_path):
    """{'model': sd} with DDP 'module.' prefixes, or a bare state_dict."""
    cfg = small_cfg()
    _, params = jax_params(cfg, seed=12)
    sd = state_dict_from_jax(params)
    wrapped = tmp_path / "wrapped.pth"
    torch.save({"model": {f"module.{k}": v for k, v in sd.items()},
                "epoch": 3}, wrapped)
    bare = tmp_path / "bare.pth"
    torch.save(sd, bare)
    for path in (wrapped, bare):
        loaded = load_checkpoint(str(path))
        assert loaded.keys() == sd.keys()
        model = port_model(cfg, params)
        model.load_state_dict(loaded, strict=True)


OPTIONS = dict(learned_cls_vectors=True, lcv_final_layer=True,
               rel_crop_pos_emb=True, abs_pos_emb=True, patch_size=(2, 2, 1),
               rel_pos_bias_affine=True, global_token=True,
               t_fixed_ct_intensity=True, depths=(2, 2, 1, 1))


def _reference_layout(sd):
    """The port's state_dict in the reference's layout: the class vectors
    as a ParameterList (``encoder.lcv.vectors.{k}``, a row each)."""
    out = dict(sd)
    vectors = out.pop("encoder.lcv.vectors")
    for k, row in enumerate(vectors):
        out[f"encoder.lcv.vectors.{k}"] = row.clone()
    return out


def test_option_leaves_roundtrip_through_reference_importer():
    """Every leaf of the encoder's options (class vectors and their final
    layer, the crop embedding, the global token, its projections and
    upsamplings, the affine tables and dense layers) reaches the reference
    importer under the key it reads."""
    cfg = small_cfg(**OPTIONS)
    _, params = jax_params(cfg, seed=13)
    sd = _RecordingDict(_reference_layout(
        port_model(cfg, params).state_dict()))
    back = import_swin_unetr_checkpoint(sd, num_layers=4)
    want, got = _flat(params), _flat(back)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert sd.read == set(sd.keys())
    assert sum("gt_upsample" in k for k in want) == 8
    assert sum("rel_pos_bias_affine" in k for k in want) == 6 * 3


@pytest.mark.parametrize("model", ["SwInception", "SwinDepth"])
def test_batch_stats_at_any_path_roundtrip(model):
    """Variables with BatchNorm statistics deep in the encoder's blocks ->
    the port's state_dict (every key of the model, loaded strictly) -> back
    to the same variables, leaf for leaf."""
    from medicalsemseg_tpu_torch.models.factory import build_model
    from medicalsemseg_tpu_torch.utils.params import (
        jax_tree_from_state_dict,
        key_map,
    )

    from tests.test_torch_model import jax_variables

    cfg = small_cfg(model=model, depths=(2, 2, 1, 1))
    _, variables = jax_variables(cfg, seed=14)
    sd = state_dict_from_jax(variables)
    port = build_model(cfg)
    port.load_state_dict(sd, strict=True)
    back = jax_tree_from_state_dict(port.state_dict(), variables)
    want, got = _flat(variables), _flat(back)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    stats = [key for path, key, _ in key_map(variables)
             if path[0] == "batch_stats"]
    per_block = 11 if model == "SwInception" else 3
    assert len(stats) == 2 * 6 * per_block
    assert all(".mlp." in k and k.endswith(("running_mean", "running_var"))
               for k in stats)


def test_load_pretrained_encoder_stacks_the_class_vectors(tmp_path):
    """A reference checkpoint keeps the class vectors a row a key; the
    port's loader stacks them into its table, and every other encoder leaf
    of the options loads as it is."""
    from medicalsemseg_tpu_torch.models.factory import build_model
    from medicalsemseg_tpu_torch.utils.params import load_pretrained_encoder

    cfg = small_cfg(**OPTIONS)
    _, params = jax_params(cfg, seed=15)
    sd = port_model(cfg, params).state_dict()
    path = tmp_path / "ref.pth"
    torch.save({"model": _reference_layout(sd)}, path)
    fresh = build_model(cfg)
    loaded = load_pretrained_encoder(fresh, str(path))
    assert "encoder.lcv.vectors" in loaded
    own = fresh.state_dict()
    for k in loaded:
        assert torch.equal(own[k], sd[k]), k
