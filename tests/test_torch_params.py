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
