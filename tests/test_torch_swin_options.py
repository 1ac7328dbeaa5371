"""The Swin encoder's options in the port against the JAX package on the CPU.

* the HU interval tables, the two intensity transforms of the class
  vectors' table and the fixed 3D sin-cos position table, exactly;
* ``LearnedClassVectors`` alone in every variant (the JAX package's
  ``tests/test_models.py`` LCV cases and the rest), on intensities that
  include the table's own edges (``searchsorted(..., right=True)``);
* the small flagship (vol 32, C = 12, depths 2-2-1-1, heads 2-2-2-2, window
  2, 3 classes) with each option alone, on a batch of two with per-sample
  crop positions and a non-uniform spacing.

fp32 on both sides, ``RTOL = ATOL = 1e-4``. The option sets are in
``test_torch_swin_option_sets.py``, the training step with all the options
in ``test_torch_train_swin_options.py``.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from medicalsemseg_tpu_torch.models import embeddings as temb
from medicalsemseg_tpu_torch.models.factory import _lcv_transform, build_model
from medicalsemseg_tpu_torch.utils.params import state_dict_from_jax

from tests.test_torch_model import (
    ATOL,
    RTOL,
    jax_variables,
    seeded_tree,
    small_cfg,
)

torch.backends.cudnn.allow_tf32 = False
torch.backends.cuda.matmul.allow_tf32 = False

CFG = dict(depths=(2, 2, 1, 1), drop_path_rate=0.0, qkv_bias=True,
           t_fixed_ct_intensity=True)
AFFINE = np.array([[0.8, 0.8, 2.5], [1.5, 1.0, 0.7]], np.float32)


def model_inputs(cfg, seed):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(2, *cfg.vol_size3(), 1)).astype(np.float32),
            rng.uniform(size=(2, 3)).astype(np.float32), AFFINE)


def logits_both(cfg, seed):
    """The JAX model's and the port's logits, seeded variables, both fp32,
    on :func:`model_inputs`."""
    jmodel, variables = jax_variables(cfg, seed)
    x_in = model_inputs(cfg, seed + 1)
    want = jax.jit(lambda v, x: jmodel.apply(v, x, deterministic=True))(
        variables, tuple(jnp.asarray(a) for a in x_in))
    port = build_model(cfg)
    port.load_state_dict(state_dict_from_jax(variables), strict=True)
    with torch.inference_mode():
        got = port.eval()(tuple(torch.from_numpy(a) for a in x_in))
    return got.numpy(), np.asarray(want)


# ---- tables and transforms

def test_hu_tables_and_transforms_match_jax():
    from medicalsemseg_tpu.config import Config as JaxConfig
    from medicalsemseg_tpu.models import embeddings as jemb
    from medicalsemseg_tpu.models.factory import _lcv_transform as jax_lcv

    from medicalsemseg_tpu_torch.config import Config

    for name in ("HU_INTENSITY_INTERVALS", "HU_INTENSITY_INTERVALS_LC"):
        np.testing.assert_array_equal(getattr(temb, name),
                                      getattr(jemb, name))
    for fixed in (False, True):
        kw = dict(t_fixed_ct_intensity=fixed, t_ct_min=-200, t_ct_max=300)
        for table in (temb.HU_INTENSITY_INTERVALS,
                      temb.HU_INTENSITY_INTERVALS_LC):
            np.testing.assert_array_equal(
                _lcv_transform(Config(**kw))(table),
                jax_lcv(JaxConfig(**kw))(table))


@pytest.mark.parametrize("dim,grid", [(12, (4, 4, 4)), (48, (6, 6, 12)),
                                      (96, (3, 5, 2))])
def test_sincos_table_matches_jax(dim, grid):
    from medicalsemseg_tpu.models.embeddings import get_3d_sincos_pos_embed

    got = temb.get_3d_sincos_pos_embed(dim, grid)
    assert got.dtype == np.float64 and got.shape == (int(np.prod(grid)), dim)
    np.testing.assert_array_equal(got, get_3d_sincos_pos_embed(dim, grid))


# ---- the class vectors alone

LCV_VARIANTS = {
    "default": dict(vector_dim=6),
    "final_layer": dict(vector_dim=6, final_layer=True),
    "sincos_emb": dict(vector_dim=6, sincos_emb=True, final_layer=True),
    "sincos_flat": dict(vector_dim=6, sincos_emb=True),
    "linear_comb": dict(vector_dim=6, linear_comb=True, final_layer=True),
    "concat_vector": dict(vector_dim=6, concat_vector=True),
    "concat_final": dict(vector_dim=13, concat_vector=True, final_layer=True),
    "patch_voxel_mean": dict(vector_dim=12, patch_voxel_mean=True),
    "mean_final": dict(vector_dim=13, patch_voxel_mean=True,
                       final_layer=True),
    "percentiles": dict(vector_dim=6, final_layer=True, fixed=False),
}


@pytest.mark.parametrize("variant", sorted(LCV_VARIANTS))
def test_class_vectors_match_jax(variant):
    from medicalsemseg_tpu.config import Config as JaxConfig
    from medicalsemseg_tpu.models.embeddings import (
        LearnedClassVectors as JaxLCV)
    from medicalsemseg_tpu.models.factory import _lcv_transform as jax_lcv

    from medicalsemseg_tpu_torch.config import Config

    kw = dict(LCV_VARIANTS[variant])
    fixed = kw.pop("fixed", True)
    tkw = dict(t_fixed_ct_intensity=fixed, t_ct_min=-1000, t_ct_max=1000)
    patch, out_dim = (2, 2, 1), 12
    jmod = JaxLCV(patch_size=patch, out_dim=out_dim,
                  intensity_transform=jax_lcv(JaxConfig(**tkw)), **kw)
    rng = np.random.default_rng(7)
    vol = rng.uniform(-0.1, 1.1, size=(2, 8, 6, 4, 1)).astype(np.float32)
    edges = np.unique(_lcv_transform(Config(**tkw))(
        temb.HU_INTENSITY_INTERVALS_LC if kw.get("linear_comb")
        else temb.HU_INTENSITY_INTERVALS)).astype(np.float32)
    vol.reshape(-1)[:len(edges)] = edges       # on the edges themselves
    shapes = jax.eval_shape(jmod.init, jax.random.PRNGKey(0),
                            jnp.asarray(vol))
    variables = seeded_tree(shapes, 8)
    want = np.asarray(jax.jit(jmod.apply)(variables, jnp.asarray(vol)))

    mod = temb.LearnedClassVectors(patch, out_dim, kw.pop("vector_dim"),
                                   _lcv_transform(Config(**tkw)), **kw)
    params = variables.get("params", {})
    sd = {}
    if "vectors" in params:
        sd["vectors"] = torch.from_numpy(np.asarray(params["vectors"]))
    if "fc" in params:
        sd["fc.weight"] = torch.from_numpy(np.asarray(params["fc"]["kernel"]).T)
        sd["fc.bias"] = torch.from_numpy(np.asarray(params["fc"]["bias"]))
    mod.load_state_dict(sd, strict=True)
    with torch.inference_mode():
        got = mod(torch.from_numpy(vol)).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


# ---- the models with the options

@pytest.mark.parametrize("option", [
    dict(learned_cls_vectors=True, lcv_patch_voxel_mean=True,
         lcv_vector_dim=12),
    dict(learned_cls_vectors=True, lcv_concat_vector=True),
    dict(learned_cls_vectors=True, lcv_only=True, lcv_final_layer=True),
    dict(rel_crop_pos_emb=True),
    dict(rel_pos_bias_affine=True),
    dict(abs_pos_emb=True),
    dict(global_token=True),
    dict(patch_size=(2, 2, 1)),
], ids=["lcv_mean", "lcv_concat", "lcv_only", "rel_crop_pos_emb",
        "rel_pos_bias_affine", "abs_pos_emb", "global_token", "patch_221"])
def test_each_option_alone_matches_jax(option):
    got, want = logits_both(small_cfg(**{**CFG, **option}), seed=41)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
