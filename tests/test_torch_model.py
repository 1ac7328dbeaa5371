"""The port's full nnFormerUNETR against the JAX model on the CPU.

A small flagship (vol 32, patch 2, hidden 12, depths 2-2-2-2, heads
2-2-2-2, 3 classes) gets a JAX parameter tree filled from a seeded numpy
generator; the same tree is loaded into the port through
``utils.params.state_dict_from_jax``. Both run in fp32.
"""

import os

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from medicalsemseg_tpu.config import Config
from medicalsemseg_tpu.models import build_model as jax_build_model

from medicalsemseg_tpu_torch.models.factory import build_model
from medicalsemseg_tpu_torch.utils.params import state_dict_from_jax

torch.backends.cudnn.allow_tf32 = False
torch.backends.cuda.matmul.allow_tf32 = False

# Under pytest-xdist every worker process imports this module at collection.
# torch's CPU kernels start one intra-op thread per core in every worker, and
# the workers then thrash one another (a CLI test of ~15 s alone took 343 s
# with six workers on eight cores): share the cores out instead.
if os.environ.get("PYTEST_XDIST_WORKER_COUNT"):
    torch.set_num_threads(max(1, (os.cpu_count() or 1)
                              // int(os.environ["PYTEST_XDIST_WORKER_COUNT"])))

# fp32 on both sides through ~40 layers; sums run in other orders (XLA vs
# oneDNN convs and torch matmuls) and InstanceNorm rescales small absolute
# differences, so logits of O(1) agree to ~1e-5; 1e-4 leaves headroom
RTOL = ATOL = 1e-4


def small_cfg(**kw) -> Config:
    base = dict(model="nnFormerUNETR", vol_size=32, patch_size=2,
                hidden_dim=12, depths=(2, 2, 2, 2), num_heads=(2, 2, 2, 2),
                window_size=2, output_dim=3, compute_dtype="float32",
                qkv_bias=True)
    base.update(kw)
    return Config(**base)


def jax_variables(cfg: Config, seed: int = 0):
    """The JAX model for cfg and its variables {'params': ...[,
    'batch_stats': ...]} (structure from ``jax.eval_shape`` of the init, so
    nothing is compiled) filled from a seeded numpy generator: norm scales
    ~1, biases ~0.1, kernels with variance 1 / fan_in, bias tables ~0.5,
    running means ~0.3 and running variances in 0.5-1.5, so every layer and
    every statistic contributes."""
    model = jax_build_model(cfg)
    v = cfg.vol_size3()
    x_in = (jnp.zeros((1, *v, cfg.in_chans)), jnp.zeros((1, 3)),
            jnp.ones((1, 3)))
    shapes = jax.eval_shape(
        lambda r, x: model.init(r, x, deterministic=True),
        jax.random.PRNGKey(0), x_in)
    return model, seeded_tree(shapes, seed)


def seeded_tree(shapes, seed: int):
    """A JAX variables tree of the structure ``shapes`` (``jax.eval_shape``
    of an init) filled from a numpy generator seeded with ``seed``, as
    :func:`jax_variables` describes."""
    rng = np.random.default_rng(seed)

    def fill(path, leaf):
        name = str(path[-1].key)
        z = rng.normal(size=leaf.shape)
        if name == "var":
            z = rng.uniform(0.5, 1.5, size=leaf.shape)
        elif name == "mean":
            z = 0.3 * z
        elif name == "scale":
            z = 1.0 + 0.1 * z
        elif "bias" in name and name != "relative_position_bias_table":
            z = 0.1 * z
        elif name == "relative_position_bias_table":
            z = 0.5 * z
        else:
            z = z / np.sqrt(np.prod(leaf.shape[:-1]))
        return z.astype(np.float32)

    return jax.tree_util.tree_map_with_path(fill, dict(shapes))


def jax_params(cfg: Config, seed: int = 0):
    """The JAX model for cfg and its seeded parameter tree (see
    :func:`jax_variables`)."""
    model, variables = jax_variables(cfg, seed)
    return model, variables["params"]


def port_model(cfg: Config, params) -> torch.nn.Module:
    model = build_model(cfg)
    model.load_state_dict(state_dict_from_jax(params), strict=True)
    return model.eval()


def model_inputs(cfg: Config, batch: int = 1, seed: int = 1):
    rng = np.random.default_rng(seed)
    v = cfg.vol_size3()
    return (rng.normal(size=(batch, *v, cfg.in_chans)).astype(np.float32),
            rng.uniform(size=(batch, 3)).astype(np.float32),
            np.ones((batch, 3), np.float32))


@pytest.mark.parametrize("window", [2, 3])
def test_logits_match_jax(window):
    """window 2: every block absorbed, shifted blocks, stage-4 clamp;
    window 3: grids 16/8/4 pad to multiples of 3 (the padded form)."""
    cfg = small_cfg(window_size=window)
    jmodel, params = jax_params(cfg, seed=window)
    x_in = model_inputs(cfg, batch=1, seed=window)
    want = jax.jit(lambda p, x: jmodel.apply({"params": p}, x,
                                              deterministic=True))(
        params, tuple(jnp.asarray(a) for a in x_in))
    with torch.inference_mode():
        got = port_model(cfg, params)(tuple(torch.from_numpy(a) for a in x_in))
    assert got.shape == (1, 32, 32, 32, 3) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL,
                               atol=ATOL)


def test_encoder_matches_pallas_absorbed_forms(monkeypatch):
    """The JAX encoder with use_pallas=True in interpret mode takes the
    absorbed LN+residual attention kernel and the fused MLP in every block;
    the port's encoder agrees with it."""
    import medicalsemseg_tpu.ops.pallas.window_attention as pwa
    from medicalsemseg_tpu.models.swin import SwinEncoder3D as JaxEncoder

    from tests.test_pallas_attention import _patch_interpret

    _patch_interpret(monkeypatch, pwa)
    cfg = small_cfg()
    _, params = jax_params(cfg, seed=5)
    enc = JaxEncoder(patch_size=(2, 2, 2), embed_dim=12, depths=(2, 2, 2, 2),
                     num_heads=(2, 2, 2, 2), window_sizes=(2, 2, 2, 2),
                     qkv_bias=True, use_pallas=True)
    vol = model_inputs(cfg, seed=5)[0]
    want = jax.jit(lambda p, v: enc.apply({"params": p}, (v, None, None),
                                          deterministic=True))(
        params["encoder"], jnp.asarray(vol))
    with torch.inference_mode():
        got = port_model(cfg, params).encoder(torch.from_numpy(vol))
    assert len(got) == len(want) == 5
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=RTOL,
                                   atol=ATOL)


@pytest.mark.parametrize("what", ["--flat_optimizer"])
def test_unported_options_raise(what):
    """--flat_optimizer ("Do not port") raises and names the ROADMAP."""
    from medicalsemseg_tpu_torch.train.state import make_optimizer

    with pytest.raises(NotImplementedError, match="ROADMAP"):
        cfg = small_cfg(flat_optimizer=True)
        make_optimizer(cfg, build_model(cfg), 1)


def train_step_both(cfg: Config, seed: int = 0, batch: int = 2,
                    crop=None, affine=None):
    """One training forward and backward of the same seeded variables and
    batch on both sides, fp32, drop rates 0 (the SegFormer heads' dropout
    set to 0 on both sides: the two frameworks draw different masks).
    ``crop`` and ``affine`` (batch, 3) default to zeros and ones. A model
    that returns a list of heads (nnFormer under ``--deep_supervision``)
    takes each side's ``_deep_supervision_loss``.
    Returns {side: (loss, gradients, batch_stats)} for side "jax" (one
    jitted ``jax.value_and_grad`` of the apply with mutable batch_stats, as
    the JAX train step runs it) and "port" (``model.train()``, autograd), the
    gradients and statistics as numpy trees in the JAX layout."""
    from medicalsemseg_tpu.train.losses import build_loss as jax_build_loss
    from medicalsemseg_tpu.train.state import (
        _deep_supervision_loss as jax_ds_loss)

    from medicalsemseg_tpu_torch.models.layers import Dropout
    from medicalsemseg_tpu_torch.train.losses import build_loss
    from medicalsemseg_tpu_torch.train.state import _deep_supervision_loss
    from medicalsemseg_tpu_torch.utils.params import jax_tree_from_state_dict

    jmodel, variables = jax_variables(cfg, seed)
    if hasattr(jmodel, "dropout_ratio"):
        jmodel = jmodel.clone(dropout_ratio=0.0)
    rng = np.random.default_rng(seed + 100)
    v = cfg.vol_size3()
    img = rng.normal(size=(batch, *v, cfg.in_chans)).astype(np.float32)
    label = rng.integers(0, cfg.output_dim, size=(batch, *v)).astype(np.int32)
    crop = np.zeros((batch, 3), np.float32) if crop is None else crop
    aff = np.ones((batch, 3), np.float32) if affine is None else affine
    jloss = jax_build_loss(cfg)
    stats0 = variables.get("batch_stats", {})

    def loss(params, stats, x, y):
        var = {"params": params}
        if stats:
            var["batch_stats"] = stats
        logits, mutated = jmodel.apply(
            var, (x, jnp.asarray(crop), jnp.asarray(aff)),
            deterministic=False, rngs={"dropout": jax.random.PRNGKey(0)},
            mutable=["batch_stats"])
        lv = (jax_ds_loss(jloss, logits, y) if isinstance(logits, list)
              else jloss(logits, y))
        return lv, mutated.get("batch_stats", {})

    (jl, jstats), jgrads = jax.jit(jax.value_and_grad(loss, has_aux=True))(
        variables["params"], stats0, jnp.asarray(img), jnp.asarray(label))
    to_np = lambda t: jax.tree_util.tree_map(np.asarray, t)  # noqa: E731

    model = build_model(cfg)
    model.load_state_dict(state_dict_from_jax(variables), strict=True)
    model.train()
    for m in model.modules():
        if isinstance(m, Dropout):
            m.rate = 0.0
    logits = model((torch.from_numpy(img), torch.from_numpy(crop),
                    torch.from_numpy(aff)))
    ploss = build_loss(cfg)
    pl = (_deep_supervision_loss(ploss, logits, torch.from_numpy(label))
          if isinstance(logits, list) else ploss(logits, torch.from_numpy(label)))
    pl.backward()
    pgrads = jax_tree_from_state_dict(
        {n: torch.zeros_like(p) if p.grad is None else p.grad
         for n, p in model.named_parameters()}, variables["params"])
    pstats = (jax_tree_from_state_dict(model.state_dict(), variables)
              ["batch_stats"] if stats0 else {})
    return {"jax": (float(jl), to_np(jgrads), to_np(jstats)),
            "port": (float(pl.detach()), pgrads, pstats),
            "stats0": to_np(stats0)}


def flat_tree(tree):
    """{path string: numpy array} of a nested tree."""
    return {jax.tree_util.keystr(k): np.asarray(v) for k, v in
            jax.tree_util.tree_flatten_with_path(tree)[0]}


def assert_train_step_matches(both, leaf_floor: float = 1e-6):
    """Loss (rtol 1e-4) and every parameter's gradient (each leaf's error
    norm under 2e-2 of its norm, all of them together under 5e-3: the
    tolerances of ``test_torch_train_step.py``) against the JAX side, and
    the BatchNorm running statistics after the step against flax's. A leaf
    whose gradient is zero in exact arithmetic (a bias that reaches the loss
    only through a BatchNorm with batch statistics, which cancels any
    per-channel constant) is fp32 noise on both sides: its error norm is held
    under ``leaf_floor`` (1e-6) of the whole gradient's norm instead, as is
    any leaf smaller than that."""
    jl, jg, js = both["jax"]
    pl, pg, ps = both["port"]
    np.testing.assert_allclose(pl, jl, rtol=1e-4)
    want, got = flat_tree(jg), flat_tree(pg)
    assert set(got) == set(want)
    norm = lambda a: float(np.linalg.norm(a.ravel()))  # noqa: E731
    cat = lambda d: np.concatenate([d[k].ravel() for k in sorted(d)])  # noqa: E731
    floor = leaf_floor * norm(cat(want))
    for k in sorted(want):
        err, ref = norm(got[k] - want[k]), norm(want[k])
        if ref < floor:
            assert err < floor, f"{k}: {err:.2e} (zero gradient)"
        else:
            assert err < 2e-2 * ref, f"{k}: {err / ref:.2e}"
    assert norm(cat(got) - cat(want)) < 5e-3 * norm(cat(want))
    want_s, got_s = flat_tree(js), flat_tree(ps)
    assert set(got_s) == set(want_s)
    for k in sorted(want_s):
        np.testing.assert_allclose(got_s[k], want_s[k], rtol=1e-4, atol=1e-6,
                                   err_msg=k)
