"""Training of FocalNetUNETR, UNETR_Official's ViT, LRGFormer and Swin2D in
the port against ``jax.grad`` of the same losses on the CPU.

Small models in fp32, DropPath at rate 0.5 with the same keep masks
injected on both sides in call order, and one jitted JAX function for the
four losses and their gradients:

* FocalNetUNETR whole (vol 32, hidden 12, three stages of depths 2-1-1, the
  default even focal kernels of window 6) on the DiceCE loss;
* the ViT of UNETR (width 32, 4 blocks of 4 heads, patch 16 at vol 32) and
  the LRGFormer encoder (vol 32, depths 2-2-2), each on the mean square of
  every output of its pyramid: their decoders are the UNETR decoder
  modules whose training the flagship's tests already hold;
* Swin2D whole (32^2 images, patch 2, window 4, depths 2-2) on the mean
  softmax cross-entropy (the JAX package's own Swin2D gradient test).

Held: the losses within 1e-4, every gradient leaf within 5e-2 of its norm
(masks that drop half the samples leave small deep-block leaves where fp32
summation noise weighs more, as in ``test_torch_train_step_forms.py``) and
each model's whole gradient within 5e-3. In training the port's FocalNet
and ViT blocks run their MLPs plain (no kernel), as the JAX blocks run XLA;
in eval mode each block's MLP launches K2 once.
"""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import jax
import jax.numpy as jnp

import medicalsemseg_tpu.models.layers as jax_layers
from medicalsemseg_tpu.models import build_model as jax_build_model
from medicalsemseg_tpu.models import vit as jvit
from medicalsemseg_tpu.train.losses import build_loss as jax_build_loss

import medicalsemseg_tpu_torch.models.layers as port_layers
from medicalsemseg_tpu_torch.models import vit as pvit
from medicalsemseg_tpu_torch.models.factory import build_model
from medicalsemseg_tpu_torch.ops.kernels import mlp as kmlp
from medicalsemseg_tpu_torch.train.losses import build_loss
from medicalsemseg_tpu_torch.utils.params import (
    jax_tree_from_state_dict,
    state_dict_from_jax,
)

from tests.test_torch_model import flat_tree, seeded_tree, small_cfg

torch.backends.cudnn.allow_tf32 = False
torch.backends.cuda.matmul.allow_tf32 = False

RATE = 0.5
ORDER = ("FocalNetUNETR", "ViT", "LRGFormer", "Swin2D")
VIT_KW = dict(patch_size=(16, 16, 16), hidden_size=32, depth=4,
              num_heads=4, drop_path_rate=RATE)


def _cfgs():
    return {
        "FocalNetUNETR": small_cfg(model="FocalNetUNETR", window_size=6,
                                   depths=(2, 1, 1), num_heads=(2, 2, 2),
                                   drop_path_rate=RATE),
        "LRGFormer": small_cfg(model="LRGFormerUNETR", depths=(2, 2, 2),
                               num_heads=(2, 2, 2), drop_path_rate=RATE),
        "Swin2D": small_cfg(model="Swin2D", input_dim=2, window_size=4,
                            depths=(2, 2), num_heads=(2, 2),
                            drop_path_rate=RATE),
    }


def _feeder(framework, used):
    """drop_path with the same keep masks in call order on both sides; each
    live call appends its mask to ``used``."""
    rng = np.random.default_rng(0)
    it = iter([rng.uniform(size=2) < 0.6 for _ in range(64)])

    def jax_drop(x, rate, deterministic, rng_key):
        if deterministic or rate == 0.0:
            return x
        used.append(next(it))
        m = jnp.asarray(used[-1]).reshape((-1,) + (1,) * (x.ndim - 1))
        return jnp.where(m, x / (1.0 - rate), jnp.zeros_like(x))

    def port_drop(x, rate, training, generator=None, keep_mask=None):
        if not training or rate == 0.0:
            return x
        used.append(next(it))
        m = torch.from_numpy(used[-1]).reshape((-1,) + (1,) * (x.dim() - 1))
        return torch.where(m, x / (1.0 - rate), torch.zeros_like(x))

    return jax_drop if framework == "jax" else port_drop


def _inputs(dims, seed):
    rng = np.random.default_rng(seed)
    img = rng.normal(size=(2, *dims, 1)).astype(np.float32)
    label = rng.integers(0, 3, size=(2, *dims)).astype(np.int32)
    k = len(dims)
    return (img, np.zeros((2, k), np.float32), np.ones((2, k), np.float32),
            label)


def _rel(a, b):
    return float(np.linalg.norm((a - b).ravel())
                 / max(np.linalg.norm(b.ravel()), 1e-30))


def _pyramid_loss(outs):
    return sum((o * o).mean() for o in outs)


@pytest.fixture(scope="module")
def both():
    """{name: ((jax loss, jax grads), (port loss, port grads))}, the
    gradients as trees in the JAX layout, and under "masks" the keep masks
    each side drew ({"jax": [...], "port": [...]})."""
    cfgs = _cfgs()
    jms, params, data = {}, {}, {}
    for seed, name in enumerate(ORDER, start=70):
        if name == "ViT":
            jms[name] = jvit.ViT3D(**VIT_KW)
        else:
            full = jax_build_model(cfgs[name])
            jms[name] = full.encoder if name == "LRGFormer" else full
        data[name] = _inputs((32, 32) if name == "Swin2D" else (32,) * 3,
                             seed)
        x = tuple(jnp.asarray(a) for a in data[name][:3])
        shapes = jax.eval_shape(
            lambda r, x, m=jms[name]: m.init(r, x, deterministic=True),
            jax.random.PRNGKey(0), x)
        params[name] = seeded_tree(shapes, seed)["params"]
    dice_ce = jax_build_loss(cfgs["FocalNetUNETR"])

    def jax_loss(name, p):
        img, crop, aff, label = (jnp.asarray(a) for a in data[name])
        out = jms[name].apply({"params": p}, (img, crop, aff),
                              deterministic=False,
                              rngs={"dropout": jax.random.PRNGKey(0)})
        if name == "Swin2D":
            logp = jax.nn.log_softmax(out, axis=-1)
            return -jnp.take_along_axis(logp, label[..., None], -1).mean()
        if name == "FocalNetUNETR":
            return dice_ce(out, label)
        return _pyramid_loss(out)

    masks = {"jax": [], "port": []}
    mp = pytest.MonkeyPatch()
    mp.setattr(jax_layers, "drop_path", _feeder("jax", masks["jax"]))
    want = jax.jit(lambda ps: {n: jax.value_and_grad(
        lambda p, n=n: jax_loss(n, p))(ps[n]) for n in ORDER})(params)
    mp.setattr(port_layers, "drop_path", _feeder("port", masks["port"]))
    port_dice_ce = build_loss(cfgs["FocalNetUNETR"])
    got = {}
    for name in ORDER:
        # the ViT and the LRGFormer encoder sit under their model's scope
        scope = {"ViT": "vit", "LRGFormer": "encoder"}.get(name)
        if name == "ViT":
            net = pvit.ViT3D((32, 32, 32), **VIT_KW)
        elif name == "LRGFormer":
            net = build_model(cfgs[name]).encoder
        else:
            net = build_model(cfgs[name])
        tree = {scope: params[name]} if scope else params[name]
        prefix = f"{scope}." if scope else ""
        net.load_state_dict({k[len(prefix):]: v for k, v in
                             state_dict_from_jax(tree).items()}, strict=True)
        img, crop, aff, label = (torch.from_numpy(a) for a in data[name])
        out = net.train()(img if scope else (img, crop, aff))
        if name == "Swin2D":
            loss = F.cross_entropy(out.permute(0, 3, 1, 2), label.long())
        elif name == "FocalNetUNETR":
            loss = port_dice_ce(out, label)
        else:
            loss = _pyramid_loss(out)
        loss.backward()
        grads = jax_tree_from_state_dict(
            {prefix + n: torch.zeros_like(p) if p.grad is None else p.grad
             for n, p in net.named_parameters()}, tree)
        got[name] = (float(loss.detach()), grads[scope] if scope else grads)
    mp.undo()
    return {**{n: (want[n], got[n]) for n in ORDER}, "masks": masks}


@pytest.mark.parametrize("name", ORDER)
def test_loss_and_every_gradient_match_jax(both, name):
    (jl, jg), (pl, pg) = both[name]
    np.testing.assert_allclose(pl, float(jl), rtol=1e-4)
    want, got = flat_tree(jg), flat_tree(pg)
    assert set(got) == set(want)
    cat = lambda d: np.concatenate([d[k].ravel() for k in sorted(d)])  # noqa: E731
    floor = 1e-6 * np.linalg.norm(cat(want))
    for k in sorted(want):
        if np.linalg.norm(want[k]) < floor:
            assert np.linalg.norm(got[k]) < floor, k
        else:
            assert _rel(got[k], want[k]) < 5e-2, k
    assert _rel(cat(got), cat(want)) < 5e-3


def test_drop_path_draws_the_same_masks_in_the_same_places(both):
    """Every live DropPath of the four models (the blocks past the first
    of each, both residuals) drew a mask on both sides in the same order,
    and some of them dropped a sample."""
    jm, pm = both["masks"]["jax"], both["masks"]["port"]
    # FocalNet 3 blocks, ViT 3, LRGFormer 5, Swin2D 3 past the first, two
    # residuals each
    assert len(jm) == len(pm) == 2 * (3 + 3 + 5 + 3)
    assert not all(m.all() for m in pm)


@pytest.mark.parametrize("name,blocks", [("FocalNetUNETR", 4),
                                         ("UNETR_Official", 12)])
def test_mlps_take_k2_at_inference_only(monkeypatch, name, blocks):
    """A training forward and backward calls no kernel wrapper; a forward in
    eval mode without gradients calls K2 once per block."""
    calls = {"k2": 0, "k4": 0}

    def spy(fn_name, key):
        fn = getattr(kmlp, fn_name)

        def wrapped(*a, **k):
            calls[key] += 1
            return fn(*a, **k)
        monkeypatch.setattr(kmlp, fn_name, wrapped)

    spy("fused_mlp", "k2")
    spy("fused_mlp_bwd", "k4")
    cfg = small_cfg(model=name, hidden_dim=8, depths=(1, 1, 1, 1))
    model = build_model(cfg)
    gen = torch.Generator().manual_seed(0)
    with torch.no_grad():
        for p in model.parameters():
            p.normal_(0.0, 0.05, generator=gen)
    x_in = (torch.randn(1, 32, 32, 32, 1), None, None)
    model.train()(x_in).sum().backward()
    assert calls == {"k2": 0, "k4": 0}
    with torch.inference_mode():
        model.eval()(x_in)
    assert calls == {"k2": blocks, "k4": 0}
