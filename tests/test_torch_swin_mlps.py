"""SwInception's and SwinDepth's token MLPs, and the two models, against the
JAX package on the CPU.

The MLPs alone (``InceptionMlp``, ``DepthwiseConvMlp``; C = 16 on a 4^3
token grid, batch 2) in eval mode and in training: output, every parameter
gradient and the input gradient of a seeded cotangent, and the BatchNorm
running statistics after the training call, each side from the same
seeded variables (one jitted JAX function a module). Then the two models
end to end at inference (vol 32, C = 12, depths 2-2-1-1, heads 2-2-2-2,
window 2, 3 classes), and which kernels a SwInception training step
launches. fp32 on both sides, ``RTOL = ATOL = 1e-4``
(``tests/test_torch_model.py``). The training steps against one jitted JAX
step each are in ``test_torch_train_swinception.py`` and
``test_torch_train_swindepth.py``.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from medicalsemseg_tpu_torch.models.factory import build_model
from medicalsemseg_tpu_torch.models.layers import (
    BatchNorm,
    DepthwiseConvMlp,
    InceptionMlp,
)
from medicalsemseg_tpu_torch.ops.kernels import mlp as kmlp
from medicalsemseg_tpu_torch.ops.kernels import window_attention as kwa
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

C, GRID, BATCH = 16, (4, 4, 4), 2


def _mlp_keys(kind, params):
    """(JAX path, port key, layout) of every leaf of a lone MLP's
    parameters: the port's names against flax's auto-names."""
    keys = []
    if kind == "inception":
        for k in range(11):
            bc = f"BasicConv3d_{k}"
            keys += [((bc, "Conv3d_0", "Conv_0", "kernel"),
                      f"convs.{k}.conv.weight", "conv"),
                     ((bc, "Conv3d_0", "Conv_0", "bias"),
                      f"convs.{k}.conv.bias", "plain"),
                     ((bc, "BatchNorm_0", "BatchNorm_0", "scale"),
                      f"convs.{k}.bn.weight", "plain"),
                     ((bc, "BatchNorm_0", "BatchNorm_0", "bias"),
                      f"convs.{k}.bn.bias", "plain")]
        keys += [(("Dense_0", "kernel"), "fc.weight", "dense"),
                 (("Dense_0", "bias"), "fc.bias", "plain")]
    else:
        for k in range(3):
            keys += [((f"Conv3d_{k}", "Conv_0", "kernel"),
                      f"convs.{k}.weight", "conv"),
                     ((f"Conv3d_{k}", "Conv_0", "bias"), f"convs.{k}.bias",
                      "plain"),
                     ((f"BatchNorm_{k}", "BatchNorm_0", "scale"),
                      f"bns.{k}.weight", "plain"),
                     ((f"BatchNorm_{k}", "BatchNorm_0", "bias"),
                      f"bns.{k}.bias", "plain")]
        for d, fc in (("Dense_0", "fc1"), ("Dense_1", "fc2")):
            keys += [((d, "kernel"), f"{fc}.weight", "dense"),
                     ((d, "bias"), f"{fc}.bias", "plain")]
    return keys


def _stat_keys(kind):
    """(JAX batch_stats path, port buffer prefix) of every BatchNorm."""
    if kind == "inception":
        return [((f"BasicConv3d_{k}", "BatchNorm_0", "BatchNorm_0"),
                 f"convs.{k}.bn") for k in range(11)]
    return [((f"BatchNorm_{k}", "BatchNorm_0"), f"bns.{k}") for k in range(3)]


def _get(tree, path):
    for k in path:
        tree = tree[k]
    return np.asarray(tree)


def _to_port(kind, a):
    from medicalsemseg_tpu_torch.utils.params import _TO_PORT

    return np.ascontiguousarray(_TO_PORT[kind](a))


@pytest.fixture(scope="module", params=["inception", "dwconv"])
def mlp_both(request):
    """Both sides of one MLP kind: eval output, then the training call's
    output, gradients (parameters and input) and statistics."""
    from medicalsemseg_tpu.models.layers import (
        DepthwiseConvMlp as JaxDepthwise,
        InceptionMlp as JaxInception,
    )

    kind = request.param
    jmod = (JaxInception if kind == "inception" else JaxDepthwise)(
        hidden_dim=4 * C)
    rng = np.random.default_rng(3)
    n = int(np.prod(GRID))
    x = rng.normal(size=(BATCH, n, C)).astype(np.float32)
    cot = rng.normal(size=(BATCH, n, C)).astype(np.float32)
    shapes = jax.eval_shape(lambda r, xx: jmod.init(
        r, xx, deterministic=True, grid=GRID), jax.random.PRNGKey(0),
        jnp.asarray(x))
    variables = seeded_tree(shapes, 4)

    def run(v, xx, cc):
        y_eval = jmod.apply(v, xx, deterministic=True, grid=GRID)

        def loss(params, xx):
            y, mut = jmod.apply({"params": params,
                                 "batch_stats": v["batch_stats"]}, xx,
                                deterministic=False, grid=GRID,
                                mutable=["batch_stats"])
            return (y * cc).sum(), (y, mut["batch_stats"])

        (_, (y, stats)), grads = jax.value_and_grad(
            loss, argnums=(0, 1), has_aux=True)(v["params"], xx)
        return y_eval, y, stats, grads

    jax_out = jax.tree_util.tree_map(np.asarray, jax.jit(run)(
        variables, jnp.asarray(x), jnp.asarray(cot)))

    mod = (InceptionMlp if kind == "inception" else DepthwiseConvMlp)(
        C, 4 * C)
    sd = {key: torch.from_numpy(_to_port(lay, _get(variables["params"], p)))
          for p, key, lay in _mlp_keys(kind, variables["params"])}
    for p, prefix in _stat_keys(kind):
        sd[f"{prefix}.running_mean"] = torch.from_numpy(
            _get(variables["batch_stats"], p + ("mean",)))
        sd[f"{prefix}.running_var"] = torch.from_numpy(
            _get(variables["batch_stats"], p + ("var",)))
    mod.load_state_dict(sd, strict=True)
    with torch.inference_mode():
        y_eval = mod.eval()(torch.from_numpy(x), GRID)
    xt = torch.from_numpy(x).requires_grad_()
    y = mod.train()(xt, GRID)
    names = [key for _, key, _ in _mlp_keys(kind, variables["params"])]
    params = dict(mod.named_parameters())
    grads = torch.autograd.grad(y, [params[k] for k in names] + [xt],
                                torch.from_numpy(cot))
    port = dict(y_eval=y_eval.numpy(), y=y.detach().numpy(),
                grads=dict(zip(names, [g.numpy() for g in grads[:-1]])),
                dx=grads[-1].numpy(),
                stats={k: v.numpy() for k, v in mod.state_dict().items()
                       if "running" in k})
    return kind, variables, jax_out, port


def test_mlp_eval_and_training_outputs_match_jax(mlp_both):
    _, _, (y_eval, y, _, _), port = mlp_both
    np.testing.assert_allclose(port["y_eval"], y_eval, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(port["y"], y, rtol=RTOL, atol=ATOL)


def test_mlp_gradients_match_jax(mlp_both):
    kind, variables, (_, _, _, (gp, gx)), port = mlp_both
    np.testing.assert_allclose(port["dx"], gx, rtol=RTOL, atol=ATOL)
    for path, key, lay in _mlp_keys(kind, variables["params"]):
        np.testing.assert_allclose(port["grads"][key],
                                   _to_port(lay, _get(gp, path)),
                                   rtol=RTOL, atol=ATOL, err_msg=key)


def test_mlp_batch_statistics_match_jax(mlp_both):
    """Training moves the running statistics (flax momentum 0.9, biased
    variance, eps 1e-3 in the normalisation) as flax's BatchNorm does."""
    kind, variables, (_, _, stats, _), port = mlp_both
    for path, prefix in _stat_keys(kind):
        for leaf, buf in (("mean", "running_mean"), ("var", "running_var")):
            want = _get(stats, path + (leaf,))
            assert not np.allclose(want, _get(variables["batch_stats"],
                                              path + (leaf,)))
            np.testing.assert_allclose(port["stats"][f"{prefix}.{buf}"],
                                       want, rtol=RTOL, atol=1e-6,
                                       err_msg=prefix)


def test_inception_widths_at_full_width():
    """At C = 48: branches of int(192 / 5) = 38, a bottleneck of 6, a
    concatenation 190 wide; BatchNorm eps 1e-3."""
    mod = InceptionMlp(48, 192)
    widths = [(bc.conv.weight.shape[1], bc.conv.weight.shape[0],
               bc.conv.weight.shape[-1]) for bc in mod.convs]
    assert widths == [(48, 38, 1), (48, 6, 1), (6, 38, 3), (48, 6, 1),
                      (6, 6, 3), (6, 38, 3), (48, 6, 1), (6, 6, 3), (6, 6, 3),
                      (6, 38, 3), (48, 38, 1)]
    assert tuple(mod.fc.weight.shape) == (48, 190)
    assert all(m.eps == 1e-3 for m in mod.modules()
               if isinstance(m, BatchNorm))


CFG = dict(depths=(2, 2, 1, 1), drop_path_rate=0.0, qkv_bias=True)
# a non-uniform spacing and per-sample crop positions (read by no layer of
# these two models, passed all the same)
AFFINE = np.array([[0.8, 0.8, 2.5], [1.5, 1.0, 0.7]], np.float32)


@pytest.mark.parametrize("model", ["SwInception", "SwinDepth"])
def test_model_logits_match_jax(model):
    """The UNETR model end to end at inference (BatchNorms on their running
    statistics), with a non-uniform crop position and spacing."""
    cfg = small_cfg(model=model, **CFG)
    jmodel, variables = jax_variables(cfg, seed=31)
    rng = np.random.default_rng(32)
    x_in = (rng.normal(size=(2, 32, 32, 32, 1)).astype(np.float32),
            rng.uniform(size=(2, 3)).astype(np.float32),
            AFFINE)
    want = jax.jit(lambda v, x: jmodel.apply(v, x, deterministic=True))(
        variables, tuple(jnp.asarray(a) for a in x_in))
    port = build_model(cfg)
    port.load_state_dict(state_dict_from_jax(variables), strict=True)
    with torch.inference_mode():
        got = port.eval()(tuple(torch.from_numpy(a) for a in x_in))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL,
                               atol=ATOL)


def test_swinception_blocks_run_k1_k3_not_k2(monkeypatch):
    """Every block's attention goes through K1 forward and K3 backward;
    the inception MLP runs no kernel (K2 / K4 serve the dense MLP only)."""
    from medicalsemseg_tpu_torch.models.factory import init_weights

    calls = {n: 0 for n in ("attn", "attn_bwd", "mlp", "mlp_bwd")}
    for mod, name, key in ((kwa, "window_attention", "attn"),
                           (kwa, "window_attention_bwd", "attn_bwd"),
                           (kmlp, "fused_mlp", "mlp"),
                           (kmlp, "fused_mlp_bwd", "mlp_bwd")):
        fn = getattr(mod, name)
        monkeypatch.setattr(mod, name, lambda *a, _f=fn, _k=key, **kw: (
            calls.__setitem__(_k, calls[_k] + 1) or _f(*a, **kw)))
    cfg = small_cfg(model="SwInception", **CFG)
    model = init_weights(build_model(cfg), torch.Generator().manual_seed(0))
    x_in = (torch.randn(1, 32, 32, 32, 1), torch.rand(1, 3), torch.ones(1, 3))
    model.train()(x_in).sum().backward()
    # under the default --remat conv each block's forward runs again in the
    # backward (models/layers.py checkpoint_block): K1 twice a block
    assert cfg.remat == "conv"
    assert calls == {"attn": 12, "attn_bwd": 6, "mlp": 0, "mlp_bwd": 0}
