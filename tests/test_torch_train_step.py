"""The port's train step against the JAX package's, on the CPU in fp32.

A small flagship (vol 32, hidden 12, depths 1-1-1-1, window 2, 3 classes)
gets the same seeded numpy weights and batches on both sides. The JAX side is
``make_train_step`` (jitted once) for the plain run, and ``make_optimizer``'s
optax chain driven by ``jax.value_and_grad`` for the clipped and the
accumulated runs. The port's kernels K1-K4 run as their plain versions
through the autograd functions. ``drop_path_rate`` is 0 (DropPath's draws
cannot match jax's); the shortcut-outside form with injected keep masks and
the batch-4 fused-loss micro-step are in ``test_torch_train_step_forms.py``.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import optax
import torch

from medicalsemseg_tpu.train.losses import build_loss as jax_build_loss
from medicalsemseg_tpu.train.state import (TrainState, make_optimizer,
                                           make_train_step)

from medicalsemseg_tpu_torch.train import state as pstate
from medicalsemseg_tpu_torch.utils.params import (jax_tree_from_state_dict,
                                                  state_dict_from_jax)

from tests.test_torch_model import jax_params, port_model, small_cfg

torch.backends.cudnn.allow_tf32 = False
torch.backends.cuda.matmul.allow_tf32 = False

STEPS_PER_EPOCH = 2


def _cfg(**kw):
    base = dict(depths=(1, 1, 1, 1), drop_path_rate=0.0, warmup_epochs=0,
                epochs=3, lr=1e-3, weight_decay=1e-2, remat="none")
    base.update(kw)
    return small_cfg(**base)


def _batches(cfg, n, batch=2, seed=0):
    rng = np.random.default_rng(seed)
    v = cfg.vol_size3()
    return [{"image": rng.normal(size=(batch, *v, 1)).astype(np.float32),
             "label": rng.integers(0, cfg.output_dim,
                                   size=(batch, *v)).astype(np.int32),
             "crop_loc": rng.uniform(size=(batch, 3)).astype(np.float32),
             "affine": np.ones((batch, 3), np.float32)} for _ in range(n)]


def _flat(tree):
    return {jax.tree_util.keystr(k): np.asarray(v) for k, v in
            jax.tree_util.tree_flatten_with_path(tree)[0]}


def _rel(a, b):
    return float(np.linalg.norm((a - b).ravel())
                 / (np.linalg.norm(b.ravel()) + 1e-12))


def _port_state(cfg, params):
    model = port_model(cfg, params)
    return pstate.create_train_state(cfg, model, STEPS_PER_EPOCH)


def _port_params(state, template):
    return _flat(jax_tree_from_state_dict(state.model.state_dict(), template))


def _tb(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _assert_params(got, want, lr, what, updates=1):
    # as tests/test_train_step_parity.py: an early Adam step is sign(g)-like,
    # so an element with tiny |g| may differ by ~lr per update; the mean over
    # a leaf (first update; leaves of 64 elements or more, since one such
    # element dominates a 12-element bias) and over all parameters must not
    for k in sorted(want):
        np.testing.assert_allclose(got[k], want[k],
                                   atol=max(2 * lr * updates, 1e-5), rtol=0,
                                   err_msg=f"{what} {k}")
        if updates == 1 and got[k].size >= 64:
            assert float(np.abs(got[k] - want[k]).mean()) < lr / 10, (what, k)
    diff = np.concatenate([np.abs(got[k] - want[k]).ravel() for k in want])
    assert float(diff.mean()) < lr / 10, what


@pytest.fixture(scope="module")
def jax_side():
    """Three jitted JAX train steps, and a jitted loss-and-gradient."""
    cfg = _cfg()
    jmodel, params = jax_params(cfg, seed=3)
    batches = _batches(cfg, 3)
    tx, sched = make_optimizer(cfg, STEPS_PER_EPOCH)
    state = TrainState(step=jnp.zeros((), jnp.int32), params=params,
                       batch_stats={}, opt_state=tx.init(params),
                       apply_fn=jmodel.apply, tx=tx)
    step = jax.jit(make_train_step(cfg))
    runs = []
    for i, b in enumerate(batches):
        state, m = step(state, {k: jnp.asarray(v) for k, v in b.items()},
                        jax.random.PRNGKey(i))
        runs.append(({k: np.asarray(v) for k, v in m.items()},
                     _flat(state.params), state.opt_state))
    loss_fn = jax_build_loss(cfg)

    def loss(p, b):
        logits = jmodel.apply({"params": p},
                              (b["image"], b["crop_loc"], b["affine"]),
                              deterministic=False,
                              rngs={"dropout": jax.random.PRNGKey(0)})
        return loss_fn(logits, b["label"])

    return dict(cfg=cfg, params=params, batches=batches, runs=runs,
                sched=sched, grad=jax.jit(jax.value_and_grad(loss)))


def test_one_and_three_steps_match(jax_side):
    """Loss, grad_norm, Dice sums and every updated parameter, step by step
    across an epoch boundary of the schedule."""
    cfg, params = jax_side["cfg"], jax_side["params"]
    state = _port_state(cfg, params)
    step = pstate.make_train_step(cfg)
    for i, (batch, (m, want_p, _)) in enumerate(
            zip(jax_side["batches"], jax_side["runs"])):
        got = step(state, _tb(batch))
        np.testing.assert_allclose(float(got["loss"]), float(m["loss"]),
                                   rtol=1e-4, err_msg=f"step {i}")
        np.testing.assert_allclose(float(got["grad_norm"]),
                                   float(m["grad_norm"]), rtol=5e-3,
                                   err_msg=f"step {i}")
        np.testing.assert_allclose(got["dice_count"].numpy(), m["dice_count"])
        np.testing.assert_allclose(got["dice_sum"].numpy(), m["dice_sum"],
                                   atol=2e-3, err_msg=f"step {i}")
        _assert_params(_port_params(state, params), want_p,
                       float(jax_side["sched"](i)), f"step {i}", updates=i + 1)
    assert state.step == state.updates == 3


def test_every_gradient_matches(jax_side):
    cfg, params = jax_side["cfg"], jax_side["params"]
    batch = jax_side["batches"][0]
    want_loss, want = jax_side["grad"](
        params, {k: jnp.asarray(v) for k, v in batch.items()})
    model = port_model(cfg, params).train()
    b = _tb(batch)
    logits = model((b["image"], b["crop_loc"], b["affine"]))
    from medicalsemseg_tpu_torch.train.losses import build_loss
    loss = build_loss(cfg)(logits, b["label"])
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(want_loss), rtol=1e-4)
    got = _flat(jax_tree_from_state_dict(
        {n: p.grad for n, p in model.named_parameters()}, params))
    want = _flat(want)
    assert set(got) == set(want)
    for k in sorted(want):
        assert _rel(got[k], want[k]) < 2e-2, f"{k}: {_rel(got[k], want[k]):.2e}"
    cat = lambda d: np.concatenate([d[k].ravel() for k in sorted(d)])  # noqa: E731
    assert _rel(cat(got), cat(want)) < 5e-3


@pytest.mark.parametrize("clip,accum", [(0.05, 1), (None, 2)])
def test_clipping_and_accumulation_match_optax(jax_side, clip, accum):
    """The port's step against make_optimizer's optax chain (clip by global
    norm with no epsilon, AdamW, MultiSteps) fed the JAX gradients."""
    cfg = jax_side["cfg"].replace(gradient_clipping=clip,
                                  grad_accum_steps=accum)
    params = jax_side["params"]
    batches = _batches(cfg, 2 * accum, seed=5)
    tx, sched = make_optimizer(cfg, STEPS_PER_EPOCH)
    opt_state, jp = tx.init(params), params
    update = jax.jit(tx.update)
    state = _port_state(cfg, params)
    step = pstate.make_train_step(cfg)
    for i, batch in enumerate(batches):
        _, g = jax_side["grad"](jp, {k: jnp.asarray(v) for k, v in batch.items()})
        updates, opt_state = update(g, opt_state, jp)
        jp = optax.apply_updates(jp, updates)
        got = step(state, _tb(batch))
        np.testing.assert_allclose(float(got["grad_norm"]),
                                   float(optax.global_norm(g)), rtol=5e-3)
        _assert_params(_port_params(state, params), _flat(jp),
                       float(sched(i // accum)), f"step {i}",
                       updates=i // accum + 1)
    assert state.step == 2 * accum and state.updates == 2


def test_resumed_optimizer_state_matches(jax_side):
    """optax's AdamW moments after one JAX step, loaded into the port's
    optimizer, make the port's second step equal the JAX second step."""
    from medicalsemseg_tpu_torch.utils.params import load_adamw_state_from_optax

    cfg = jax_side["cfg"]
    _, p1, opt_state = jax_side["runs"][0]
    _, p2, _ = jax_side["runs"][1]
    adam = [s for s in jax.tree_util.tree_leaves(
        opt_state, is_leaf=lambda s: hasattr(s, "mu")) if hasattr(s, "mu")][0]
    tree1 = jax_tree_from_state_dict(
        state_dict_from_jax(jax_side["params"]), jax_side["params"])
    for (k, v) in _flat(tree1).items():   # the key map round-trips
        np.testing.assert_array_equal(v, _flat(jax_side["params"])[k])

    params1 = jax.tree_util.tree_unflatten(
        jax.tree_util.tree_structure(jax_side["params"]),
        [p1[k] for k in _flat(jax_side["params"])])
    state = _port_state(cfg, params1)
    load_adamw_state_from_optax(
        state.optimizer, state.model,
        jax.tree_util.tree_map(np.asarray, adam.mu),
        jax.tree_util.tree_map(np.asarray, adam.nu), int(adam.count))
    state.step = state.updates = 1
    pstate.make_train_step(cfg)(state, _tb(jax_side["batches"][1]))
    _assert_params(_port_params(state, jax_side["params"]), p2,
                   float(jax_side["sched"](1)), "resumed step", updates=2)


def test_flat_optimizer_raises(jax_side):
    """``--flat_optimizer``, refused until the port took the flag: its
    three steps against the JAX package's three steps of the optax chain
    (which the JAX flat pass computes exactly, ``tests/test_flat_optim.py``)
    at the limits of ``test_one_and_three_steps_match``."""
    cfg = _cfg(flat_optimizer=True)
    params = jax_side["params"]
    state = _port_state(cfg, params)
    assert isinstance(state.optimizer, torch.optim.AdamW)
    step = pstate.make_train_step(cfg)
    for i, (batch, (m, want_p, _)) in enumerate(
            zip(jax_side["batches"], jax_side["runs"])):
        got = step(state, _tb(batch))
        np.testing.assert_allclose(float(got["loss"]), float(m["loss"]),
                                   rtol=1e-4, err_msg=f"step {i}")
        np.testing.assert_allclose(float(got["grad_norm"]),
                                   float(m["grad_norm"]), rtol=5e-3,
                                   err_msg=f"step {i}")
        _assert_params(_port_params(state, params), want_p,
                       float(jax_side["sched"](i)), f"step {i}", updates=i + 1)
    assert state.updates == 3
