"""The port's train step against the JAX package's, on the CPU in fp32: the
two forms outside the plain step of ``test_torch_train_step.py`` (kept in a
file of their own so that the test workers share the two halves).

The same small flagship and seeded numpy weights and batches on both sides:
``drop_path_rate`` 0.5 with the same keep masks injected in call order (the
shortcut-outside form of the kernels), and the batch-4 micro-step with
``--fused_loss`` and ``MEDSEG_DW27_PALLAS=1`` (K5's and K8's plain versions).
"""

import numpy as np

import jax
import jax.numpy as jnp
import torch

import medicalsemseg_tpu.models.layers as jax_layers
from medicalsemseg_tpu.train.losses import build_loss as jax_build_loss
from medicalsemseg_tpu.train.state import (TrainState, make_optimizer,
                                           make_train_step)

import medicalsemseg_tpu_torch.models.layers as port_layers
from medicalsemseg_tpu_torch.train import state as pstate
from medicalsemseg_tpu_torch.utils.params import jax_tree_from_state_dict

from tests.test_torch_model import jax_params, port_model
from tests.test_torch_train_step import (STEPS_PER_EPOCH, _assert_params,
                                         _batches, _cfg, _flat, _port_params,
                                         _port_state, _rel, _tb)


def test_shortcut_outside_form_matches_with_injected_masks(monkeypatch):
    """drop_path_rate > 0 in training: both sides take the shortcut outside
    the kernels, with the same keep masks injected in call order."""
    cfg = _cfg(drop_path_rate=0.5)
    jmodel, params = jax_params(cfg, seed=9)
    batch = _batches(cfg, 1, seed=9)[0]
    rng = np.random.default_rng(0)
    masks = [rng.uniform(size=2) < 0.6 for _ in range(16)]

    def feeder():
        it = iter(masks)

        def jax_drop(x, rate, deterministic, rng_key):
            if deterministic or rate == 0.0:
                return x
            m = jnp.asarray(next(it)).reshape((-1,) + (1,) * (x.ndim - 1))
            return jnp.where(m, x / (1.0 - rate), jnp.zeros_like(x))

        def port_drop(x, rate, training, generator=None, keep_mask=None):
            if not training or rate == 0.0:
                return x
            m = torch.from_numpy(next(it)).reshape((-1,) + (1,) * (x.dim() - 1))
            return torch.where(m, x / (1.0 - rate), torch.zeros_like(x))

        return jax_drop, port_drop

    monkeypatch.setattr(jax_layers, "drop_path", feeder()[0])
    loss_fn = jax_build_loss(cfg)

    def loss(p):
        logits = jmodel.apply(
            {"params": p}, tuple(jnp.asarray(batch[k]) for k in
                                 ("image", "crop_loc", "affine")),
            deterministic=False, rngs={"dropout": jax.random.PRNGKey(0)})
        return loss_fn(logits, jnp.asarray(batch["label"]))

    want_loss, want = jax.jit(jax.value_and_grad(loss))(params)

    monkeypatch.setattr(port_layers, "drop_path", feeder()[1])
    model = port_model(cfg, params).train()
    assert model.encoder.layers[3].blocks[0].drop_path.rate == 0.5
    b = _tb(batch)
    from medicalsemseg_tpu_torch.train.losses import build_loss
    got_loss = build_loss(cfg)(model((b["image"], b["crop_loc"], b["affine"])),
                               b["label"])
    got_loss.backward()
    np.testing.assert_allclose(float(got_loss.detach()), float(want_loss),
                               rtol=1e-4)
    got = _flat(jax_tree_from_state_dict(
        {n: p.grad for n, p in model.named_parameters()}, params))
    want = _flat(want)
    # the masks drop half the samples in the deep blocks and leave gradients
    # of ~1e-4 on 12-element leaves, where fp32 summation noise weighs more
    # than in test_every_gradient_matches; the whole vector is held tightly
    for k in sorted(want):
        assert _rel(got[k], want[k]) < 5e-2, f"{k}: {_rel(got[k], want[k]):.2e}"
    cat = lambda d: np.concatenate([d[k].ravel() for k in sorted(d)])  # noqa: E731
    assert _rel(cat(got), cat(want)) < 5e-3


def test_micro_batch_of_four_with_fused_loss_and_k5_matches_jax(monkeypatch):
    """The batch-4 training slice at a small size: ``--fused_loss`` and
    ``MEDSEG_DW27_PALLAS=1`` on both sides. The JAX step runs its Pallas dW
    kernel in interpret mode (its fused loss needs an accelerator backend and
    falls to the unfused one here); the port runs K5's and K8's plain
    versions through ``Conv3x3x3Fn`` and ``DiceCEFusedFn``."""
    import medicalsemseg_tpu.ops.pallas.dw27 as jax_dw27
    from medicalsemseg_tpu_torch.ops.kernels import dice_ce as k8
    from medicalsemseg_tpu_torch.ops.kernels import dw27 as k5

    monkeypatch.setenv("MEDSEG_DW27_PALLAS", "1")
    monkeypatch.setattr(jax_dw27, "_FORCE_INTERPRET", True)
    cfg = _cfg(fused_loss=True)
    jmodel, params = jax_params(cfg, seed=11)
    batch = _batches(cfg, 1, batch=4, seed=11)[0]
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    tx, sched = make_optimizer(cfg, STEPS_PER_EPOCH)
    jstate = TrainState(step=jnp.zeros((), jnp.int32), params=params,
                        batch_stats={}, opt_state=tx.init(params),
                        apply_fn=jmodel.apply, tx=tx)
    jstate, m = jax.jit(make_train_step(cfg))(jstate, jb, jax.random.PRNGKey(0))
    loss_fn = jax_build_loss(cfg)

    def loss(p):
        logits = jmodel.apply({"params": p},
                              (jb["image"], jb["crop_loc"], jb["affine"]),
                              deterministic=False,
                              rngs={"dropout": jax.random.PRNGKey(0)})
        return loss_fn(logits, jb["label"])

    want_g = _flat(jax.jit(jax.grad(loss))(params))

    k5_calls, k8_calls = [], []
    real_dw27, real_sums = k5.dw27, k8.dice_ce_sums
    monkeypatch.setattr(k5, "dw27", lambda x, dy: k5_calls.append(
        tuple(x.shape)) or real_dw27(x, dy))
    monkeypatch.setattr(k8, "dice_ce_sums", lambda lg, lb: k8_calls.append(
        tuple(lg.shape)) or real_sums(lg, lb))
    model = port_model(cfg, params).train()
    b = _tb(batch)
    from medicalsemseg_tpu_torch.train.losses import build_loss
    got_loss = build_loss(cfg)(model((b["image"], b["crop_loc"], b["affine"])),
                               b["label"])
    got_loss.backward()
    # every 3^3 conv with 16 or more input channels took K5's route, and the
    # loss K8's: (4, 32^3, 3) logits
    assert len(k5_calls) >= 6 and all(s[-1] >= 16 for s in k5_calls)
    assert k8_calls == [(4, 32 ** 3, 3)]
    np.testing.assert_allclose(float(got_loss.detach()), float(m["loss"]),
                               rtol=1e-4)
    got_g = _flat(jax_tree_from_state_dict(
        {n: p.grad for n, p in model.named_parameters()}, params))
    assert set(got_g) == set(want_g)
    for k in sorted(want_g):
        assert _rel(got_g[k], want_g[k]) < 2e-2, \
            f"{k}: {_rel(got_g[k], want_g[k]):.2e}"
    cat = lambda d: np.concatenate([d[k].ravel() for k in sorted(d)])  # noqa: E731
    assert _rel(cat(got_g), cat(want_g)) < 5e-3

    state = _port_state(cfg, params)
    got = pstate.make_train_step(cfg)(state, b)
    np.testing.assert_allclose(float(got["loss"]), float(m["loss"]), rtol=1e-4)
    np.testing.assert_allclose(float(got["grad_norm"]), float(m["grad_norm"]),
                               rtol=5e-3)
    _assert_params(_port_params(state, params), _flat(jstate.params),
                   float(sched(0)), "batch-4 step")
    assert len(k8_calls) == 2
