"""The port's data-parallel train step on two gloo ranks (CPU, fp32)
against the JAX package.

The small flagship of ``tests/test_sharding.py`` (vol 16, hidden 12, depths
1-1, window 2, 3 classes) gets seeded numpy weights on both sides and a
global batch of 4 crops, 2 a rank. Its DDP step is held against the JAX
sharded step on a 2-device mesh, and with ``--grad_accum_steps 2`` against
the JAX gradients fed to ``make_optimizer``'s optax chain (MultiSteps). A
small SwInception (BatchNorm in its MLP) is held against the JAX forward
and backward of the global batch: its BatchNorms reduce their statistics
over the ranks. The ranks (``tests/test_torch_dist.py`` ``run_ranks``)
import the port only. Drop rates are 0 on both sides.
"""

import json

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import optax
import torch

from medicalsemseg_tpu.config import Config
from medicalsemseg_tpu.parallel.mesh import (batch_sharding, create_mesh,
                                             replicated)
from medicalsemseg_tpu.train.losses import build_loss as jax_build_loss
from medicalsemseg_tpu.train.state import (TrainState, make_optimizer,
                                           make_train_step)

from medicalsemseg_tpu_torch.utils.params import state_dict_from_jax

from tests.test_torch_dist import run_ranks
from tests.test_torch_model import (assert_train_step_matches, flat_tree,
                                    jax_params, jax_variables)
from tests.test_torch_train_step import _assert_params

STEPS_PER_EPOCH = 2
BASE = dict(vol_size=16, patch_size=2, hidden_dim=12, depths=(1, 1),
            num_heads=(2, 2), window_size=2, output_dim=3,
            compute_dtype="float32", warmup_epochs=0, lr=1e-3,
            drop_path_rate=0.0, weight_decay=1e-2, epochs=3)


def _batches(cfg, n, batch=4, seed=0):
    rng = np.random.default_rng(seed)
    v = cfg.vol_size3()
    return [{"image": rng.normal(size=(batch, *v, 1)).astype(np.float32),
             "label": rng.integers(0, cfg.output_dim,
                                   size=(batch, *v)).astype(np.int32),
             "crop_loc": rng.uniform(size=(batch, 3)).astype(np.float32),
             "affine": np.ones((batch, 3), np.float32)} for _ in range(n)]


_RANKS = """
    import json, os, numpy as np, torch
    from medicalsemseg_tpu_torch.config import Config
    from medicalsemseg_tpu_torch.models.factory import build_model
    from medicalsemseg_tpu_torch.parallel import dist as pdist
    from medicalsemseg_tpu_torch.parallel.mesh import create_mesh, shard_batch
    from medicalsemseg_tpu_torch.train.losses import build_loss
    from medicalsemseg_tpu_torch.train import state as pstate

    torch.set_num_threads(2)
    out_dir = os.environ["OUT"]
    pdist.init_distributed_mode(Config(), torch.device("cpu"))
    rank = pdist.get_rank()
    spec = json.load(open(os.path.join(out_dir, "spec.json")))

    def state_of(case):
        kw = dict(spec[case]["cfg"])
        kw["depths"], kw["num_heads"] = tuple(kw["depths"]), tuple(kw["num_heads"])
        cfg = Config(**kw)
        model = build_model(cfg)
        model.load_state_dict(torch.load(os.path.join(out_dir, case + ".pt")))
        mesh = create_mesh(4)
        st = pstate.create_train_state(cfg, model, spec["steps"])
        return cfg, pstate.distribute(st, mesh.group), mesh

    def shard(case, i):
        b = np.load(os.path.join(out_dir, f"{case}_batch{i}.npz"))
        return shard_batch({k: torch.from_numpy(b[k]) for k in b.files},
                           rank, 2)

    res = {}
    for case in ("step", "accum"):
        cfg, st, mesh = state_of(case)
        step = pstate.make_train_step(cfg)
        ms = [step(st, shard(case, i)) for i in range(spec[case]["n"])]
        res[case] = {"loss": [float(m["loss"]) for m in ms],
                     "grad_norm": [float(m["grad_norm"]) for m in ms],
                     "dice_count": [m["dice_count"].tolist() for m in ms],
                     "dice_sum": [m["dice_sum"].tolist() for m in ms],
                     "updates": st.updates}
        if rank == 0:
            torch.save(st.model.state_dict(),
                       os.path.join(out_dir, case + "_after.pt"))

    # an epoch that ends inside the accumulation: the pending micro-gradients
    # averaged over the ranks, then the second micro-step
    cfg, st, mesh = state_of("accum")
    step = pstate.make_train_step(cfg)
    step(st, shard("accum", 0))
    pstate.sync_pending_gradients(st)
    res["pending_norm"] = float(pstate.global_norm(st.accum))
    step(st, shard("accum", 1))
    if rank == 0:
        torch.save(st.model.state_dict(),
                   os.path.join(out_dir, "pending_after.pt"))

    # BatchNorm model: one forward and backward through the DDP wrapper
    cfg, st, mesh = state_of("bn")
    b = shard("bn", 0)
    st.model.train()
    loss = build_loss(cfg)(st.ddp((b["image"], b["crop_loc"], b["affine"])),
                           b["label"])
    loss.backward()
    res["bn"] = {"loss": float(loss)}
    torch.save({"grads": {n: p.grad for n, p in st.model.named_parameters()},
                "state": st.model.state_dict()},
               os.path.join(out_dir, f"bn_rank{rank}.pt"))
    json.dump(res, open(os.path.join(out_dir, f"res{rank}.json"), "w"))
    pdist.shutdown()
"""


def _spec_cfg(cfg):
    return {k: (list(v) if isinstance(v, tuple) else v)
            for k, v in BASE.items()} | {
        "model": cfg.model, "grad_accum_steps": cfg.grad_accum_steps,
        "remat": "none"}


@pytest.fixture(scope="module")
def both(tmp_path_factory):
    """The JAX references and the two ranks' results."""
    tmp = tmp_path_factory.mktemp("ddp")
    cfg = Config(model="nnFormerUNETR", **BASE)
    jmodel, params = jax_params(cfg, seed=3)
    sd = state_dict_from_jax(params)
    spec = {"steps": STEPS_PER_EPOCH}
    ref = {"params": params}

    # one step: the JAX sharded step on a 2-device mesh
    batch = _batches(cfg, 1)[0]
    tx, sched = make_optimizer(cfg, STEPS_PER_EPOCH)
    state = TrainState(step=jnp.zeros((), jnp.int32), params=params,
                       batch_stats={}, opt_state=tx.init(params),
                       apply_fn=jmodel.apply, tx=tx)
    mesh = create_mesh((2,), devices=jax.devices()[:2])
    repl = replicated(mesh)
    step = jax.jit(make_train_step(cfg), out_shardings=(repl, repl))
    s2, m = step(jax.device_put(state, repl),
                 {k: jax.device_put(v, batch_sharding(mesh))
                  for k, v in batch.items()},
                 jax.device_put(jax.random.PRNGKey(0), repl))
    ref["step"] = ({k: np.asarray(v) for k, v in m.items()},
                   flat_tree(s2.params), float(sched(0)))
    np.savez(tmp / "step_batch0.npz", **batch)
    torch.save(sd, tmp / "step.pt")
    spec["step"] = {"cfg": _spec_cfg(cfg), "n": 1}

    # two micro-steps: the JAX gradients of the global micro-batches
    cfg2 = cfg.replace(grad_accum_steps=2)
    loss_fn = jax_build_loss(cfg2)

    def loss(p, b):
        return loss_fn(jmodel.apply({"params": p}, (b["image"], b["crop_loc"],
                                                    b["affine"]),
                                    deterministic=True), b["label"])

    grad = jax.jit(jax.value_and_grad(loss))
    tx2, sched2 = make_optimizer(cfg2, STEPS_PER_EPOCH)
    opt, jp, losses = tx2.init(params), params, []
    for i, b in enumerate(_batches(cfg2, 2, seed=7)):
        lv, g = grad(jp, {k: jnp.asarray(v) for k, v in b.items()})
        upd, opt = tx2.update(g, opt, jp)
        jp = optax.apply_updates(jp, upd)
        losses.append(float(lv))
        np.savez(tmp / f"accum_batch{i}.npz", **b)
    ref["accum"] = (losses, flat_tree(jp), float(sched2(0)))
    torch.save(sd, tmp / "accum.pt")
    spec["accum"] = {"cfg": _spec_cfg(cfg2), "n": 2}

    # BatchNorm: SwInception's forward and backward of the global batch
    cfg3 = Config(model="SwInception", **BASE)
    jm3, variables = jax_variables(cfg3, seed=5)
    b = _batches(cfg3, 1, seed=11)[0]
    loss3 = jax_build_loss(cfg3)

    def bn_loss(p, stats, x):
        logits, mutated = jm3.apply(
            {"params": p, "batch_stats": stats},
            (x["image"], x["crop_loc"], x["affine"]), deterministic=False,
            rngs={"dropout": jax.random.PRNGKey(0)}, mutable=["batch_stats"])
        return loss3(logits, x["label"]), mutated["batch_stats"]

    (jl, jstats), jg = jax.jit(jax.value_and_grad(bn_loss, has_aux=True))(
        variables["params"], variables["batch_stats"],
        {k: jnp.asarray(v) for k, v in b.items()})
    ref["bn"] = (float(jl), jax.tree_util.tree_map(np.asarray, jg),
                 jax.tree_util.tree_map(np.asarray, jstats), variables)
    np.savez(tmp / "bn_batch0.npz", **b)
    torch.save(state_dict_from_jax(variables), tmp / "bn.pt")
    spec["bn"] = {"cfg": _spec_cfg(cfg3), "n": 1}

    (tmp / "spec.json").write_text(json.dumps(spec))
    run_ranks(_RANKS, 2, tmp)
    got = [json.loads((tmp / f"res{r}.json").read_text()) for r in range(2)]
    return {"ref": ref, "got": got, "tmp": tmp}


def _port_flat(path, template):
    from medicalsemseg_tpu_torch.utils.params import jax_tree_from_state_dict

    return flat_tree(jax_tree_from_state_dict(
        torch.load(path, weights_only=True), template))


def test_ddp_step_matches_the_sharded_jax_step(both):
    """Loss (rtol 1e-4), grad norm, Dice sums and counts, and every
    parameter after the update; both ranks report the global batch's
    metrics."""
    m, want, lr = both["ref"]["step"]
    for got in both["got"]:
        g = got["step"]
        np.testing.assert_allclose(g["loss"][0], float(m["loss"]), rtol=1e-4)
        np.testing.assert_allclose(g["grad_norm"][0], float(m["grad_norm"]),
                                   rtol=5e-3)
        np.testing.assert_allclose(g["dice_count"][0], m["dice_count"])
        np.testing.assert_allclose(g["dice_sum"][0], m["dice_sum"], atol=2e-3)
        assert g["updates"] == 1
    _assert_params(_port_flat(both["tmp"] / "step_after.pt",
                              both["ref"]["params"]), want, lr, "ddp step")


def test_ddp_accumulation_matches_multisteps(both):
    """Two micro-steps, the first under no_sync: the update is MultiSteps'
    on the mean of the global micro-batch gradients."""
    losses, want, lr = both["ref"]["accum"]
    for got in both["got"]:
        np.testing.assert_allclose(got["accum"]["loss"], losses, rtol=1e-4)
        assert got["accum"]["updates"] == 1
    _assert_params(_port_flat(both["tmp"] / "accum_after.pt",
                              both["ref"]["params"]), want, lr,
                   "ddp accumulation")


def test_pending_micro_gradients_sync_leaves_the_update(both):
    """``sync_pending_gradients`` between two micro-steps (a checkpoint at an
    epoch's end inside an accumulation): every rank holds the same pending
    sum, and the update after the second micro-step is MultiSteps' still."""
    losses, want, lr = both["ref"]["accum"]
    norms = [got["pending_norm"] for got in both["got"]]
    assert norms[0] == norms[1] > 0
    _assert_params(_port_flat(both["tmp"] / "pending_after.pt",
                              both["ref"]["params"]), want, lr,
                   "synchronised pending gradients")


def test_batchnorm_statistics_and_gradients_are_the_global_batchs(both):
    """SwInception's BatchNorms reduce over the two ranks: the running
    statistics after the step and the averaged gradients equal the JAX
    global batch's (gradients relative to the whole gradient's norm, the
    tolerances of ``assert_train_step_matches``); both ranks agree."""
    from medicalsemseg_tpu_torch.utils.params import jax_tree_from_state_dict

    jl, jg, jstats, variables = both["ref"]["bn"]
    ranks = [torch.load(both["tmp"] / f"bn_rank{r}.pt", weights_only=True)
             for r in range(2)]
    for name, g in ranks[0]["grads"].items():
        torch.testing.assert_close(ranks[1]["grads"][name], g, rtol=0, atol=0)
    for name, t in ranks[0]["state"].items():
        torch.testing.assert_close(ranks[1]["state"][name], t, rtol=0, atol=0)
    grads = jax_tree_from_state_dict(ranks[0]["grads"], variables["params"])
    stats = jax_tree_from_state_dict(ranks[0]["state"], variables)
    loss = np.mean([g["bn"]["loss"] for g in both["got"]])
    assert_train_step_matches({"jax": (jl, jg, jstats),
                               "port": (loss, grads, stats["batch_stats"])})
