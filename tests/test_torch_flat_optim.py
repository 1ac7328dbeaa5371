"""``--flat_optimizer`` in the PyTorch port on the CPU.

The JAX package's flat-buffer AdamW computes the optax chain's arithmetic
(clip, bias-corrected Adam, masked decay) as one pass over flat buffers, a
fusion for the TPU; the port takes the flag and runs its ``torch.optim.AdamW``
update (``train/state.py``), which computes the same numbers. Three updates
with clipping, the epoch schedule and the weight-decay mask against the JAX
package's ``flat_adamw`` in both its forms (fused apply, and the plain form
that ``--grad_accum_steps`` > 1 takes) on the same numpy parameters and
gradients, at the limits ``tests/test_flat_optim.py`` holds it to against
optax (rtol 1e-6, atol 1e-7). Then: a save and ``--resume`` round trip that
goes on bit for bit, with the flag or without it, the zero gradient of a
parameter the loss does not reach, two gloo ranks under DDP, and the
training CLI with the flag, with and without accumulation.
"""

import json
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from medicalsemseg_tpu.train.flat_optim import flat_adamw
from medicalsemseg_tpu.train.state import weight_decay_mask as jax_mask
from medicalsemseg_tpu.train.schedule import make_epoch_schedule as jax_sched

from medicalsemseg_tpu_torch.cli import run_training as cli
from medicalsemseg_tpu_torch.config import Config, get_args
from medicalsemseg_tpu_torch.models.factory import build_model, init_weights
from medicalsemseg_tpu_torch.train import state as pstate
from medicalsemseg_tpu_torch.utils import checkpoint as ckpt

from tests.test_torch_dist import run_ranks
from tests.test_torch_run_training import ARGV, _log, _write_train_set

# leaves of every rank the models have: decayed kernels, undecayed vectors
SHAPES = {"a": {"kernel": (3, 4, 5)}, "b": {"bias": (7,)},
          "c": {"scale": (4,)}, "d": {"kernel": (6, 6)},
          "e": {"kernel": (2, 3, 3, 3, 4)}}
LR, WD, CLIP = 2e-3, 0.05, 0.5


def _tree(rng, scale=1.0):
    return {k: {n: (scale * rng.normal(size=s)).astype(np.float32)
                for n, s in v.items()} for k, v in SHAPES.items()}


def _leaves(tree):
    return jax.tree_util.tree_leaves(tree)


@pytest.mark.parametrize("fused", [True, False], ids=["fused", "plain"])
def test_three_updates_match_jax_flat_adamw(fused):
    """Gradients large enough that the clip scales them; LR from the epoch
    schedule (warm-up, then cosine) read at count - 1. The port's update is
    ``train/state.py``'s, over the parameters in its optimizer's order."""
    rng = np.random.default_rng(0)
    params = _tree(rng)
    grads = [_tree(rng, scale=3.0) for _ in range(3)]
    tx = flat_adamw(jax_sched(LR, 1, 4, 1), b1=0.9, b2=0.95, eps=1e-6,
                    weight_decay=WD, mask_fn=jax_mask, clip_norm=CLIP,
                    fused_apply=fused)
    jp = jax.tree_util.tree_map(jnp.asarray, params)
    js = tx.init(jp)

    model = torch.nn.ParameterList(
        [torch.nn.Parameter(torch.from_numpy(a.copy()))
         for a in _leaves(params)])
    cfg = Config(flat_optimizer=True, lr=LR, warmup_epochs=1, epochs=4,
                 weight_decay=WD, gradient_clipping=CLIP, device="cpu",
                 grad_accum_steps=1 if fused else 2)
    st = pstate.create_train_state(cfg, model, 1)
    order = [p for g in st.optimizer.param_groups for p in g["params"]]
    where = [next(i for i, q in enumerate(model) if q is p) for p in order]
    sizes = np.cumsum([0] + [a.size for a in _leaves(params)])
    for i, g in enumerate(grads):
        out, js = tx.update(jax.tree_util.tree_map(jnp.asarray, g), js, jp)
        jp = out if fused else optax.apply_updates(jp, out)
        tg = [torch.from_numpy(_leaves(g)[j]) for j in where]
        np.testing.assert_allclose(float(pstate.global_norm(tg)),
                                   float(js.grad_norm), rtol=1e-6)
        pstate._apply_update(st, tg)
        for got, want in zip(model, _leaves(jp)):
            np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                                       rtol=1e-6, atol=1e-7, err_msg=str(i))
        for j, p in enumerate(model):
            ps = st.optimizer.state[p]
            cut = slice(sizes[j], sizes[j + 1])
            for name, flat in (("exp_avg", js.m), ("exp_avg_sq", js.v)):
                np.testing.assert_allclose(
                    ps[name].numpy().reshape(-1), np.asarray(flat)[cut],
                    rtol=1e-6, atol=1e-7, err_msg=f"{name} {j} {i}")
            assert float(ps["step"]) == int(js.count) == i + 1
    assert st.updates == 3
    np.testing.assert_array_equal(
        np.asarray(js.wd_mask),
        np.concatenate([np.full(a.size, float(a.ndim > 1), np.float32)
                        for a in _leaves(params)]))


def _cfg(**kw):
    base = dict(model="nnFormerUNETR", vol_size=16, patch_size=2,
                hidden_dim=12, depths=(1, 1), num_heads=(2, 2), window_size=2,
                output_dim=3, compute_dtype="float32", device="cpu",
                flat_optimizer=True, drop_path_rate=0.2, lr=1e-3,
                warmup_epochs=0, weight_decay=1e-2, gradient_clipping=1.0,
                epochs=3)
    base.update(kw)
    return Config(**base)


def _state(cfg, seed=0):
    model = build_model(cfg)
    init_weights(model, torch.Generator().manual_seed(seed))
    return pstate.create_train_state(cfg, model, 2)


def _batches(n, seed=1):
    g = torch.Generator().manual_seed(seed)
    return [{"image": torch.randn(2, 16, 16, 16, 1, generator=g),
             "label": torch.randint(0, 3, (2, 16, 16, 16), generator=g),
             "crop_loc": torch.rand(2, 3, generator=g),
             "affine": torch.ones(2, 3)} for _ in range(n)]


@pytest.mark.parametrize("accum", [1, 2], ids=["fused", "plain"])
def test_resume_continues_bit_for_bit(tmp_path, accum):
    """Four micro-steps straight through against two, a checkpoint, a fresh
    state restored from it and two more: parameters, moments, count and the
    step's metrics equal bit for bit (with accumulation the checkpoint falls
    between two updates of two micro-steps each). A run without the flag
    resumes the same checkpoint into the same optimizer state."""
    cfg = _cfg(grad_accum_steps=accum)
    batches = _batches(4)
    step = pstate.make_train_step(cfg)
    straight = _state(cfg)
    want = [step(straight, b) for b in batches]

    first = _state(cfg)
    for b in batches[:2]:
        step(first, b)
    path = ckpt.save_checkpoint(str(tmp_path), "ck", first, 0)
    resumed, epoch = ckpt.load_checkpoint(path, _state(cfg, seed=9))
    assert epoch == 1
    got = [step(resumed, b) for b in batches[2:]]
    for a, b in zip(got, want[2:]):
        assert torch.equal(a["loss"], b["loss"])
        assert torch.equal(a["grad_norm"], b["grad_norm"])
    for p, q in zip(resumed.model.parameters(), straight.model.parameters()):
        assert torch.equal(p, q)
        a, b = resumed.optimizer.state[p], straight.optimizer.state[q]
        for name in ("exp_avg", "exp_avg_sq", "step"):
            assert torch.equal(a[name], b[name]), name
    assert resumed.updates == straight.updates == 4 // accum
    other, _ = ckpt.load_checkpoint(
        path, _state(_cfg(flat_optimizer=False, grad_accum_steps=accum)))
    for p, q in zip(other.model.parameters(), first.model.parameters()):
        for name in ("exp_avg", "exp_avg_sq", "step"):
            assert torch.equal(other.optimizer.state[p][name],
                               first.optimizer.state[q][name]), name


def test_flat_gradient_of_an_unreached_parameter_is_zero():
    """``--global_token``: the last stage's ``gt_upsample`` gets a zero
    gradient (not none): its moments stay 0 on the first update and only
    the decay moves its kernel, as JAX's zero gradient does."""
    cfg = _cfg(global_token=True, depths=(1, 1), lr=1e-2)
    st = _state(cfg)
    last = f"encoder.layers.{len(cfg.depths) - 1}.gt_upsample.weight"
    p = dict(st.model.named_parameters())[last]
    before = p.detach().clone()
    pstate.make_train_step(cfg)(st, _batches(1)[0])
    ps = st.optimizer.state[p]
    assert not bool(ps["exp_avg"].any()) and not bool(ps["exp_avg_sq"].any())
    torch.testing.assert_close(p.detach(), before * (1 - 1e-2 * cfg.weight_decay),
                               rtol=1e-6, atol=0)


_RANKS = """
    import json, os, numpy as np, torch
    from medicalsemseg_tpu_torch.config import Config
    from medicalsemseg_tpu_torch.models.factory import build_model
    from medicalsemseg_tpu_torch.parallel import dist as pdist
    from medicalsemseg_tpu_torch.parallel.mesh import create_mesh, shard_batch
    from medicalsemseg_tpu_torch.train import state as pstate

    torch.set_num_threads(2)
    out = os.environ["OUT"]
    pdist.init_distributed_mode(Config(), torch.device("cpu"))
    rank = pdist.get_rank()
    kw = json.load(open(os.path.join(out, "cfg.json")))
    kw["depths"], kw["num_heads"] = tuple(kw["depths"]), tuple(kw["num_heads"])
    b = np.load(os.path.join(out, "batch.npz"))
    mesh = create_mesh(4)
    res = {}
    for accum in (1, 2):
        cfg = Config(**kw, grad_accum_steps=accum)
        model = build_model(cfg)
        # the ranks start apart: DDP's broadcast at wrap time makes them
        # rank 0's
        model.load_state_dict(torch.load(os.path.join(out, f"init{rank}.pt")))
        st = pstate.distribute(pstate.create_train_state(cfg, model, 2),
                               mesh.group)
        for _ in range(2):
            m = pstate.make_train_step(cfg)(st, shard_batch(
                {k: torch.from_numpy(b[k]) for k in b.files}, rank, 2))
        torch.save(st.model.state_dict(),
                   os.path.join(out, f"after{accum}_{rank}.pt"))
        res[accum] = float(m["loss"])
    json.dump(res, open(os.path.join(out, f"res{rank}.json"), "w"))
    pdist.shutdown()
"""


def test_two_ranks_match_one_process(tmp_path):
    """Two gloo ranks under DDP with ``--flat_optimizer`` against one
    process on the whole batch, two micro-steps: two updates (DDP's
    broadcast at wrap time replaces rank 1's weights with rank 0's), and
    under ``--grad_accum_steps 2`` one (the first micro-step under
    ``no_sync()``); the last loss and the parameters after."""
    kw = dict(model="nnFormerUNETR", vol_size=16, patch_size=2, hidden_dim=12,
              depths=[1, 1], num_heads=[2, 2], window_size=2, output_dim=3,
              compute_dtype="float32", device="cpu", flat_optimizer=True,
              drop_path_rate=0.0, lr=1e-3, warmup_epochs=0,
              weight_decay=1e-2, gradient_clipping=1.0, epochs=3,
              remat="none")
    cfg = Config(**{**kw, "depths": (1, 1), "num_heads": (2, 2)})
    torch.save(_state(cfg, seed=4).model.state_dict(), tmp_path / "init0.pt")
    torch.save(_state(cfg, seed=5).model.state_dict(), tmp_path / "init1.pt")
    b = _batches(1, seed=6)[0]
    batch = {k: torch.cat([v, v.flip(0)]) for k, v in b.items()}
    np.savez(tmp_path / "batch.npz", **{k: v.numpy() for k, v in batch.items()})
    (tmp_path / "cfg.json").write_text(json.dumps(kw))
    run_ranks(_RANKS, 2, tmp_path)
    got = [json.loads((tmp_path / f"res{r}.json").read_text())
           for r in range(2)]

    for accum in (1, 2):
        acfg = cfg.replace(grad_accum_steps=accum)
        st = _state(acfg, seed=4)
        step = pstate.make_train_step(acfg)
        for _ in range(2):
            m = step(st, batch)
        assert st.updates == 2 // accum
        want = dict(st.model.named_parameters())
        for r in range(2):
            np.testing.assert_allclose(got[r][str(accum)], float(m["loss"]),
                                       rtol=1e-5)
            after = torch.load(tmp_path / f"after{accum}_{r}.pt")
            diffs = []
            for n, p in want.items():
                d = (after[n] - p.detach()).abs()
                assert float(d.max()) <= 4 * cfg.lr, (accum, r, n)
                diffs.append(d.reshape(-1))
            assert float(torch.cat(diffs).mean()) < cfg.lr / 10, (accum, r)


@pytest.mark.parametrize("accum", [1, 2])
def test_training_cli_runs_an_epoch(tmp_path, accum):
    """``run_training --flat_optimizer`` for one epoch of 2 steps (with
    ``--grad_accum_steps 2``: one update), the checkpoint holding AdamW's
    state, then a ``--resume`` epoch."""
    _write_train_set(tmp_path)
    out = str(tmp_path / "out")
    os.makedirs(out)
    argv = ARGV + ["--data_path", str(tmp_path), "--output_dir", out,
                   "--flat_optimizer", "--grad_accum_steps", str(accum)]
    cli.main(get_args(argv + ["--epochs", "1"]))
    first = torch.load(os.path.join(out, "checkpoint-0.pth"),
                       weights_only=True)
    opt = first["optimizer"]
    n = sum(1 for k in first["model"]
            if not k.endswith(("running_mean", "running_var")))
    assert len(opt["state"]) == n and first["updates"] == 2 // accum
    for ps in opt["state"].values():
        assert float(ps["step"]) == 2 // accum
        assert bool(torch.isfinite(ps["exp_avg_sq"]).all())
    cli.main(get_args(argv + ["--epochs", "2", "--resume",
                              os.path.join(out, "checkpoint-0.pth")]))
    log = _log(out)
    assert [r["epoch"] for r in log] == [0, 1]
    assert all(np.isfinite(r["train/loss"]) for r in log)
