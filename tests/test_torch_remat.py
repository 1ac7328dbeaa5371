"""Block rematerialisation in the PyTorch port (``--remat``) on the CPU.

``models/layers.py`` ``checkpoint_block`` runs the Swin encoder's blocks and
the UNETR decoder's under ``torch.utils.checkpoint``: ``full`` recomputes a
block in the backward, ``conv`` keeps what its conv modules computed and
recomputes the rest, ``mixed`` is ``conv`` with the decoder's two
full-resolution blocks under ``full``. The values must not change: in
training mode at ``drop_path_rate`` 0.2, the loss, every gradient, the
BatchNorm running statistics and the generator of the DropPath draws after a
step equal those under ``none`` bit for bit, as the JAX package's own test
holds ``mixed`` against ``none`` (``tests/test_models.py``). Also: one
``full`` forward and backward against the JAX package's ``full`` one, two
gloo ranks under ``full`` against one process, and the
``MEDSEG_WINOGRAD_TRAIN`` route (K9's plain version) under ``conv``, whose
kept conv outputs must not be computed again, and a count of the
convolutions that a block's backward runs again under each mode, which
fails if the selective checkpoint stops keeping them.
"""

import json

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from medicalsemseg_tpu_torch.config import Config
from medicalsemseg_tpu_torch.models import layers
from medicalsemseg_tpu_torch.models.decoders import UnetResBlock
from medicalsemseg_tpu_torch.models.factory import build_model, init_weights
from medicalsemseg_tpu_torch.ops.kernels import winograd3d as k9
from medicalsemseg_tpu_torch.train import state as pstate
from medicalsemseg_tpu_torch.train.losses import build_loss

from tests.test_torch_dist import run_ranks
from tests.test_torch_model import (assert_train_step_matches, small_cfg,
                                    train_step_both)

MODES = ("conv", "mixed", "full")
MODELS = {"nnFormerUNETR": (2, 2, 2, 2), "SwInception": (2, 2, 2, 2),
          "GCViTUNETR": (1, 1, 1, 1)}


def _cfg(name, mode, **kw):
    base = dict(model=name, vol_size=32, patch_size=2, hidden_dim=12,
                depths=MODELS[name], num_heads=(2,) * len(MODELS[name]),
                window_size=2, output_dim=3, compute_dtype="float32",
                device="cpu", remat=mode, drop_path_rate=0.2, lr=1e-3,
                warmup_epochs=0, weight_decay=1e-2)
    base.update(kw)
    return Config(**base)


def _step(name, mode):
    """One training-mode forward and backward of seeded weights on a
    seeded batch of 2, the DropPath masks drawn from the train state's
    generator: (loss, gradients, buffers, the generator's state after)."""
    cfg = _cfg(name, mode)
    model = build_model(cfg)
    init_weights(model, torch.Generator().manual_seed(0))
    state = pstate.create_train_state(cfg, model, 2, seed=5)
    model.train()
    g = torch.Generator().manual_seed(1)
    x = torch.randn(2, 32, 32, 32, 1, generator=g)
    y = torch.randint(0, 3, (2, 32, 32, 32), generator=g)
    loss = build_loss(cfg)(model((x, torch.zeros(2, 3), torch.ones(2, 3))), y)
    params = list(model.parameters())
    grads = torch.autograd.grad(loss, params, allow_unused=True)
    return (loss.detach(), grads,
            {k: v.clone() for k, v in model.named_buffers()},
            state.generator.get_state())


_NONE = {}


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("name", list(MODELS))
def test_remat_step_equals_none_bit_for_bit(name, mode, monkeypatch):
    """nnFormerUNETR (Swin encoder and decoder under the mode), SwInception
    (BatchNorm inside the checkpointed Swin blocks) and GCViTUNETR (its
    decoder alone) in training mode at drop_path_rate 0.2."""
    if name not in _NONE:
        _NONE[name] = _step(name, "none")
    calls = []
    real = layers.tcp.checkpoint
    monkeypatch.setattr(layers.tcp, "checkpoint",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    loss, grads, bufs, gen = _step(name, mode)
    want_loss, want_grads, want_bufs, want_gen = _NONE[name]
    # every encoder block (GC-ViT's: none) and the decoder's eleven
    n_swin = 0 if name == "GCViTUNETR" else sum(MODELS[name])
    assert len(calls) == n_swin + 11
    assert torch.equal(loss, want_loss)
    assert len(grads) == len(want_grads)
    for i, (a, b) in enumerate(zip(grads, want_grads)):
        assert (a is None) == (b is None), i
        assert a is None or torch.equal(a, b), i
    assert set(bufs) == set(want_bufs)
    stats = [k for k in bufs if k.endswith("running_var")]
    assert bool(stats) == (name == "SwInception")
    for k, v in bufs.items():
        assert torch.equal(v, want_bufs[k]), k
    assert torch.equal(gen, want_gen)


def test_no_checkpoint_without_gradients(monkeypatch):
    """Inference and validation run the blocks directly, as JAX's remat
    changes nothing there."""
    monkeypatch.setattr(layers.tcp, "checkpoint", None)
    model = build_model(_cfg("nnFormerUNETR", "full", depths=(1, 1, 1, 1),
                             num_heads=(2, 2, 2, 2)))
    init_weights(model, torch.Generator().manual_seed(0))
    x = torch.randn(1, 32, 32, 32, 1)
    with torch.no_grad():
        got = model.train()((x, None, None))
    assert got.shape == (1, 32, 32, 32, 3)
    with pytest.raises(ValueError, match="unknown remat mode"):
        layers.checkpoint_block(model, "some", x)


def test_full_matches_the_jax_full_step(monkeypatch):
    """One forward and backward of nnFormerUNETR under ``full`` in both
    packages (the JAX model under ``nn.remat``), at the train-step
    tolerances: loss rtol 1e-4, the gradient within 5e-3."""
    calls = []
    real = layers.tcp.checkpoint
    monkeypatch.setattr(layers.tcp, "checkpoint",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    cfg = small_cfg(depths=(1, 1, 1, 1), drop_path_rate=0.0, remat="full")
    both = train_step_both(cfg, seed=3)
    assert len(calls) == 4 + 11
    assert_train_step_matches(both)


def test_winograd_train_route_under_conv(monkeypatch):
    """``MEDSEG_WINOGRAD_TRAIN`` (K9's plain version, bf16): under ``conv``
    the block's two conv outputs are kept, so K9 runs as often as under
    ``none`` (2 forward + 2 dx), under ``full`` the forward twice; output
    and gradients equal ``none``'s bit for bit."""
    monkeypatch.setattr(k9, "ALLOW_CPU", True)
    monkeypatch.setenv("MEDSEG_WINOGRAD_TRAIN", "1")
    calls = []
    plain = k9.winograd_conv3d_f23_plain
    monkeypatch.setattr(k9, "winograd_conv3d_f23",
                        lambda x, w, **kw: calls.append(1) or plain(x, w, **kw))
    block = UnetResBlock(16, 16)
    init_weights(block, torch.Generator().manual_seed(2))
    g = torch.Generator().manual_seed(3)
    x0 = torch.randn(2, 8, 8, 8, 16, generator=g).bfloat16()
    dy = torch.randn(2, 8, 8, 8, 16, generator=g).bfloat16()
    out = {}
    for mode in ("none", "conv", "full"):
        calls.clear()
        x = x0.clone().requires_grad_(True)
        y = layers.checkpoint_block(block, mode, x)
        grads = torch.autograd.grad(y, [x] + list(block.parameters()), dy)
        out[mode] = (y.detach(), grads, len(calls))
    assert [out[m][2] for m in ("none", "conv", "full")] == [4, 4, 6]
    for mode in ("conv", "full"):
        assert torch.equal(out[mode][0], out["none"][0]), mode
        for a, b in zip(out[mode][1], out["none"][1]):
            assert torch.equal(a, b), mode


class _CountOps(TorchDispatchMode):
    """Counts the calls of ``ops`` that reach it: entered outside a
    checkpointed block, it sees what the checkpoint's own mode computes
    again, not what that mode hands back from what it kept."""

    def __init__(self, ops):
        super().__init__()
        self.ops, self.n = ops, 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.n += func in self.ops
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("mode,again", [("none", 0), ("conv", 0),
                                        ("full", 2)])
def test_backward_runs_convolutions_again_only_under_full(mode, again):
    """A UnetResBlock's two 3^3 convs: the backward computes neither again
    under ``conv`` (the policy, handed to ``checkpoint`` as its
    ``context_fn``, kept both products), both under ``full``; the weight
    gradients equal ``none``'s bit for bit."""
    block = UnetResBlock(8, 8)
    init_weights(block, torch.Generator().manual_seed(2))
    x = torch.randn(1, 8, 8, 8, 8, generator=torch.Generator().manual_seed(3),
                    requires_grad=True)
    y = layers.checkpoint_block(block, mode, x)
    with _CountOps({torch.ops.aten.convolution.default}) as count:
        grads = torch.autograd.grad(y.square().sum(), list(block.parameters()))
    assert count.n == again
    want = torch.autograd.grad(block(x).square().sum(),
                               list(block.parameters()))
    for a, b in zip(grads, want):
        assert torch.equal(a, b)


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
    cfg = Config(**kw)
    model = build_model(cfg)
    model.load_state_dict(torch.load(os.path.join(out, "init.pt")))
    st = pstate.distribute(pstate.create_train_state(cfg, model, 2),
                           create_mesh(4).group)
    b = np.load(os.path.join(out, "batch.npz"))
    m = pstate.make_train_step(cfg)(st, shard_batch(
        {k: torch.from_numpy(b[k]) for k in b.files}, rank, 2))
    if rank == 0:
        torch.save(st.model.state_dict(), os.path.join(out, "after.pt"))
    json.dump({"loss": float(m["loss"]), "grad_norm": float(m["grad_norm"])},
              open(os.path.join(out, f"res{rank}.json"), "w"))
    pdist.shutdown()
"""


def test_two_ranks_under_full_match_one_process(tmp_path):
    """SwInception (its BatchNorms reduce over the ranks inside the
    checkpointed blocks; the recompute takes the forward's sums) on a
    global batch of 4, 2 a rank under DDP and ``full``, against one process
    on the whole batch under ``none``: loss, grad norm, BatchNorm running
    statistics and the parameters after the update."""
    kw = dict(model="SwInception", vol_size=16, patch_size=2, hidden_dim=12,
              depths=[1, 1], num_heads=[2, 2], window_size=2, output_dim=3,
              compute_dtype="float32", device="cpu", remat="full",
              drop_path_rate=0.0, lr=1e-3, warmup_epochs=0,
              weight_decay=1e-2, epochs=3)
    cfg = Config(**{**kw, "depths": (1, 1), "num_heads": (2, 2),
                    "remat": "none"})
    model = build_model(cfg)
    init_weights(model, torch.Generator().manual_seed(4))
    torch.save(model.state_dict(), tmp_path / "init.pt")
    rng = np.random.default_rng(6)
    batch = {"image": rng.normal(size=(4, 16, 16, 16, 1)).astype(np.float32),
             "label": rng.integers(0, 3, size=(4, 16, 16, 16)).astype(np.int32),
             "crop_loc": rng.uniform(size=(4, 3)).astype(np.float32),
             "affine": np.ones((4, 3), np.float32)}
    np.savez(tmp_path / "batch.npz", **batch)
    (tmp_path / "cfg.json").write_text(json.dumps(kw))
    run_ranks(_RANKS, 2, tmp_path)

    st = pstate.create_train_state(cfg, model, 2)
    m = pstate.make_train_step(cfg)(
        st, {k: torch.from_numpy(v) for k, v in batch.items()})
    got = [json.loads((tmp_path / f"res{r}.json").read_text())
           for r in range(2)]
    for r in got:
        np.testing.assert_allclose(r["loss"], float(m["loss"]), rtol=1e-5)
        np.testing.assert_allclose(r["grad_norm"], float(m["grad_norm"]),
                                   rtol=1e-4)
    after = torch.load(tmp_path / "after.pt")
    want = st.model.state_dict()
    assert set(after) == set(want)
    diffs = []
    for k, v in want.items():
        if k.endswith(("running_mean", "running_var")):
            torch.testing.assert_close(after[k], v, rtol=1e-5, atol=1e-6)
            continue
        d = (after[k] - v).abs()
        # an early Adam step is sign(g)-like: a tiny |g| may flip by ~lr
        assert float(d.max()) <= 2 * cfg.lr, k
        diffs.append(d.reshape(-1))
    assert float(torch.cat(diffs).mean()) < cfg.lr / 10
