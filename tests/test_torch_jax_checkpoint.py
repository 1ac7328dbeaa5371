"""Checkpoints of the JAX package into the port: an orbax directory written by
the JAX package's ``save_checkpoint``, converted by
``tools/jax_checkpoint_to_torch.py``, loads through the port's
``load_checkpoint`` with every tensor bit-equal and the counters right.

The JAX states are built abstractly (``jax.eval_shape`` of the JAX
``create_train_state``: nothing is initialised or compiled) and filled with
seeded numpy values: parameters, BatchNorm statistics, AdamW's moments, the
accumulated gradients of ``optax.MultiSteps`` and the counters. SegFormer3D
has BatchNorm statistics; the flagship runs with and without MultiSteps,
and under ``--flat_optimizer``.
"""

import importlib.util
import os

import numpy as np
import pytest

import jax
import torch

from medicalsemseg_tpu.config import get_args as jax_get_args
from medicalsemseg_tpu.models import build_model as jax_build_model
from medicalsemseg_tpu.train.state import create_train_state as jax_state
from medicalsemseg_tpu.utils import checkpoint as jax_ckpt

from medicalsemseg_tpu_torch.config import get_args
from medicalsemseg_tpu_torch.models.factory import build_model
from medicalsemseg_tpu_torch.train.state import create_train_state
from medicalsemseg_tpu_torch.utils import checkpoint as ckpt
from medicalsemseg_tpu_torch.utils.params import state_dict_from_jax

_TOOL = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "tools", "jax_checkpoint_to_torch.py")

FLAGSHIP = ["--model", "nnFormerUNETR", "--vol_size", "32", "--patch_size",
            "2", "--hidden_dim", "12", "--depths", "1", "1", "1", "1",
            "--num_heads", "2", "2", "2", "2", "--window_size", "2",
            "--output_dim", "3", "--compute_dtype", "float32", "--qkv_bias"]
SEGFORMER = ["--model", "SegFormer3D", "--vol_size", "32", "--hidden_dim",
             "12", "--depths", "1", "1", "1", "1", "--output_dim", "3",
             "--compute_dtype", "float32"]
OPTIM = ["--n_images_per_batch", "2", "--lr", "1e-3", "--weight_decay",
         "0.05", "--gradient_clipping", "1.0"]


def tool():
    spec = importlib.util.spec_from_file_location("jax_checkpoint_to_torch",
                                                  _TOOL)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _abstract_state(argv):
    cfg = jax_get_args(argv)
    model = jax_build_model(cfg)
    b = cfg.n_images_per_batch * cfg.t_n_patches_per_image
    probe = (jax.ShapeDtypeStruct((b, *cfg.vol_size3(), cfg.in_chans),
                                  np.float32),
             jax.ShapeDtypeStruct((b, 3), np.float32),
             jax.ShapeDtypeStruct((b, 3), np.float32))
    return jax.eval_shape(lambda r, x: jax_state(cfg, model, r, x, 1)[0],
                          jax.random.PRNGKey(0), probe)


def seeded_state(argv, seed, step, updates, mini_step):
    """The JAX TrainState of ``argv`` with every float leaf drawn from a
    numpy generator seeded with ``seed`` (second moments and running
    variances positive) and the counters set: ``step`` (the state's),
    ``updates`` (every optax count and MultiSteps' gradient_step),
    ``mini_step``."""
    rng = np.random.default_rng(seed)

    def fill(path, leaf):
        names = [str(getattr(k, "key", getattr(k, "name", k))) for k in path]
        if np.issubdtype(leaf.dtype, np.integer):
            n = {"step": step, "mini_step": mini_step}.get(names[-1], updates)
            return np.asarray(n, leaf.dtype)
        z = rng.normal(size=leaf.shape)
        if "nu" in names or names[-1] == "var":
            z = np.abs(z) + 0.1
        return z.astype(leaf.dtype)

    return jax.tree_util.tree_map_with_path(fill, _abstract_state(argv))


def _convert(tmp_path, argv, state, epoch):
    jax_ckpt.save_checkpoint(str(tmp_path), "jax-ckpt", state, epoch)
    out = str(tmp_path / "port" / "converted.pth")
    path = tool().convert(argv + ["--resume", str(tmp_path / "jax-ckpt"),
                                  "--out", out])
    assert path == out and os.path.isfile(out)
    return out


def _port_state(argv):
    cfg = get_args(argv + ["--device", "cpu"])
    model = build_model(cfg)
    return cfg, create_train_state(cfg, model, steps_per_epoch=3)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.mark.parametrize("name,argv,accum", [
    ("SegFormer3D", SEGFORMER, 1),
    ("flagship", FLAGSHIP, 1),
    ("flagship", FLAGSHIP, 2),
])
def test_converted_checkpoint_loads_bit_equal(tmp_path, name, argv, accum):
    argv = argv + OPTIM + ["--grad_accum_steps", str(accum)]
    # mid-accumulation with MultiSteps: 5 micro-steps of 2 are 2 updates and
    # one pending gradient; without it, 3 steps are 3 updates
    step, updates, mini = (5, 2, 1) if accum > 1 else (3, 3, 0)
    state = seeded_state(argv, seed=7, step=step, updates=updates,
                         mini_step=mini)
    out = _convert(tmp_path, argv, state, epoch=4)

    cfg, port = _port_state(argv)
    port, next_epoch = ckpt.load_checkpoint(out, port)
    assert next_epoch == 5
    assert (port.step, port.updates) == (step, updates)

    variables = {"params": _np(state.params)}
    if jax.tree_util.tree_leaves(state.batch_stats):
        variables["batch_stats"] = _np(state.batch_stats)
    want = state_dict_from_jax(variables)
    got = port.model.state_dict()
    assert set(got) == set(want)
    assert any(k.endswith("running_var") for k in got) == (name ==
                                                           "SegFormer3D")
    for k, v in want.items():
        assert got[k].dtype == torch.float32 and torch.equal(got[k], v), k

    opt = state.opt_state.inner_opt_state if accum > 1 else state.opt_state
    adam = opt[-1][0]                       # chain(clip, adamw): adamw's first
    mu, nu = state_dict_from_jax(_np(adam.mu)), state_dict_from_jax(
        _np(adam.nu))
    names = {p: n for n, p in port.model.named_parameters()}
    decay = {n: p.dim() > 1 for n, p in port.model.named_parameters()}
    jax_decay = state_dict_from_jax(jax.tree_util.tree_map(
        lambda p: np.full(p.shape, p.ndim > 1, np.float32),
        _np(state.params)))
    groups = port.optimizer.param_groups
    assert [g["weight_decay"] for g in groups] == [cfg.weight_decay, 0.0]
    for gi, g in enumerate(groups):
        for p in g["params"]:
            n = names[p]
            assert decay[n] == (gi == 0) == bool(jax_decay[n].flatten()[0]), n
            s = port.optimizer.state[p]
            assert float(s["step"]) == updates, n
            assert torch.equal(s["exp_avg"], mu[n]), n
            assert torch.equal(s["exp_avg_sq"], nu[n]), n

    if accum > 1:
        acc = state_dict_from_jax(_np(state.opt_state.acc_grads))
        params = [p for g in groups for p in g["params"]]
        assert len(port.accum) == len(params)
        for a, p in zip(port.accum, params):
            assert torch.equal(a, acc[names[p]] * mini), names[p]
    else:
        assert port.accum == []


def test_flat_optimizer_checkpoint_is_refused(tmp_path):
    """A checkpoint of a JAX run under ``--flat_optimizer`` (refused until
    the port took the flag) converts, with the flag and without it, into
    ``torch.optim.AdamW``'s state, which the port runs either way: the flat
    moments cut back along the parameters' ravel order, bit-equal."""
    from jax.flatten_util import ravel_pytree

    argv = FLAGSHIP + OPTIM + ["--flat_optimizer"]
    state = seeded_state(argv, seed=1, step=2, updates=2, mini_step=0)
    flat, unravel = ravel_pytree(state.params)
    # the fused form's master copy is the parameters themselves
    state = state.replace(opt_state=state.opt_state._replace(flat_p=flat))
    jax_ckpt.save_checkpoint(str(tmp_path), "flat", state, 0)
    mu = state_dict_from_jax(_np(unravel(state.opt_state.m)))
    nu = state_dict_from_jax(_np(unravel(state.opt_state.v)))
    params = state_dict_from_jax({"params": _np(state.params)})
    for flags in (argv, FLAGSHIP + OPTIM):      # with and without the flag
        out = str(tmp_path / f"x{len(flags)}.pth")
        tool().convert(flags + ["--resume", str(tmp_path / "flat"),
                                "--out", out])
        _, port = _port_state(flags)
        port, _ = ckpt.load_checkpoint(out, port)
        assert (port.step, port.updates) == (2, 2)
        assert isinstance(port.optimizer, torch.optim.AdamW)
        for n, p in port.model.named_parameters():
            assert torch.equal(p.detach(), params[n]), n
            st = port.optimizer.state[p]
            assert float(st["step"]) == 2, n
            assert torch.equal(st["exp_avg"], mu[n]), n
            assert torch.equal(st["exp_avg_sq"], nu[n]), n


def test_mismatched_model_flags_are_refused_naming_the_keys(tmp_path):
    argv = FLAGSHIP + OPTIM
    state = seeded_state(argv, seed=2, step=1, updates=1, mini_step=0)
    jax_ckpt.save_checkpoint(str(tmp_path), "ck", state, 0)
    resume = ["--resume", str(tmp_path / "ck"), "--out",
              str(tmp_path / "x.pth")]
    wider = [a if a != "12" else "24" for a in argv]          # --hidden_dim
    with pytest.raises(ValueError, match="size mismatch for"):
        tool().convert(wider + resume)
    deeper = argv[:argv.index("--depths")] + [
        "--depths", "1", "1", "1", "2"] + argv[argv.index("--depths") + 5:]
    with pytest.raises(ValueError, match="Missing key"):
        tool().convert(deeper + resume)
    assert not os.path.exists(tmp_path / "x.pth")
