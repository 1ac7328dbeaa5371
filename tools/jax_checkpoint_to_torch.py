"""Convert a training checkpoint of the JAX package into the PyTorch port's.

The JAX package saves an orbax directory (``medicalsemseg_tpu/utils/
checkpoint.py``: params, batch_stats, the optax state, step and epoch); the
port reads one ``torch.save`` file (``medicalsemseg_tpu_torch/utils/
checkpoint.py``). This tool reads the first and writes the second, so that a
model trained by the JAX package resumes, tests and evaluates in the port.
It runs on a host that has the JAX package (jax, flax, optax, orbax) beside
PyTorch; the port itself imports no JAX, and nothing in it imports this tool.

    JAX_PLATFORMS=cpu python tools/jax_checkpoint_to_torch.py \\
        <the model flags of the training run> \\
        --resume <output_dir>/checkpoint-9 --out checkpoint-9.pth

The flags are the JAX CLIs' (``medicalsemseg_tpu/config.py``): the model and
optimizer flags of the run that wrote the checkpoint (``--model``,
``--vol_size``, ``--hidden_dim``, ``--depths``, ..., ``--gradient_clipping``,
``--grad_accum_steps``). The converted file then goes through the port's
CLIs as any port checkpoint does: ``run_training.py --resume`` restores
everything and goes on at the next epoch, ``run_test.py`` and
``run_evaluation.py --resume`` read the model.

What is carried over:
  * the parameters and the BatchNorm statistics (``state_dict_from_jax``);
  * AdamW's moments and its update count, found in the restored optax state
    wherever the clip / masked-decay chain and ``optax.MultiSteps`` put them,
    or in the flat AdamW's state of a run under ``--flat_optimizer`` (its
    flat ``m`` and ``v`` cut back into per-parameter trees along the
    parameters' ravel order; a fused run's ``flat_p`` is its parameters
    themselves, and must equal them). They go into ``torch.optim.AdamW``'s
    state (``load_adamw_state_from_optax``), which the port runs with the
    flag or without it;
  * ``step`` (the JAX state's, one per micro-step), ``updates`` (MultiSteps'
    ``gradient_step``, or ``step`` without accumulation) and the epoch;
  * the gradients of a checkpoint saved inside an accumulation: optax keeps
    their running mean (MultiSteps' ``acc_grads`` after ``mini_step``
    micro-steps), the port their sum (``TrainState.accum``), so they are
    multiplied by ``mini_step``.
The port's random generator (DropPath, Dropout) is seeded from ``--seed`` as
the port's ``create_train_state`` seeds it; the two packages' random streams
differ in any case.

Refused with a message: flags whose model does not match the checkpoint
(the port's strict ``load_state_dict`` names the keys).
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import sys
from typing import Dict, Optional, Tuple

import numpy as np

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if _REPO not in sys.path:
    sys.path.insert(0, _REPO)

# the flat optimizer's state fields (medicalsemseg_tpu/train/flat_optim.py
# FlatAdamWState) that no optax state has
_FLAT_FIELDS = ("wd_mask", "flat_p")


def _moments(opt, params, resume):
    """(first moments, second moments, update count) of the restored
    optimizer state ``opt``: optax's AdamW state, or the flat AdamW's cut
    back into trees shaped like ``params``."""
    import jax
    from jax.flatten_util import ravel_pytree

    to_np = lambda tree: jax.tree_util.tree_map(np.asarray, tree)  # noqa: E731
    flat = _find(opt, ("m", "v", "count") + _FLAT_FIELDS)
    if flat is not None:
        raveled, unravel = ravel_pytree(params)
        if np.asarray(flat.flat_p).size and not np.array_equal(
                np.asarray(flat.flat_p), np.asarray(raveled)):
            raise ValueError(f"{resume}: the flat optimizer's master "
                             "parameters differ from the parameters")
        return (to_np(unravel(flat.m)), to_np(unravel(flat.v)),
                int(flat.count))
    adam = _find(opt, ("mu", "nu", "count"))
    if adam is None:
        raise ValueError(f"{resume}: no AdamW state in the optimizer state")
    return to_np(adam.mu), to_np(adam.nu), int(adam.count)


def _parse(argv) -> Tuple[str, list]:
    ap = argparse.ArgumentParser(
        description=__doc__.splitlines()[0],
        epilog="every other flag is the JAX CLIs' (medicalsemseg_tpu/config.py)")
    ap.add_argument("--out", required=True,
                    help="the port's checkpoint file to write (.pth)")
    ns, rest = ap.parse_known_args(argv)
    if not ns.out.endswith(".pth"):
        ap.error("--out names a .pth file (the port's checkpoint)")
    return ns.out, rest


def _metadata_tree(path: str):
    """The saved tree of an orbax checkpoint: nested dicts and lists whose
    leaves carry ``shape`` and ``dtype``."""
    import orbax.checkpoint as ocp

    meta = ocp.StandardCheckpointer().metadata(os.path.abspath(path))
    meta = getattr(meta, "item_metadata", meta)
    return getattr(meta, "tree", meta)


def _has_key(tree, names) -> bool:
    if isinstance(tree, dict):
        return any(k in names or _has_key(v, names) for k, v in tree.items())
    if isinstance(tree, (list, tuple)):
        return any(_has_key(v, names) for v in tree)
    return False


def _shapes(tree, prefix=()) -> Dict[Tuple[str, ...], tuple]:
    """path -> shape of every leaf of a nested dict (a parameter tree, its
    abstract template or its orbax metadata)."""
    if isinstance(tree, dict) or hasattr(tree, "items"):
        out = {}
        for k, v in tree.items():
            out.update(_shapes(v, prefix + (str(k),)))
        return out
    return {prefix: tuple(tree.shape)}


def _zeros_like_meta(tree):
    if isinstance(tree, dict) or hasattr(tree, "items"):
        return {k: _zeros_like_meta(v) for k, v in tree.items()}
    return np.zeros(tuple(tree.shape), np.float32)


def _find(tree, fields):
    """The first node of ``tree`` (namedtuples, tuples, lists, dicts) that
    has every attribute of ``fields``, depth first, or None."""
    if all(hasattr(tree, f) for f in fields):
        return tree
    if isinstance(tree, dict):
        children = tree.values()
    elif isinstance(tree, (list, tuple)):
        children = tree
    else:
        return None
    for child in children:
        hit = _find(child, fields)
        if hit is not None:
            return hit
    return None


def _refuse_mismatch(model, saved, want) -> None:
    """The flags' model does not match the checkpoint's parameters: load
    the checkpoint's (as zeros of its shapes) into the port's model from the
    flags with the strict ``load_state_dict``, whose error names the keys."""
    from medicalsemseg_tpu_torch.utils.params import state_dict_from_jax

    try:
        sd = state_dict_from_jax({k: _zeros_like_meta(v)
                                  for k, v in saved.items()})
        model.load_state_dict(sd, strict=True)
    except (RuntimeError, KeyError) as e:
        raise ValueError(f"the flags' model does not match the checkpoint: "
                         f"{e}") from e
    raise ValueError("the flags' model does not match the checkpoint: "
                     f"{len(set(saved) ^ set(want))} parameter paths differ")


def convert(argv) -> str:
    """Convert the checkpoint named by ``--resume`` into ``--out``; returns
    the path written."""
    out, rest = _parse(argv)

    import jax

    from medicalsemseg_tpu.config import get_args as jax_get_args
    from medicalsemseg_tpu.models import build_model as jax_build_model
    from medicalsemseg_tpu.train.state import create_train_state as jax_state
    from medicalsemseg_tpu.utils import checkpoint as jax_ckpt

    from medicalsemseg_tpu_torch.config import get_args
    from medicalsemseg_tpu_torch.models.factory import build_model
    from medicalsemseg_tpu_torch.train.state import create_train_state
    from medicalsemseg_tpu_torch.utils import checkpoint as ckpt
    from medicalsemseg_tpu_torch.utils.params import (
        load_adamw_state_from_optax,
        state_dict_from_jax,
    )

    jcfg = jax_get_args(rest)
    if not jcfg.resume:
        raise ValueError("--resume <the JAX checkpoint directory> is required")
    saved = _metadata_tree(jcfg.resume)
    # the JAX state as the checkpoint holds it: its optimizer is the flat
    # one exactly when the flat fields are there, whatever the flags say
    jcfg = dataclasses.replace(jcfg, flat_optimizer=_has_key(
        saved.get("opt_state"), _FLAT_FIELDS))

    # the port's state from the same flags, on the CPU
    cfg = get_args(rest + ["--device", "cpu"])
    model = build_model(cfg)
    state = create_train_state(cfg, model, steps_per_epoch=1, seed=cfg.seed)

    # the JAX state's structure, abstractly (nothing is initialised)
    jmodel = jax_build_model(jcfg)
    b = jcfg.n_images_per_batch * jcfg.t_n_patches_per_image
    v = jcfg.vol_size3()
    probe = (jax.ShapeDtypeStruct((b, *v, jcfg.in_chans), np.float32),
             jax.ShapeDtypeStruct((b, 3), np.float32),
             jax.ShapeDtypeStruct((b, 3), np.float32))
    template = jax.eval_shape(
        lambda r, x: jax_state(jcfg, jmodel, r, x, 1)[0],
        jax.random.PRNGKey(jcfg.seed), probe)

    # orbax restores a mismatched shape silently: compare before restoring
    for part in ("params", "batch_stats"):
        have = _shapes(saved.get(part) or {})
        want = _shapes(getattr(template, part))
        if have != want:
            _refuse_mismatch(model, {"params": saved.get("params") or {},
                                     "batch_stats": saved.get("batch_stats")
                                     or {}}, want)
    restored, next_epoch = jax_ckpt.load_checkpoint(jcfg.resume, template)

    to_np = lambda tree: jax.tree_util.tree_map(np.asarray, tree)  # noqa: E731
    variables = {"params": to_np(restored.params)}
    if jax.tree_util.tree_leaves(restored.batch_stats):
        variables["batch_stats"] = to_np(restored.batch_stats)
    model.load_state_dict(state_dict_from_jax(variables), strict=True)

    opt = restored.opt_state
    load_adamw_state_from_optax(state.optimizer, model,
                                *_moments(opt, restored.params, jcfg.resume))

    state.step = int(restored.step)
    state.updates, state.accum = state.step, []
    multi = _find(opt, ("mini_step", "gradient_step", "acc_grads"))
    if multi is not None:
        state.updates = int(multi.gradient_step)
        mini, k = int(multi.mini_step), max(cfg.grad_accum_steps, 1)
        if mini != state.step % k:
            raise ValueError(f"{jcfg.resume}: MultiSteps is {mini} micro-steps "
                             f"into an accumulation of {k}, step {state.step} "
                             "says otherwise")
        if mini:
            acc = state_dict_from_jax(to_np(multi.acc_grads))
            names = {p: n for n, p in model.named_parameters()}
            state.accum = [acc[names[p]] * mini
                           for g in state.optimizer.param_groups
                           for p in g["params"]]

    out = os.path.abspath(out)
    os.makedirs(os.path.dirname(out), exist_ok=True)
    path = ckpt.save_checkpoint(os.path.dirname(out),
                                os.path.basename(out)[:-len(".pth")], state,
                                next_epoch - 1)
    print(f"{jcfg.resume} (epoch {next_epoch - 1}, step {state.step}, "
          f"{state.updates} updates) -> {path}")
    return path


def main(argv: Optional[list] = None) -> int:
    convert(sys.argv[1:] if argv is None else argv)
    return 0


if __name__ == "__main__":
    sys.exit(main())
