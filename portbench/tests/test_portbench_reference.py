"""The plain reference against the port's plain path on the CPU (fp32, crops
of 32^3, hidden 12): both models' forward, and three training steps with
DropPath drawn from the same seed; the reference standing alone."""

from __future__ import annotations

import subprocess
import sys

import pytest
import torch

from portbench.reference import nnformer_unetr, swin_unetr
from portbench.reference import train as rtrain
from portbench.tests.conftest import ROOT

MODELS = [("nnFormerUNETR", nnformer_unetr, 6),
          ("SwinUNETR_Official", swin_unetr, 7)]


def _port(name):
    from medicalsemseg_tpu_torch.config import get_args
    from medicalsemseg_tpu_torch.models.factory import build_model, init_weights

    cfg = get_args(["--model", name, "--vol_size", "32", "--hidden_dim", "12",
                    "--output_dim", "5", "--compute_dtype", "float32",
                    "--device", "cpu", "--warmup_epochs", "0",
                    "--drop_path_rate", "0.2"])
    model = build_model(cfg)
    init_weights(model, torch.Generator().manual_seed(0))
    return cfg, model


def _flags(window):
    return dict(vol_size=32, patch_size=2, depths=[2, 2, 2, 2],
                num_heads=[3, 6, 12, 24], window_size=window, hidden_dim=12,
                drop_path_rate=0.2, weight_decay=1e-5, smooth_nr=1e-5,
                smooth_dr=1e-5, lr=4e-4, warmup_epochs=0, epochs=200)


@pytest.mark.parametrize("name,mod,window", MODELS)
def test_forward_matches_port(name, mod, window):
    torch.manual_seed(0)
    _, model = _port(name)
    model.eval()
    P = {k: v.float() for k, v in model.state_dict().items()}
    x = torch.randn(2, 32, 32, 32, 1)
    with torch.no_grad():
        want = model((x, None, None))
        got = mod.forward(P, _flags(window), x)
    assert got.shape == want.shape
    assert float((got - want).abs().max()) <= 1e-4 * float(want.abs().max())


@pytest.mark.parametrize("name,mod,window", MODELS)
def test_training_steps_match_port(name, mod, window):
    from medicalsemseg_tpu_torch.train.state import (create_train_state,
                                                     make_train_step)

    cfg, model = _port(name)
    P0 = {k: v.detach().clone().float() for k, v in model.state_dict().items()}
    state = create_train_state(cfg, model, 4, seed=123)
    step = make_train_step(cfg)
    g = torch.Generator().manual_seed(5)
    batches = [{"image": torch.randn(2, 32, 32, 32, 1, generator=g),
                "label": torch.randint(0, 5, (2, 32, 32, 32), generator=g,
                                       dtype=torch.int32),
                "crop_loc": torch.rand(2, 3, generator=g),
                "affine": torch.ones(2, 3)} for _ in range(3)]
    losses = [float(step(state, b)["loss"]) for b in batches]
    flags = _flags(window)
    gen = torch.Generator().manual_seed(123)
    masks = [mod.draw_masks(flags, 2, gen, "cpu") for _ in batches]
    lrs = [rtrain.lr_at(i, flags, 4) for i in range(3)]
    assert lrs == [state.schedule(i) for i in range(3)]
    ref = rtrain.train_steps(lambda p, v, m: mod.forward(p, flags, v, m), P0,
                             batches, masks, lrs, flags)
    for a, b in zip(losses, ref["losses"]):
        assert abs(a - b) <= 1e-5 * abs(b)
    # parameters after three steps, leaf by leaf, against the median leaf's
    # change (AdamW turns round-off of a near-zero gradient into a full step)
    delta = {n: p.detach() - P0[n] for n, p in model.named_parameters()}
    ref_delta = {n: ref["params"][n] - P0[n] for n in delta}
    med = torch.stack([v.norm() for v in ref_delta.values()]).median()
    worst = max(float((delta[n] - ref_delta[n]).norm() / max(
        ref_delta[n].norm(), med)) for n in delta)
    assert worst < 0.05


def test_state_dict_is_all_parameters():
    """The reference's weights are the program's state_dict, every leaf a
    parameter (no buffer the benchmark would have to make)."""
    for name, _, _ in MODELS:
        _, model = _port(name)
        assert set(model.state_dict()) == {n for n, _ in
                                           model.named_parameters()}


def test_reference_stands_alone():
    code = (
        "import sys; sys.path.insert(0, %r)\n"
        "import portbench.reference.nnformer_unetr, "
        "portbench.reference.swin_unetr, portbench.reference.train, "
        "portbench.reference.sliding_window, portbench.reference.precision\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'flax', 'medicalsemseg_tpu', "
        "'medicalsemseg_tpu_torch')]\n"
        "print(bad); sys.exit(1 if bad else 0)\n" % ROOT)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr
