"""The port's training checkpoints: save -> load -> the next step is the same
as without the round trip, and the file is what the prediction path reads."""

import numpy as np
import pytest
import torch

from medicalsemseg_tpu_torch.models.factory import build_model, init_weights
from medicalsemseg_tpu_torch.train import state as pstate
from medicalsemseg_tpu_torch.utils import checkpoint as ckpt
from medicalsemseg_tpu_torch.utils.params import load_checkpoint

from tests.test_torch_model import small_cfg


def _cfg(**kw):
    base = dict(vol_size=16, depths=(1, 1), num_heads=(2, 2),
                drop_path_rate=0.3, warmup_epochs=0, epochs=4, lr=1e-3,
                gradient_clipping=1.0)
    base.update(kw)
    return small_cfg(**base)


def _state(cfg, seed=0):
    model = init_weights(build_model(cfg), torch.Generator().manual_seed(seed))
    return pstate.create_train_state(cfg, model, steps_per_epoch=2)


def _batch(cfg, seed):
    rng = np.random.default_rng(seed)
    v = cfg.vol_size3()
    return {"image": torch.from_numpy(
                rng.normal(size=(2, *v, 1)).astype(np.float32)),
            "label": torch.from_numpy(
                rng.integers(0, 3, size=(2, *v)).astype(np.int64)),
            "crop_loc": torch.zeros(2, 3), "affine": torch.ones(2, 3)}


@pytest.mark.parametrize("accum", [1, 2])
def test_resumed_step_equals_uninterrupted_step(tmp_path, accum):
    """Three steps straight through against one or two steps, a save, a load
    into a fresh state, and the rest: parameters, moments, counters and the
    DropPath draws (live at rate 0.3) must all carry over, bit for bit."""
    cfg = _cfg(grad_accum_steps=accum)
    step = pstate.make_train_step(cfg)
    batches = [_batch(cfg, i) for i in range(3)]

    straight = _state(cfg)
    losses = [float(step(straight, b)["loss"]) for b in batches]

    first = _state(cfg)
    step(first, batches[0])
    path = ckpt.save_checkpoint(str(tmp_path), "checkpoint-0", first, epoch=0)
    assert path.endswith("checkpoint-0.pth")

    resumed = _state(cfg, seed=99)   # other weights: the load must replace them
    resumed, next_epoch = ckpt.load_checkpoint(path, resumed)
    assert next_epoch == 1 and resumed.step == 1
    assert resumed.updates == (1 if accum == 1 else 0)
    got = [float(step(resumed, b)["loss"]) for b in batches[1:]]
    assert got == losses[1:]
    for (n, a), (_, b) in zip(straight.model.state_dict().items(),
                              resumed.model.state_dict().items()):
        assert torch.equal(a, b), n
    sa = straight.optimizer.state_dict()["state"]
    sb = resumed.optimizer.state_dict()["state"]
    assert sa.keys() == sb.keys()
    for k in sa:
        for field in ("exp_avg", "exp_avg_sq", "step"):
            assert torch.equal(sa[k][field], sb[k][field]), (k, field)


def test_checkpoint_feeds_the_prediction_path(tmp_path):
    cfg = _cfg()
    state = _state(cfg)
    path = ckpt.save_checkpoint(str(tmp_path), "best_model", state, epoch=3)
    sd = load_checkpoint(path)   # what cli/run_test.py --resume calls
    model = build_model(cfg)
    model.load_state_dict(sd, strict=True)
    other = _state(cfg, seed=5)
    ckpt.load_params_only(path, other)
    for (n, a), (_, b) in zip(state.model.state_dict().items(),
                              other.model.state_dict().items()):
        assert torch.equal(a, b), n
    assert other.step == 0


def test_cleanup_keeps_the_newest(tmp_path):
    cfg = _cfg()
    state = _state(cfg)
    paths = [ckpt.save_checkpoint(str(tmp_path), f"checkpoint-{e}", state, e)
             for e in range(3)]
    ckpt.cleanup_checkpoints(paths)
    assert sorted(p.name for p in tmp_path.iterdir()) == ["checkpoint-2.pth"]
