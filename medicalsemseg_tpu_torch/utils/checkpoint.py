"""Training checkpoints with the reference's best / periodic / clean-up
policy (counterpart of medicalsemseg_tpu/utils/checkpoint.py).

One ``torch.save`` file ``<output_dir>/<name>.pth`` holds
``{'model': state_dict, 'optimizer': state_dict, 'epoch', 'step', 'updates',
'generator'}``: the reference's ``.pth`` layout (``'model'`` first), so
``utils.params.load_checkpoint`` and ``cli/run_test.py --resume`` read it as
they read a reference checkpoint. The LR schedule is a pure function of the
update count and has no state; bf16 needs no loss scaler.
"""

from __future__ import annotations

import os
from typing import List, Tuple

import torch

from medicalsemseg_tpu_torch.train.state import TrainState
from medicalsemseg_tpu_torch.utils import params


def save_checkpoint(output_dir: str, name: str, state: TrainState,
                    epoch: int) -> str:
    """Save state and epoch as output_dir/name.pth (overwrites, atomically)."""
    path = os.path.abspath(os.path.join(output_dir, f"{name}.pth"))
    payload = {
        "model": state.model.state_dict(),
        "optimizer": state.optimizer.state_dict(),
        "epoch": int(epoch),
        "step": int(state.step),
        "updates": int(state.updates),
        "generator": state.generator.get_state(),
        "accum": list(state.accum),
    }
    tmp = path + ".tmp"
    torch.save(payload, tmp)
    os.replace(tmp, path)
    return path


def load_checkpoint(path: str, state: TrainState) -> Tuple[TrainState, int]:
    """Restore everything into ``state`` in place; returns (state, next
    epoch), the resume semantics of the reference's load_model."""
    device = next(state.model.parameters()).device
    # tensors and plain containers only: nothing in the file is executed
    payload = torch.load(path, map_location=device, weights_only=True)
    state.model.load_state_dict(
        params.strip_module_prefix(payload["model"]), strict=True)
    state.optimizer.load_state_dict(payload["optimizer"])
    state.step, state.updates = int(payload["step"]), int(payload["updates"])
    state.generator.set_state(payload["generator"].cpu())
    state.accum = [a.to(device) for a in payload.get("accum", [])]
    return state, int(payload["epoch"]) + 1


def load_params_only(path: str, state: TrainState) -> TrainState:
    """Evaluation restore: the model's parameters only."""
    state.model.load_state_dict(params.load_checkpoint(path), strict=True)
    return state


def cleanup_checkpoints(checkpoint_paths: List[str]) -> None:
    """Delete all but the newest periodic checkpoint."""
    for p in checkpoint_paths[:-1]:
        try:
            os.remove(p)
            print(f"Removed old checkpoint {p} successfully!")
        except OSError as e:
            print(f"Could not remove {p}: {e}")
