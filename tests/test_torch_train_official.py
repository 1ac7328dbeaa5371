"""Training of the MONAI-block models (VideoSwinUNETR, SwinUNETR_Official)
in the port against the JAX package on the CPU.

One jitted JAX step of a small VideoSwinUNETR (vol 32, hidden 12, depths
2-2-1-1, heads 2-2-2-2, window 2, 3 classes, drop path 0, fp32, with
``--abs_pos_emb``): the loss within 1e-4, every gradient leaf within 2e-2 of
its norm and all together within 5e-3 (``assert_train_step_matches``). In
training the JAX blocks run XLA and the port's blocks their plain PyTorch
(no kernel: K1 and K2 serve these blocks at inference only, with
SwinUNETR_Official's gate on). The training CLI trains both models,
checkpoints and resumes (SwinUNETR_Official with the gate on: validation
runs the fused blocks, training the plain ones).
"""

import numpy as np
import pytest
import torch

from medicalsemseg_tpu_torch.ops.kernels import mlp as kmlp
from medicalsemseg_tpu_torch.ops.kernels import window_attention as kwa

from tests.test_torch_model import (
    assert_train_step_matches,
    small_cfg,
    train_step_both,
)
from tests.test_torch_run_training import train_and_resume

torch.backends.cudnn.allow_tf32 = False
torch.backends.cuda.matmul.allow_tf32 = False


@pytest.fixture(scope="module")
def both():
    cfg = small_cfg(model="VideoSwinUNETR", depths=(2, 2, 1, 1),
                    drop_path_rate=0.0, abs_pos_emb=True)
    return train_step_both(cfg, seed=61)


def test_loss_and_every_gradient_match_jax(both):
    assert_train_step_matches(both)
    grads = both["port"][1]["encoder"]
    assert np.abs(grads["absolute_pos_embed"]).max() > 0
    assert np.abs(grads["layers_3_blocks_0"]["attn"][
        "relative_position_bias_table"]).max() > 0


@pytest.mark.parametrize("name,gate", [
    ("VideoSwinUNETR", None), ("SwinUNETR_Official", "1"),
    ("SwinUNETR_Official", "0")])
def test_blocks_take_the_kernels_at_inference_only(monkeypatch, name, gate):
    """A training forward and backward calls no kernel wrapper; a forward
    in eval mode without gradients calls K1 and K2 in every block where the
    kernels are on (VideoSwinUNETR; SwinUNETR_Official under the gate) and
    none where they are off; in eval mode with gradients a fused block
    raises."""
    from medicalsemseg_tpu_torch.models.factory import build_model, init_weights

    if gate is not None:
        monkeypatch.setenv("MEDSEG_OFFICIAL_FUSED", gate)
    calls = {"k1": 0, "k2": 0, "bwd": 0}

    def spy(mod, fn_name, key):
        fn = getattr(mod, fn_name)

        def wrapped(*a, **k):
            calls[key] += 1
            return fn(*a, **k)
        monkeypatch.setattr(mod, fn_name, wrapped)

    spy(kwa, "window_attention", "k1")
    spy(kmlp, "fused_mlp", "k2")
    spy(kwa, "window_attention_bwd", "bwd")
    spy(kmlp, "fused_mlp_bwd", "bwd")
    cfg = small_cfg(model=name, hidden_dim=8, depths=(1, 1, 1, 1))
    model = init_weights(build_model(cfg), torch.Generator().manual_seed(0))
    x_in = (torch.randn(1, 32, 32, 32, 1), None, None)
    model.train()(x_in).sum().backward()
    assert calls == {"k1": 0, "k2": 0, "bwd": 0}
    with torch.inference_mode():
        model.eval()(x_in)
    fused = gate != "0"
    assert calls == {"k1": 4 * fused, "k2": 4 * fused, "bwd": 0}
    if fused:
        with pytest.raises(NotImplementedError, match="no backward kernel"):
            model(x_in)


@pytest.mark.parametrize("name,extra", [
    # three stages at roi 16: Video-Swin merges after every stage, and
    # needs an even grid there (8, 4, 2)
    ("VideoSwinUNETR", ["--abs_pos_emb", "--depths", "1", "1", "1",
                        "--num_heads", "2", "2", "2"]),
    # MONAI's decoder takes four stages and a roi divisible by 32 (grids
    # 16, 8, 4, 2, 1)
    ("SwinUNETR_Official", ["--vol_size", "32", "--depths", "1", "1", "1",
                            "1", "--num_heads", "2", "2", "2", "2"])],
    ids=["video_swin", "swin_unetr_official"])
def test_cli_trains_checkpoints_and_resumes(tmp_path, monkeypatch, name,
                                            extra):
    monkeypatch.setenv("MEDSEG_OFFICIAL_FUSED", "1")
    train_and_resume(tmp_path, ["--model", name, "--hidden_dim", "8"] + extra)
