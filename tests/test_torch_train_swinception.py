"""Training of the port's SwInception against the JAX model on the CPU.

A small model (vol 32, C = 12, depths 2-2-1-1, heads 2-2-2-2, window 2, 3
classes, drop path 0) gets JAX variables filled from a seeded numpy
generator, the running statistics of its 66 inception BatchNorms (11 in each
of 6 blocks) included, and the same batch on both sides, in fp32: loss,
every gradient and every BatchNorm statistic after one step against one
jitted JAX step. The CLI trains the model for a few steps, checkpoints and
resumes.
"""

import pytest
import torch

from tests.test_torch_model import (
    assert_train_step_matches,
    small_cfg,
    train_step_both,
)
from tests.test_torch_run_training import train_and_resume

torch.backends.cudnn.allow_tf32 = False
torch.backends.cuda.matmul.allow_tf32 = False

CFG = dict(model="SwInception", depths=(2, 2, 1, 1), drop_path_rate=0.0,
           qkv_bias=True)
# At C = 12 the inception bottleneck is one channel (12 // 8), and the
# gradients of its BatchNorms' scale and bias sit at 3e-6 of the whole
# gradient's norm; there the sum orders of XLA's and oneDNN's convs differ by
# ~1e-7 absolute, the same absolute error as the leaves around them (a leaf
# of 2.4e-6 was 2.1e-2 off, 5e-8 absolute). Leaves under 1e-5 of the whole
# are held to that absolute floor instead of to 2e-2 of their own norm.
LEAF_FLOOR = 1e-5


@pytest.fixture(scope="module")
def both():
    return train_step_both(small_cfg(**CFG), seed=33)


def test_loss_every_gradient_and_statistic_match_jax(both):
    assert_train_step_matches(both, leaf_floor=LEAF_FLOOR)


def test_every_inception_batchnorm_moved(both):
    """66 BatchNorms, each with its running statistics moved by the step."""
    moved = 0
    start = both["stats0"]["encoder"]
    for i, layer in both["port"][2]["encoder"].items():
        for j, blk in layer.items():
            for name, bc in blk["InceptionMlp_0"].items():
                got = bc["BatchNorm_0"]["BatchNorm_0"]["var"]
                was = (start[i][j]["InceptionMlp_0"][name]["BatchNorm_0"]
                       ["BatchNorm_0"]["var"])
                assert abs(got - was).max() > 0, (i, j, name)
                moved += 1
    assert moved == 66


def test_cli_trains_checkpoints_and_resumes(tmp_path):
    first, _ = train_and_resume(tmp_path, ["--model", "SwInception"])
    assert any(".mlp.convs.10.bn.running_var" in k for k in first["model"])
