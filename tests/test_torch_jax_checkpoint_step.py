"""A JAX training run resumed in the port: three micro-steps of the JAX
package's jitted train step (``--grad_accum_steps 2`` with gradient
clipping: one update and one pending gradient), saved by its
``save_checkpoint``, converted by ``tools/jax_checkpoint_to_torch.py``; then
one more micro-step on the same batch in each package must agree within the
train-step tolerance (``tests/test_torch_train_step.py``), and the port's
training CLI resumes the converted file at the next epoch and its prediction
CLI reads it. A two-stage flagship at roi 16 in fp32 on the CPU, the port's
kernels as their plain versions.
"""

import os

import numpy as np

import jax
import jax.numpy as jnp
import torch
from flax.core import FrozenDict

from medicalsemseg_tpu.config import get_args as jax_get_args
from medicalsemseg_tpu.train.state import (TrainState, make_optimizer,
                                           make_train_step as jax_train_step)
from medicalsemseg_tpu.utils import checkpoint as jax_ckpt

from medicalsemseg_tpu_torch.cli import run_test, run_training
from medicalsemseg_tpu_torch.config import get_args
from medicalsemseg_tpu_torch.models.factory import build_model
from medicalsemseg_tpu_torch.train.state import (create_train_state,
                                                 make_train_step)
from medicalsemseg_tpu_torch.utils import checkpoint as ckpt
from medicalsemseg_tpu_torch.utils.params import jax_tree_from_state_dict

from tests import test_torch_run_test, test_torch_run_training
from tests.test_torch_jax_checkpoint import tool
from tests.test_torch_model import jax_params
from tests.test_torch_train_step import _assert_params, _batches, _flat, _tb

torch.backends.cudnn.allow_tf32 = False
torch.backends.cuda.matmul.allow_tf32 = False

STEPS_PER_EPOCH = 2
LR = 1e-3
# the model and optimizer flags of the run, as the training CLI's test sets
# them (tests/test_torch_run_training.py)
RUN = ["--model", "nnFormerUNETR", "--vol_size", "16", "--patch_size", "2",
       "--hidden_dim", "12", "--depths", "1", "1", "--num_heads", "2", "2",
       "--window_size", "2", "--output_dim", "3", "--compute_dtype",
       "float32", "--qkv_bias", "--warmup_epochs", "0", "--epochs", "2",
       "--lr", str(LR), "--weight_decay", "1e-2", "--gradient_clipping",
       "1.0", "--grad_accum_steps", "2", "--n_images_per_batch", "2",
       "--drop_path_rate", "0", "--remat", "none"]


def test_jax_run_resumes_in_the_port(tmp_path):
    jcfg = jax_get_args(RUN)
    jmodel, params = jax_params(jcfg, seed=5)
    tx, _ = make_optimizer(jcfg, STEPS_PER_EPOCH)
    state = TrainState(step=jnp.zeros((), jnp.int32), params=params,
                       batch_stats=FrozenDict(), opt_state=tx.init(params),
                       apply_fn=jmodel.apply, tx=tx)
    step = jax.jit(jax_train_step(jcfg))
    batches = _batches(jcfg, 4, seed=9)
    for i, b in enumerate(batches[:3]):
        state, _ = step(state, {k: jnp.asarray(v) for k, v in b.items()},
                        jax.random.PRNGKey(i))
    assert int(state.step) == 3 and int(state.opt_state.gradient_step) == 1
    jax_ckpt.save_checkpoint(str(tmp_path), "checkpoint-0", state, 0)
    out = str(tmp_path / "checkpoint-0.pth")
    tool().convert(RUN + ["--resume", str(tmp_path / "checkpoint-0"),
                          "--out", out])

    # the fourth micro-step (the second update) in each package
    cfg = get_args(RUN + ["--device", "cpu"])
    port = create_train_state(cfg, build_model(cfg), STEPS_PER_EPOCH)
    port, next_epoch = ckpt.load_checkpoint(out, port)
    assert (next_epoch, port.step, port.updates, len(port.accum)) == (
        1, 3, 1, len(list(port.model.parameters())))
    want_state, want = step(state, {k: jnp.asarray(v)
                                    for k, v in batches[3].items()},
                            jax.random.PRNGKey(3))
    got = make_train_step(cfg)(port, _tb(batches[3]))
    assert (port.step, port.updates, port.accum) == (4, 2, [])
    np.testing.assert_allclose(float(got["loss"]), float(want["loss"]),
                               rtol=1e-4)
    _assert_params(_flat(jax_tree_from_state_dict(port.model.state_dict(),
                                                  params)),
                   _flat(want_state.params), LR, "after the resume")

    # the training CLI goes on at epoch 1 from the converted file; the
    # prediction CLI reads it
    data = tmp_path / "data"
    data.mkdir()
    test_torch_run_training._write_train_set(data)
    run_out = str(tmp_path / "run")
    os.makedirs(run_out)
    argv = test_torch_run_training.ARGV + RUN[RUN.index("--qkv_bias"):] + [
        "--data_path", str(data), "--output_dir", run_out, "--log_dir",
        str(tmp_path / "log")]
    run_training.main(get_args(argv + ["--resume", out]))
    assert [r["epoch"] for r in test_torch_run_training._log(run_out)] == [1]
    resumed = torch.load(os.path.join(run_out, "checkpoint-1.pth"),
                         weights_only=True)
    # epoch 1: two micro-steps, one update at the first (the pending one)
    assert (resumed["epoch"], resumed["step"], resumed["updates"]) == (1, 5, 2)

    test_torch_run_test._write_test_set(data)
    records = run_test.main(get_args(
        test_torch_run_test.ARGV + ["--data_path", str(data), "--output_dir",
                                    str(tmp_path / "pred"), "--device",
                                    "cpu", "--resume", out]))
    assert len(records) == 2
