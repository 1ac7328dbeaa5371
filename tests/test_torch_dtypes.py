"""The compute dtypes of the PyTorch port's kernels K1, K2 and K7 against the
JAX package, and the training CLI's flags that it once refused.

The JAX kernels take whatever dtype their input has and round to it
(``.astype(x_ref.dtype)``), so the JAX package runs ``--compute_dtype
float32`` and ``float16`` (``--mixed_precision``) through them. The port's
wrappers do the same; on the CPU they take their plain versions, which are
held here against the Pallas kernels in interpret mode, in fp32 and in fp16,
on the same numpy inputs (weights fp32 on both sides, cast inside).
"""

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from medicalsemseg_tpu.ops.pallas.mlp import fused_mlp as jax_fused_mlp
from medicalsemseg_tpu.ops.pallas.sr_attention import fused_sr_attention
from medicalsemseg_tpu.ops.pallas.window_attention import fused_window_attention

from medicalsemseg_tpu_torch.cli import run_training
from medicalsemseg_tpu_torch.config import get_args
from medicalsemseg_tpu_torch.ops import window as tw
from medicalsemseg_tpu_torch.ops.kernels import mlp as kmlp
from medicalsemseg_tpu_torch.ops.kernels import sr_attention as ksr
from medicalsemseg_tpu_torch.ops.kernels import window_attention as kwa

# fp32: sums in other orders, a few fp32 ulps of O(1) values (the tolerance
# of the fp32 suites of these kernels). fp16: both sides round to fp16 at the
# same points, so a differently ordered fp32 sum can flip one rounding, and a
# flip moves an O(1) output by an fp16 ulp (2^-10 relative) or two.
TOL = {"float32": 3e-5, "float16": 4e-3}
DTYPES = {"float32": (torch.float32, jnp.float32),
          "float16": (torch.float16, jnp.float16)}


def _rng(seed):
    return np.random.default_rng(seed)


def _close(got, want, dtype):
    tol = TOL[dtype]
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, dtype=np.float32),
                               rtol=tol, atol=tol)


@pytest.mark.parametrize("dtype", ["float32", "float16"])
def test_window_attention_dtypes(dtype):
    """K1's plain version, shifted, LN and shortcut absorbed, C = 16."""
    td, jd = DTYPES[dtype]
    ws, ss, c, nh = 2, 1, 16, 2
    dims = (2 * ws, 2 * ws, 2 * ws)
    rng = _rng(61)
    x = rng.normal(size=(2, *dims, c)).astype(np.float32)
    wqkv = rng.normal(size=(c, 3 * c)).astype(np.float32) * 0.2
    bqkv = rng.normal(size=(3 * c,)).astype(np.float32) * 0.1
    wproj = rng.normal(size=(c, c)).astype(np.float32) * 0.2
    bproj = rng.normal(size=(c,)).astype(np.float32) * 0.1
    table = rng.normal(size=((2 * ws - 1) ** 3, nh)).astype(np.float32)
    ln = np.stack([rng.normal(size=(c,)) * 0.3 + 1.0,
                   rng.normal(size=(c,)) * 0.1]).astype(np.float32)
    want = fused_window_attention(
        jnp.asarray(x, jd), jnp.asarray(wqkv), jnp.asarray(bqkv),
        jnp.asarray(wproj), jnp.asarray(bproj), jnp.asarray(table), ws, nh,
        shift_size=ss, interpret=True, ln_scale=jnp.asarray(ln[0]),
        ln_bias=jnp.asarray(ln[1]), residual=True)
    n = ws ** 3
    idx = torch.from_numpy(tw.relative_position_index((ws,) * 3)
                           .astype(np.int64)).reshape(-1)
    bias = torch.from_numpy(table)[idx].reshape(n, n, nh).permute(2, 0, 1)
    out = kwa.window_attention(
        tw.window_partition(torch.from_numpy(x).to(td), ws),
        torch.from_numpy(wqkv).t(), torch.from_numpy(bqkv),
        torch.from_numpy(wproj).t(), torch.from_numpy(bproj),
        bias.contiguous(), grid_dims=(2, 2, 2), window=(ws,) * 3,
        shift=(ss,) * 3, ln=torch.from_numpy(ln), residual=True)
    assert out.dtype == td
    _close(tw.window_reverse(out, ws, dims), want, dtype)


@pytest.mark.parametrize("dtype", ["float32", "float16"])
def test_mlp_dtypes(dtype):
    """K2's plain version, LN and shortcut absorbed, C = 24, hidden 4C, a
    token count that is no multiple of a tile."""
    td, jd = DTYPES[dtype]
    m, c, hdim = 45, 24, 96
    rng = _rng(62)
    x = rng.normal(size=(m, c)).astype(np.float32)
    w1 = rng.normal(size=(c, hdim)).astype(np.float32) * 0.2
    b1 = rng.normal(size=(hdim,)).astype(np.float32) * 0.1
    w2 = rng.normal(size=(hdim, c)).astype(np.float32) * 0.1
    b2 = rng.normal(size=(c,)).astype(np.float32) * 0.1
    ln = np.stack([rng.normal(size=(c,)) * 0.3 + 1.0,
                   rng.normal(size=(c,)) * 0.1]).astype(np.float32)
    want = jax_fused_mlp(
        jnp.asarray(x, jd), jnp.asarray(w1), jnp.asarray(b1), jnp.asarray(w2),
        jnp.asarray(b2), ln_scale=jnp.asarray(ln[0]),
        ln_bias=jnp.asarray(ln[1]), residual=True, interpret=True)
    got = kmlp.fused_mlp(
        torch.from_numpy(x).to(td), torch.from_numpy(w1).t(),
        torch.from_numpy(b1), torch.from_numpy(w2).t(), torch.from_numpy(b2),
        ln=torch.from_numpy(ln), residual=True)
    assert got.dtype == td
    _close(got, want, dtype)


@pytest.mark.parametrize("dtype", ["float32", "float16"])
def test_sr_attention_dtypes(dtype):
    """K7's plain version with the q bias and the shortcut, C = 16."""
    td, jd = DTYPES[dtype]
    b, n, m, c, nh = 2, 40, 8, 16, 4
    rng = _rng(63)

    def arr(*shape, s=1.0):
        return (rng.normal(size=shape) * s).astype(np.float32)

    x, k, v, res = arr(b, n, c), arr(b, m, c), arr(b, m, c), arr(b, n, c)
    wq, wproj = arr(c, c, s=0.3), arr(c, c, s=0.3)
    bq, bproj = arr(c, s=0.1), arr(c, s=0.1)
    want = fused_sr_attention(
        jnp.asarray(x, jd), jnp.asarray(k, jd), jnp.asarray(v, jd),
        jnp.asarray(wq), jnp.asarray(bq), jnp.asarray(wproj),
        jnp.asarray(bproj), nh, residual=jnp.asarray(res, jd),
        interpret=True)
    t = lambda a: torch.from_numpy(a).to(td)  # noqa: E731
    got = ksr.sr_attention(t(x), t(k), t(v), torch.from_numpy(wq).t(),
                           torch.from_numpy(bq), torch.from_numpy(wproj).t(),
                           torch.from_numpy(bproj), nh, residual=t(res))
    assert got.dtype == td
    _close(got, want, dtype)


def test_wrappers_name_the_dtypes_they_take():
    """float64 has no kernel: the dtype check says which ones there are (it
    runs before any launch, so a CPU-free check of the message is enough)."""
    from medicalsemseg_tpu_torch.ops import kernels

    assert [kernels.dtype_code("x", d) for d in
            (torch.bfloat16, torch.float16, torch.float32)] == [0, 1, 2]
    with pytest.raises(ValueError, match="bfloat16, float16 or float32"):
        kernels.dtype_code("x", torch.float64)


# the ids the cases had while the training CLI refused these flags, kept
@pytest.mark.parametrize("flag", [["--remat", "full"], ["--remat", "mixed"]],
                         ids=["flag2-ROADMAP 'Do not port'",
                              "flag3-ROADMAP 'Do not port'"])
def test_unported_training_flags_name_their_roadmap_item(flag):
    """``--remat full`` and ``--remat mixed``, refused until the port had
    block rematerialisation, in the CLIs' default compute dtype (bf16): the
    model the flags build takes a training-mode forward and backward (drop
    path 0.2, the train state's generator) whose loss, gradients and
    generator state equal ``--no_remat``'s bit for bit."""
    from medicalsemseg_tpu_torch.models.factory import build_model, init_weights
    from medicalsemseg_tpu_torch.train.losses import build_loss
    from medicalsemseg_tpu_torch.train.state import create_train_state

    small = ["--device", "cpu", "--vol_size", "16", "--hidden_dim", "12",
             "--depths", "1", "1", "--num_heads", "2", "2", "--window_size",
             "2", "--output_dim", "3", "--drop_path_rate", "0.2"]
    g = torch.Generator().manual_seed(2)
    x = torch.randn(2, 16, 16, 16, 1, generator=g)
    y = torch.randint(0, 3, (2, 16, 16, 16), generator=g)
    runs = []
    for argv in (small + ["--no_remat"], small + flag):
        cfg = get_args(argv)
        model = build_model(cfg)
        init_weights(model, torch.Generator().manual_seed(0))
        state = create_train_state(cfg, model, 1)
        model.train()
        loss = build_loss(cfg)(model((x, None, None)), y)
        grads = torch.autograd.grad(loss, list(model.parameters()),
                                    allow_unused=True)
        runs.append((cfg.remat, loss.detach(), grads,
                     state.generator.get_state()))
    (m0, l0, g0, s0), (m1, l1, g1, s1) = runs
    assert (m0, m1) == ("none", flag[1])
    assert torch.equal(l1, l0) and torch.equal(s1, s0)
    for a, b in zip(g1, g0):
        assert (a is None and b is None) or torch.equal(a, b)


@pytest.mark.parametrize("flag", [["--device_data_pipeline"],
                                  ["--profile_dir", "p"]])
def test_ported_training_flags_pass_the_check(tmp_path, flag):
    """``--device_data_pipeline`` and ``--profile_dir`` have their paths
    now (their runs: ``test_torch_run_training.py``,
    ``test_torch_profiling.py``): the CLI takes them and goes on to the
    data, here a folder with no datalist."""
    with pytest.raises(FileNotFoundError, match="dataset.json"):
        run_training.main(get_args(["--device", "cpu", "--data_path",
                                    str(tmp_path)] + flag))
