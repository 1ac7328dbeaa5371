"""The compute dtypes of the PyTorch port's kernels K1, K2 and K7 against the
JAX package, and the training CLI's messages for flags it does not port.

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


@pytest.mark.parametrize("flag,item", [
    (["--device_data_pipeline"], "ROADMAP queue 1 item 12"),
    (["--profile_dir", "p"], "ROADMAP queue 1 item 16"),
    (["--remat", "full"], "ROADMAP 'Do not port'"),
    (["--remat", "mixed"], "ROADMAP 'Do not port'"),
])
def test_unported_training_flags_name_their_roadmap_item(flag, item):
    """The training CLI names the ROADMAP entry of each flag it refuses."""
    with pytest.raises(NotImplementedError) as err:
        run_training.main(get_args(["--device", "cpu"] + flag))
    assert item in str(err.value)
