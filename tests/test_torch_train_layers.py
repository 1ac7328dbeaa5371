"""The training layers of the model zoo on the CPU: BatchNorm with batch
statistics against flax's ``nn.BatchNorm`` (as the JAX ``layers.BatchNorm``
builds it), and DropPath and Dropout: their keep fraction, their 1 / keep
scaling and their determinism under the train state's generator."""

import numpy as np
import pytest
import torch

from medicalsemseg_tpu_torch.models.layers import (
    BatchNorm,
    Dropout,
    DropPath,
    drop_path,
    dropout,
)


@pytest.mark.parametrize("eps,dtype", [(1e-3, torch.float32),
                                       (1e-5, torch.bfloat16)])
def test_batch_norm_matches_flax_over_micro_steps(eps, dtype):
    """Three training applies (the micro-steps of --grad_accum_steps 3), then
    an eval one: outputs and running statistics as flax's, momentum 0.9, the
    running variance biased."""
    import jax
    import jax.numpy as jnp

    from medicalsemseg_tpu.models.layers import BatchNorm as JaxBatchNorm

    jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    rng = np.random.default_rng(0)
    xs = [(rng.normal(size=(2, 3, 4, 5, 6)) * 2 + 1).astype(np.float32)
          for _ in range(4)]
    mod = JaxBatchNorm(use_running_average=None, epsilon=eps, dtype=jdt)
    variables = mod.init(jax.random.PRNGKey(0), jnp.asarray(xs[0]),
                         use_running_average=True)
    variables = {"params": {"BatchNorm_0": {
        "scale": jnp.asarray(rng.normal(size=6) * 0.1 + 1, jnp.float32),
        "bias": jnp.asarray(rng.normal(size=6) * 0.1, jnp.float32)}},
        "batch_stats": variables["batch_stats"]}
    bn = BatchNorm(6, eps=eps)
    with torch.no_grad():
        bn.weight.copy_(torch.tensor(
            np.asarray(variables["params"]["BatchNorm_0"]["scale"])))
        bn.bias.copy_(torch.tensor(
            np.asarray(variables["params"]["BatchNorm_0"]["bias"])))
    bn.train()
    for x in xs[:3]:
        want, mutated = mod.apply(variables, jnp.asarray(x, jdt),
                                  use_running_average=False,
                                  mutable=["batch_stats"])
        variables = {"params": variables["params"], **mutated}
        got = bn(torch.from_numpy(x).to(dtype))
        assert got.dtype == dtype
        np.testing.assert_allclose(got.detach().float().numpy(),
                                   np.asarray(want, np.float32),
                                   rtol=1e-2 if dtype != torch.float32
                                   else 1e-5, atol=1e-5)
        stats = variables["batch_stats"]["BatchNorm_0"]
        np.testing.assert_allclose(bn.running_mean.numpy(),
                                   np.asarray(stats["mean"]), rtol=1e-5,
                                   atol=1e-6)
        np.testing.assert_allclose(bn.running_var.numpy(),
                                   np.asarray(stats["var"]), rtol=1e-5)
    # the biased variance: torch.nn.BatchNorm3d would differ by n / (n - 1)
    assert not np.allclose(bn.running_var.numpy(), 1.0)
    want = mod.apply(variables, jnp.asarray(xs[3], jdt),
                     use_running_average=True)
    bn.eval()
    before = bn.running_mean.clone()
    got = bn(torch.from_numpy(xs[3]).to(dtype))
    assert torch.equal(before, bn.running_mean)
    np.testing.assert_allclose(got.detach().float().numpy(),
                               np.asarray(want, np.float32),
                               rtol=1e-2 if dtype != torch.float32 else 1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("rate", [0.1, 0.3])
def test_dropout_keep_fraction_scaling_and_determinism(rate):
    x = torch.full((64, 64, 64), 2.0)
    g = torch.Generator().manual_seed(7)
    layer = Dropout(rate)
    layer.generator = g
    y = layer.train()(x)
    kept = y != 0
    keep = 1.0 - rate
    # binomial: 262,144 draws, five standard deviations
    sd = (keep * rate / kept.numel()) ** 0.5
    assert abs(kept.float().mean().item() - keep) < 5 * sd
    assert torch.allclose(y[kept], torch.tensor(2.0 / keep))
    g.manual_seed(7)
    assert torch.equal(layer(x), y)              # the same draws again
    assert not torch.equal(layer(x), y)          # and then new ones
    assert torch.equal(layer.eval()(x), x)       # identity in eval mode
    assert dropout(x, 0.0, True) is x


def test_dropout_keeps_the_dtype_and_scales_in_it():
    x = torch.randn(4096, dtype=torch.bfloat16)
    y = dropout(x, 0.1, True, torch.Generator().manual_seed(0))
    assert y.dtype == torch.bfloat16
    kept = y != 0
    assert torch.equal(y[kept], (x / 0.9)[kept])


@pytest.mark.parametrize("rate", [0.2, 0.5])
def test_drop_path_keep_fraction_scaling_and_determinism(rate):
    """Per sample: a sample is kept whole, scaled by 1 / keep, or zeroed."""
    x = torch.ones(20000, 3, 4)
    g = torch.Generator().manual_seed(3)
    layer = DropPath(rate)
    layer.generator = g
    y = layer.train()(x)
    per_sample = y.reshape(20000, -1)
    kept = per_sample[:, 0] != 0
    keep = 1.0 - rate
    assert torch.all(per_sample[kept] == 1.0 / keep)
    assert torch.all(per_sample[~kept] == 0)
    sd = (keep * rate / 20000) ** 0.5
    assert abs(kept.float().mean().item() - keep) < 5 * sd
    g.manual_seed(3)
    assert torch.equal(layer(x), y)
    assert torch.equal(layer.eval()(x), x)
    assert drop_path(x, 0.0, True) is x


def test_train_state_hands_its_generator_to_every_draw():
    """create_train_state gives every DropPath and Dropout the state's
    generator, seeded from --seed: two states of one seed draw alike."""
    from medicalsemseg_tpu_torch.models.factory import build_model
    from medicalsemseg_tpu_torch.train.state import create_train_state

    from tests.test_torch_model import small_cfg

    cfg = small_cfg(model="SegFormer3D", drop_path_rate=0.2)
    draws = []
    for _ in range(2):
        model = build_model(cfg)
        state = create_train_state(cfg, model, 2)
        layers = [m for m in model.modules()
                  if isinstance(m, (DropPath, Dropout))]
        assert len(layers) == sum(cfg.depths) + 1
        assert all(m.generator is state.generator for m in layers)
        head = model.dropout.train()
        draws.append(head(torch.ones(1000)))
    assert torch.equal(draws[0], draws[1])


def test_batch_norm_state_decays_nothing_and_round_trips(tmp_path):
    """BatchNorm's scale and bias are 1-D: the weight-decay mask leaves
    them out, as the JAX ``weight_decay_mask`` does; its running statistics
    are buffers, outside the optimizer, saved in the checkpoint and
    restored by a resume."""
    from medicalsemseg_tpu_torch.models.factory import build_model, init_weights
    from medicalsemseg_tpu_torch.train.state import (create_train_state,
                                                     weight_decay_mask)
    from medicalsemseg_tpu_torch.utils import checkpoint as ckpt

    from tests.test_torch_model import small_cfg

    cfg = small_cfg(model="SegFormer3D")

    def state():
        model = init_weights(build_model(cfg),
                             torch.Generator().manual_seed(0))
        return create_train_state(cfg, model, 2)

    first = state()
    mask = weight_decay_mask(first.model)
    bn = [n for n, m in first.model.named_modules() if isinstance(m, BatchNorm)]
    assert bn and all(not mask[f"{n}.{p}"] for n in bn
                      for p in ("weight", "bias"))
    optimized = {id(p) for g in first.optimizer.param_groups
                 for p in g["params"]}
    for n in bn:
        mod = first.model.get_submodule(n)
        assert id(mod.running_mean) not in optimized
        mod.running_mean.uniform_(0, 1)
        mod.running_var.uniform_(1, 2)
    path = ckpt.save_checkpoint(str(tmp_path), "checkpoint-0", first, 0)
    second, epoch = ckpt.load_checkpoint(path, state())
    assert epoch == 1
    for n in bn:
        a, b = (s.model.get_submodule(n) for s in (first, second))
        assert torch.equal(a.running_mean, b.running_mean)
        assert torch.equal(a.running_var, b.running_var)
