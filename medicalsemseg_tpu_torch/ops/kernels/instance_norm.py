"""The UNETR decoder's InstanceNorm -> residual -> LeakyReLU chain: the
wrappers of kernel K11, their plain PyTorch version, the dispatcher op and
the autograd function that joins them.

K11 replaces no TPU kernel: the JAX package leaves ``InstanceNorm``
(``medicalsemseg_tpu/models/layers.py:349``) and the LeakyReLU and residual
add of its ``UnetResBlock`` to XLA's fusion, where the port ran them on the
card as about eight single fp32 library passes a norm, and as many again
through autograd's saved fp32 intermediates in the backward. For a
channels-last ``x`` (B, D, H, W, C) of bf16, fp16 or fp32, with
per-(sample, channel) fp32 statistics over the spatial axes (population
variance), one function in three forms:

  * ``lrelu(IN(x))`` (a ``UnetResBlock``'s ``norm1``),
  * ``lrelu(IN(x) + res)`` (``norm2`` and the block's input),
  * ``lrelu(IN(x) + IN'(res))`` (``norm2`` and ``norm3`` of the shortcut),

in fp32 with one rounding to x's dtype at the end (slope 0.01); and
:func:`instance_norm_stats`, the statistics alone (the fused decoder's
``norm1``, folded into kernel K9's input). The CUDA source is
``csrc/instance_norm.cu``; its header says what bounds it on the card and
how the design answers that.

A CPU tensor goes through :func:`instance_norm_act_plain`, the chain as the
JAX package computes it (the norm rounded to x's dtype, then the add and the
LeakyReLU in it); a CUDA tensor launches the kernel through
:class:`InstanceNormActFn` or raises. The forward is the dispatcher op
``medseg::instance_norm_act``, so that the selective-checkpoint policy of a
rematerialised block sees it (``models.layers``): it is not one of the
products a "conv" block keeps, so the recompute runs K11's forward again and
no output of it is kept. The backward saves only the inputs and the (B, C)
statistics.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from medicalsemseg_tpu_torch.ops import kernels
from medicalsemseg_tpu_torch.utils import profiling

SLOPE = 0.01
# threads a block (kThreads in csrc/common.cuh)
THREADS = 256
# channel vectors a group (kMaxGroup in csrc/instance_norm.cu)
MAX_GROUP = 32
# a chunk holds at least this many passes of its block's rows
MIN_PASSES = 8
# chunks of a large tensor: about this many blocks an SM
BLOCKS_PER_SM = 4


def plan(b: int, n: int, c: int, elem: int, aligned: bool,
         sms: int) -> Tuple[int, int, int]:
    """(vec, gw, chunks) of a launch over B samples of N voxels and C
    channels of ``elem`` bytes: 16-byte vectors where C fills them and every
    tensor starts on a 16-byte boundary (``aligned``), single channels
    otherwise; groups of at most :data:`MAX_GROUP` vectors, ``gw`` vectors
    each; chunks of the voxels such that a chunk holds at least
    :data:`MIN_PASSES` passes of the block's rows and the launch about
    :data:`BLOCKS_PER_SM` blocks on each of the card's ``sms``."""
    width = 16 // elem
    vec = width if aligned and c % width == 0 else 1
    vpr = c // vec
    groups = -(-vpr // MAX_GROUP)
    gw = -(-vpr // groups)
    rows = THREADS // gw
    chunks = max(1, min(n // (MIN_PASSES * rows),
                        -(-BLOCKS_PER_SM * sms // (b * groups))))
    return vec, gw, chunks


def _norm_plain(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
                eps: float) -> torch.Tensor:
    xf = x.float()
    var, mean = torch.var_mean(xf, dim=(1, 2, 3), keepdim=True,
                               correction=0)
    y = (xf - mean) * torch.rsqrt(var + eps)
    return (y * weight.float() + bias.float()).to(x.dtype)


def instance_norm_act_plain(x: torch.Tensor, weight: torch.Tensor,
                            bias: torch.Tensor,
                            res: Optional[torch.Tensor] = None,
                            res_weight: Optional[torch.Tensor] = None,
                            res_bias: Optional[torch.Tensor] = None,
                            eps: float = 1e-5) -> torch.Tensor:
    """The kernel's function in plain PyTorch, rounding where the JAX
    package does: ``lrelu(IN(x) [+ res | + IN'(res)])``, the norms in fp32
    and rounded to x's dtype, the add and the LeakyReLU in x's dtype."""
    y = _norm_plain(x, weight, bias, eps)
    if res is not None:
        y = y + (res if res_weight is None
                 else _norm_plain(res, res_weight, res_bias, eps))
    return F.leaky_relu(y, negative_slope=SLOPE)


def instance_norm_stats_plain(x: torch.Tensor, eps: float = 1e-5
                              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(mean, rstd), each (B, C) fp32, over the spatial axes of x."""
    var, mean = torch.var_mean(x.float(), dim=(1, 2, 3), correction=0)
    return mean, torch.rsqrt(var + eps)


def _form(res, res_weight) -> int:
    return 0 if res is None else (1 if res_weight is None else 2)


def _check(x, res=None, weights=()):
    if x.dim() != 5:
        raise ValueError(f"instance_norm: x has shape {tuple(x.shape)}, "
                         "expected (B, D, H, W, C)")
    kernels.dtype_code("x", x.dtype)
    kernels.check_tensor("x", x, x.device, x.dtype)
    if res is not None:
        kernels.check_tensor("res", res, x.device, x.dtype, x.shape)
    for name, w in weights:
        kernels.check_tensor(name, w, x.device, torch.float32,
                             (x.shape[-1],))


def _geometry(x):
    b, c = x.shape[0], x.shape[-1]
    return b, x.numel() // (b * c), c


def _plan_for(tensors, b, n, c):
    aligned = all(t.data_ptr() % 16 == 0 for t in tensors if t is not None)
    return plan(b, n, c, tensors[0].element_size(), aligned,
                kernels.sm_count(tensors[0].device))


def _launch_fwd(x, weight, bias, res, res_weight, res_bias, eps,
                stats_only=False):
    """Check the tensors and launch (any device: the CPU tests drive this
    path with a stand-in library); (y or None, stats (k, 2, B, C))."""
    form = _form(res, res_weight)
    ws = [] if stats_only else [("weight", weight), ("bias", bias)]
    if form == 2:
        ws += [("res_weight", res_weight), ("res_bias", res_bias)]
    _check(x, res, ws)
    b, n, c = _geometry(x)
    dev = x.device
    lib = kernels.load()
    y = None if stats_only else torch.empty_like(x)
    vec, gw, chunks = _plan_for([x, res, y], b, n, c)
    ntens = 2 if form == 2 else 1
    part = torch.empty((ntens, chunks, b, 2, c), dtype=torch.float32,
                       device=dev)
    stats = torch.empty((ntens, 2, b, c), dtype=torch.float32, device=dev)
    p = kernels.ptr
    err = lib.medseg_instance_norm_fwd(
        p(x), p(res), p(weight), p(bias), p(res_weight), p(res_bias),
        p(part), p(stats), p(y), form, b, n, c,
        kernels.dtype_code("x", x.dtype), vec, gw, chunks, float(eps),
        kernels.stream_handle(dev))
    kernels.check(lib, err, "instance_norm_fwd")
    kernels.count_launch("K11", "forward", "cuda_core")
    return y, stats


def instance_norm_act_bwd(x, res, dy, stats, weight, bias, res_weight=None,
                          res_bias=None):
    """The backward launch (any device, as :func:`_launch_fwd`) for the
    forward's inputs, its statistics and the gradient ``dy`` of its output:
    (dx, dres or None, dparams (3, C) fp32: dweight, dbias, and dres_weight
    where ``res`` was normalised; its dres_bias is dbias)."""
    form = _form(res, res_weight)
    ws = [("weight", weight), ("bias", bias)]
    if form == 2:
        ws += [("res_weight", res_weight), ("res_bias", res_bias)]
    _check(x, res, ws)
    kernels.check_tensor("dy", dy, x.device, x.dtype, x.shape)
    b, n, c = _geometry(x)
    ntens = 2 if form == 2 else 1
    kernels.check_tensor("stats", stats, x.device, torch.float32,
                         (ntens, 2, b, c))
    dev = x.device
    lib = kernels.load()
    dx = torch.empty_like(x)
    dres = None if form == 0 else torch.empty_like(res)
    vec, gw, chunks = _plan_for([x, res, dy, dx, dres], b, n, c)
    nsums = 3 if form == 2 else 2
    part = torch.empty((chunks, b, nsums, c), dtype=torch.float32, device=dev)
    sums = torch.empty((b, nsums, c), dtype=torch.float32, device=dev)
    dparams = torch.empty((3, c), dtype=torch.float32, device=dev)
    p = kernels.ptr
    err = lib.medseg_instance_norm_bwd(
        p(x), p(res), p(dy), p(stats), p(weight), p(bias), p(res_weight),
        p(res_bias), p(part), p(sums), p(dparams), p(dx), p(dres), form, b, n,
        c, kernels.dtype_code("x", x.dtype), vec, gw, chunks,
        kernels.stream_handle(dev))
    kernels.check(lib, err, "instance_norm_bwd")
    kernels.count_launch("K11", "backward", "cuda_core")
    return dx, dres, dparams


# K11's forward launch as an op of the dispatcher, (y, stats), registered
# with the library's low-level API: ``torch.library.custom_op`` runs its
# kernel under ``torch._disable_dynamo``, whose first call imports
# torch._dynamo (some 840 modules: seconds of every process's set-up)
_LIB = torch.library.Library("medseg", "FRAGMENT")
_LIB.define("instance_norm_act(Tensor x, Tensor weight, Tensor bias, "
            "Tensor? res, Tensor? res_weight, Tensor? res_bias, float eps) "
            "-> (Tensor, Tensor)")
_LIB.impl("instance_norm_act", _launch_fwd, "CompositeExplicitAutograd")


@torch.library.register_fake("medseg::instance_norm_act")
def _(x, weight, bias, res, res_weight, res_bias, eps):
    ntens = 2 if _form(res, res_weight) == 2 else 1
    return (x.new_empty(x.shape),
            x.new_empty((ntens, 2, x.shape[0], x.shape[-1]),
                        dtype=torch.float32))


instance_norm_act_op = torch.ops.medseg.instance_norm_act.default


class InstanceNormActFn(torch.autograd.Function):
    """``lrelu(IN(x) [+ res | + IN'(res)])`` on the card: forward and
    backward are K11. Takes fp32 parameters and returns fp32 gradients;
    saves x, res and the (k, 2, B, C) statistics, never an fp32 volume."""

    @staticmethod
    def forward(ctx, x, weight, bias, res, res_weight, res_bias, eps):
        y, stats = instance_norm_act_op(x, weight, bias, res, res_weight,
                                        res_bias, eps)
        ctx.save_for_backward(x, res, stats, weight, bias, res_weight,
                              res_bias)
        return y

    @staticmethod
    def backward(ctx, dy):
        # unpacking may run a checkpointed block's recompute: outside K11
        x, res, stats, weight, bias, res_weight, res_bias = ctx.saved_tensors
        with profiling.span("K11"):
            dx, dres, dp = instance_norm_act_bwd(
                x, res, dy.to(x.dtype).contiguous(), stats, weight, bias,
                res_weight, res_bias)
            # the two norms share dbias; each parameter gets its own tensor
            drw, drb = ((None, None) if res_weight is None
                        else (dp[2], dp[1].clone()))
            return dx, dp[0], dp[1], dres, drw, drb, None


@profiling.spanned("K11")
def instance_norm_act(x: torch.Tensor, weight: torch.Tensor,
                      bias: torch.Tensor, res: Optional[torch.Tensor] = None,
                      res_weight: Optional[torch.Tensor] = None,
                      res_bias: Optional[torch.Tensor] = None,
                      eps: float = 1e-5) -> torch.Tensor:
    """``lrelu(IN(x) [+ res | + IN'(res)])`` for x (B, D, H, W, C) and, where
    given, ``res`` of its shape and dtype: ``res_weight`` and ``res_bias``
    given, ``res`` is normalised with its own statistics and the same eps.
    Gradients flow to every tensor argument."""
    if x.device.type == "cpu":
        return instance_norm_act_plain(x, weight, bias, res, res_weight,
                                       res_bias, eps)
    if x.device.type != "cuda":
        raise ValueError(f"instance_norm_act: no kernel for {x.device}")
    rw, rb = ((None, None) if res_weight is None
              else (res_weight.float(), res_bias.float()))
    return InstanceNormActFn.apply(
        x.contiguous(), weight.float(), bias.float(),
        None if res is None else res.contiguous(), rw, rb, float(eps))


@profiling.spanned("K11")
def instance_norm_stats(x: torch.Tensor, eps: float = 1e-5
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(mean, rstd), each (B, C) fp32, over the spatial axes of x (B, D, H,
    W, C), without gradients: K11's statistics launches alone on the
    card."""
    if x.device.type == "cpu":
        return instance_norm_stats_plain(x, eps)
    if x.device.type != "cuda":
        raise ValueError(f"instance_norm_stats: no kernel for {x.device}")
    _, stats = _launch_fwd(x.contiguous(), None, None, None, None, None, eps,
                           stats_only=True)
    return stats[0, 0], stats[0, 1]
