"""Shared layers (counterpart of medicalsemseg_tpu/models/layers.py).

Activations are channels-last (..., C) tensors in the model's compute dtype;
parameters stay fp32 and are cast at use, as the JAX modules do. Norm
statistics are fp32. For cuDNN, ``x.permute(0, 4, 1, 2, 3)`` of a contiguous
(B, D, H, W, C) tensor is already an NCDHW tensor in ``channels_last_3d``
memory format, so the convolutions copy nothing to change layout.
"""

from __future__ import annotations

import threading
from typing import Callable, List, Optional, Tuple, Union

import torch
import torch.nn as nn
import torch.nn.functional as F
import torch.utils.checkpoint as tcp

from medicalsemseg_tpu_torch.ops import convgrad
from medicalsemseg_tpu_torch.ops.convgrad import Conv3x3x3Fn
from medicalsemseg_tpu_torch.ops.kernels import winograd3d as k9
from medicalsemseg_tpu_torch.ops.kernels import layer_norm
from medicalsemseg_tpu_torch.ops.kernels import mlp as kmlp


Tuple3 = Tuple[int, int, int]


def _triple(k: Union[int, Tuple3]) -> Tuple3:
    return (k,) * 3 if isinstance(k, int) else tuple(int(v) for v in k)


def to_ncdhw(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 4, 1, 2, 3)


def to_ndhwc(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 2, 3, 4, 1).contiguous()


def linear(x: torch.Tensor, lin: nn.Linear) -> torch.Tensor:
    """``lin`` with its fp32 parameters cast to the activation dtype (a flax
    ``nn.Dense(dtype=...)``)."""
    dt = x.dtype
    return F.linear(x, lin.weight.to(dt),
                    None if lin.bias is None else lin.bias.to(dt))


def leaky_relu(x: torch.Tensor) -> torch.Tensor:
    return F.leaky_relu(x, negative_slope=0.01)


# -- block rematerialisation (the JAX package's ``remat_module``) --

REMAT_MODES = ("none", "conv", "mixed", "full")

# the ops whose outputs a "conv" block keeps where a conv module computes
# them: the products (the convolution, the matmul of a 1^3 conv, K9's
# launch); the layout copies, casts and bias additions around them are
# recomputed
_CONV_PRODUCTS = frozenset((torch.ops.aten.convolution.default,
                            torch.ops.aten.mm.default,
                            torch.ops.aten.addmm.default,
                            torch.ops.aten.bmm.default,
                            torch.ops.medseg.winograd_f23.default))


class _RematState(threading.local):
    conv = 0          # the depth of conv_out calls running
    block = None      # the checkpointed block running, forward or recompute
    replay = False    # whether that is its recompute in the backward
    sum_i = 0         # the next of its BatchNorm sums to hand back


_TLS = _RematState()


def remat_replaying() -> bool:
    """Whether this is a checkpointed block's recompute in the backward."""
    return _TLS.replay


def _keep_conv_products(ctx, op, *args, **kwargs):
    return (tcp.CheckpointPolicy.MUST_SAVE
            if _TLS.conv and op in _CONV_PRODUCTS
            else tcp.CheckpointPolicy.PREFER_RECOMPUTE)


def conv_out(fn: Callable, *args) -> torch.Tensor:
    """``fn(*args)``, a conv module's output marked as saved: the
    counterpart of ``checkpoint_name(y, "conv_out")``. In a "conv" block
    the selective-checkpoint policy keeps the products computed inside
    (``_CONV_PRODUCTS``), so the block's recompute takes them back instead
    of computing them again; elsewhere the mark changes nothing."""
    _TLS.conv += 1
    try:
        return fn(*args)
    finally:
        _TLS.conv -= 1


def _generators(fn) -> List[torch.Generator]:
    """The generators that the DropPath and Dropout modules of ``fn`` draw
    from (the train state's, once set), each once."""
    if not isinstance(fn, nn.Module):
        return []
    gens = {}
    for m in fn.modules():
        g = getattr(m, "generator", None)
        if isinstance(m, (DropPath, Dropout)) and g is not None:
            gens[id(g)] = g
    return list(gens.values())


class _Block:
    """One checkpointed block: the states of the generators its forward
    draws from, and the BatchNorm sums its forward all-reduced, for its
    recompute."""

    def __init__(self, fn: Callable):
        self.gens = _generators(fn)
        self.drawn = [g.get_state() for g in self.gens]
        self.sums: List[torch.Tensor] = []

    def contexts(self, keep_convs: bool):
        """``checkpoint``'s ``context_fn``: the forward's context and the
        recompute's, with the "conv" policy's pair where ``keep_convs``."""
        fwd, rec = _InBlock(self, False), _InBlock(self, True)
        if keep_convs:
            fwd.mode, rec.mode = tcp.create_selective_checkpoint_contexts(
                _keep_conv_products)
        return fwd, rec


class _InBlock:
    """Entered around a checkpointed block's forward, or (``replay``) its
    recompute in the backward, which draws what the forward drew: the
    generators are put back for it and restored after it."""

    def __init__(self, block: _Block, replay: bool):
        self.block, self.replay, self.mode = block, replay, None

    def __enter__(self):
        b = self.block
        self.prev = (_TLS.block, _TLS.replay, _TLS.sum_i)
        _TLS.block, _TLS.replay, _TLS.sum_i = b, self.replay, 0
        if self.replay:
            self.now = [g.get_state() for g in b.gens]
            for g, s in zip(b.gens, b.drawn):
                g.set_state(s)
        if self.mode is not None:
            self.mode.__enter__()

    def __exit__(self, *exc):
        if self.mode is not None:
            self.mode.__exit__(*exc)
        _TLS.block, _TLS.replay, _TLS.sum_i = self.prev
        if self.replay:
            for g, s in zip(self.block.gens, self.now):
                g.set_state(s)


def checkpoint_block(fn: Callable, mode: str, *args, **kwargs):
    """``fn(*args, **kwargs)`` under the rematerialisation ``mode``
    (``Config.remat``; the JAX package's ``remat_module``):

      * ``"none"``: as it is;
      * ``"full"``: ``torch.utils.checkpoint`` (non-reentrant): the forward
        keeps only what goes into ``fn`` and the backward runs ``fn`` again;
      * ``"conv"``: the same, but what the block's conv modules compute
        (:func:`conv_out`) is kept, through a selective-checkpoint policy,
        so the recompute runs everything but the convolutions; ``"mixed"``
        is ``"conv"`` here (the UNETR decoder gives its two full-resolution
        blocks ``"full"``).

    Values never change: the recompute draws the DropPath and Dropout masks
    of the forward (``checkpoint`` itself restores the default generators
    only), BatchNorm moves its running statistics once, in the forward, and
    under data parallelism takes its all-reduced sums from the forward
    instead of reducing again. Without gradients ``fn`` runs directly, as
    JAX's remat changes nothing there."""
    if mode not in REMAT_MODES:
        raise ValueError(f"unknown remat mode {mode!r}; one of "
                         f"{', '.join(REMAT_MODES)}")
    if mode == "none" or not torch.is_grad_enabled():
        return fn(*args, **kwargs)
    block = _Block(fn)
    return tcp.checkpoint(fn, *args, use_reentrant=False,
                          context_fn=lambda: block.contexts(mode != "full"),
                          **kwargs)


class _ReplayedSums(torch.autograd.Function):
    """A BatchNorm's all-reduced sums from its block's forward, handed to
    the block's recompute in place of a second ``all_reduce``; the gradient
    is the all-reduce of the incoming one, as ``all_reduce``'s is."""

    @staticmethod
    def forward(ctx, local, reduced, group):
        ctx.group = group
        return reduced.clone()

    @staticmethod
    def backward(ctx, g):
        import torch.distributed as dist

        g = g.clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None, None


def _group_sums(local: torch.Tensor, group) -> torch.Tensor:
    """``local`` summed over ``group``, autograd-aware; in a checkpointed
    block's recompute the sums of its forward."""
    from torch.distributed.nn.functional import all_reduce

    b = _TLS.block
    if b is not None and _TLS.replay:
        sums = _ReplayedSums.apply(local, b.sums[_TLS.sum_i], group)
        _TLS.sum_i += 1
        return sums
    sums = all_reduce(local, group=group)
    if b is not None:
        b.sums.append(sums.detach())
    return sums


def drop_path(x: torch.Tensor, rate: float, training: bool,
              generator: Optional[torch.Generator] = None,
              keep_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Per-sample stochastic depth (timm DropPath semantics): each sample of
    the batch is kept with probability 1 - rate and scaled by 1 / keep.
    ``keep_mask`` (B,) bool replaces the draw (tests inject the mask that
    the JAX package drew)."""
    if not training or rate == 0.0:
        return x
    keep = 1.0 - rate
    if keep_mask is None:
        keep_mask = torch.rand(x.shape[0], generator=generator,
                               device=x.device) < keep
    mask = keep_mask.reshape((x.shape[0],) + (1,) * (x.dim() - 1))
    return torch.where(mask, x / keep, torch.zeros_like(x))


def dropout(x: torch.Tensor, rate: float, training: bool,
            generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """Elementwise dropout (flax ``nn.Dropout``): each element is kept with
    probability 1 - rate and scaled by 1 / keep in ``x``'s dtype. The mask
    is drawn as one byte an element (``bernoulli_`` into a bool tensor), so
    a full-resolution map of the SegFormer heads costs a quarter of an fp32
    draw."""
    if not training or rate == 0.0:
        return x
    keep = 1.0 - rate
    mask = torch.empty(x.shape, dtype=torch.bool, device=x.device).bernoulli_(
        keep, generator=generator)
    return torch.where(mask, x / keep, torch.zeros((), dtype=x.dtype,
                                                   device=x.device))


class DropPath(nn.Module):
    """Stochastic depth on the residual branch. Draws from ``generator``
    when one is set (the train state sets it; it must live on the input's
    device), else from torch's global generator of that device."""

    def __init__(self, rate: float = 0.0):
        super().__init__()
        self.rate = rate
        self.generator: Optional[torch.Generator] = None

    def forward(self, x: torch.Tensor,
                keep_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        return drop_path(x, self.rate, self.training, self.generator,
                         keep_mask)


class Dropout(nn.Module):
    """Elementwise dropout in training (:func:`dropout`), drawing from
    ``generator`` as :class:`DropPath` does."""

    def __init__(self, rate: float = 0.0):
        super().__init__()
        self.rate = rate
        self.generator: Optional[torch.Generator] = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return dropout(x, self.rate, self.training, self.generator)


class LayerNorm(nn.Module):
    """LayerNorm with fp32 statistics and the fast variance
    (``ops.kernels.layer_norm``, the formula the kernels absorb)."""

    def __init__(self, dim: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(dim))
        self.bias = nn.Parameter(torch.zeros(dim))

    def params(self) -> torch.Tensor:
        """(2, C) fp32 scale and bias rows, the form the kernels take."""
        return torch.stack([self.weight, self.bias]).float()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return layer_norm(x.float(), self.params(), self.eps).to(x.dtype)


class Conv3d(nn.Module):
    """Channels-last 3D convolution; weight (O, I / groups, k, k, k) as in
    torch. ``padding`` is the same on both sides of every axis (the JAX
    modules' explicit ((p, p),) * 3, 0 for their VALID). Left at None it is
    flax's "SAME" at stride 1 for a cubic kernel k: (k - 1) // 2 before and
    k // 2 after every axis, so an even kernel (FocalNet's focal layers of 6
    and 8) pads one voxel more after than before.

    Dense 1x1x1 / stride 1 runs as a matmul over the channel axis (the JAX
    package's ``_Fast1x1Conv``). Dense 3x3x3 / stride 1 / SAME with gradients
    enabled goes through ``Conv3x3x3Fn`` (its ``_FastConv3dS1``), whose
    weight gradient may take kernel K5 and whose forward and input gradient
    take kernel K9 under ``MEDSEG_WINOGRAD_TRAIN``; without gradients the
    same shape takes K9 (bf16), or the library's conv without TF32 (fp32),
    under ``MEDSEG_WINOGRAD`` (``ops.convgrad``). Every other shape (strided,
    grouped), and without a gate every shape without gradients, goes to
    cuDNN (oneDNN on the CPU) on the channels_last_3d view (a grouped conv
    on a contiguous copy). With gradients, each route's output is a
    :func:`conv_out`, which a "conv" rematerialised block keeps."""

    def __init__(self, in_ch: int, out_ch: int,
                 kernel_size: Union[int, Tuple3] = 3,
                 stride: Union[int, Tuple3] = 1,
                 padding: Optional[int] = None,
                 bias: bool = True, groups: int = 1):
        super().__init__()
        self.kernel_size, self.stride, self.groups = kernel_size, stride, groups
        # "SAME" at stride 1, as the JAX Conv3d default: symmetric for an
        # odd kernel, one more voxel after than before for an even one
        self.padding = kernel_size // 2 if padding is None else padding
        self.same_even = None
        if padding is None and kernel_size % 2 == 0:
            self.padding = 0
            self.same_even = ((kernel_size - 1) // 2, kernel_size // 2) * 3
        k3 = _triple(kernel_size)
        self.weight = nn.Parameter(torch.empty(out_ch, in_ch // groups, *k3))
        self.bias = nn.Parameter(torch.zeros(out_ch)) if bias else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = x.dtype
        b = None if self.bias is None else self.bias.to(dt)
        dense_s1 = self.groups == 1 and self.stride == 1
        if self.kernel_size == 1 and dense_s1:
            return conv_out(F.linear, x, self.weight[:, :, 0, 0, 0].to(dt), b)
        if self.kernel_size == 3 and dense_s1 and self.padding == 1:
            if torch.is_grad_enabled():
                y = conv_out(Conv3x3x3Fn.apply, x, self.weight.to(dt))
                return y if b is None else y + b
            if convgrad.winograd_infer_eligible(x):
                y = k9.winograd_conv3d_f23(x.contiguous(), self.weight.to(dt))
                return y if b is None else y + b
            if convgrad.exact_fp32_eligible(x):
                with convgrad.no_tf32():
                    return self._library(x, b)
        return conv_out(self._library, x, b)

    def _library(self, x: torch.Tensor, b: Optional[torch.Tensor]
                 ) -> torch.Tensor:
        dt = x.dtype
        xn = to_ncdhw(x)
        if self.groups > 1:
            # on the channels-last view cuDNN runs a depthwise conv as one
            # small kernel per group; PyTorch's own depthwise kernel takes
            # the contiguous layout and is several times faster, copies
            # included
            xn = xn.contiguous()
        if self.same_even is not None:
            xn = F.pad(xn, self.same_even)
        y = F.conv3d(xn, self.weight.to(dt), b, stride=self.stride,
                     padding=self.padding, groups=self.groups)
        return to_ndhwc(y)


class ConvTranspose3d(nn.Module):
    """Channels-last transposed conv with kernel == stride (no overlap).

    Weight (I, O, k, k, k) as in torch. The JAX model keeps the kernel
    spatially flipped relative to this layout (utils/torch_import.py
    ``conv_transpose``); ``utils.params`` converts between the two."""

    def __init__(self, in_ch: int, out_ch: int,
                 kernel_size: Union[int, Tuple3], bias: bool = False):
        super().__init__()
        self.kernel_size = kernel_size
        self.weight = nn.Parameter(
            torch.empty(in_ch, out_ch, *_triple(kernel_size)))
        self.bias = nn.Parameter(torch.zeros(out_ch)) if bias else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return conv_out(self._library, x)

    def _library(self, x: torch.Tensor) -> torch.Tensor:
        dt = x.dtype
        b = None if self.bias is None else self.bias.to(dt)
        y = F.conv_transpose3d(to_ncdhw(x), self.weight.to(dt), b,
                               stride=self.kernel_size)
        return to_ndhwc(y)


class InstanceNorm(nn.Module):
    """Affine InstanceNorm over the spatial dims of (B, D, H, W, C), fp32
    statistics (population variance)."""

    def __init__(self, dim: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(dim))
        self.bias = nn.Parameter(torch.zeros(dim))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xf = x.float()
        var, mean = torch.var_mean(xf, dim=(1, 2, 3), keepdim=True,
                                   correction=0)
        y = (xf - mean) * torch.rsqrt(var + self.eps)
        return (y * self.weight.float() + self.bias.float()).to(x.dtype)


class BatchNorm(nn.Module):
    """Affine BatchNorm over (..., C) in fp32, flax ``nn.BatchNorm`` as the
    JAX ``layers.BatchNorm`` builds it (momentum 0.9). In eval mode it
    normalises with the running statistics; in training with the batch's
    over every axis but C: mean E[x] and the biased variance max(0, E[x^2] -
    E[x]^2) (flax's fast variance), and each training call moves the running
    statistics to 0.9 * running + 0.1 * batch, the variance biased too
    (``torch.nn.BatchNorm3d`` would keep the unbiased one), as JAX's
    ``mutable=["batch_stats"]`` apply does on every micro-step.
    ``running_mean`` and ``running_var`` are the JAX model's
    ``batch_stats``. Under data parallelism (``process_group`` set by
    :func:`set_batchnorm_group`) the batch statistics are the global
    batch's: [sum x, sum x^2, n] is all-reduced over the group through the
    autograd-aware ``torch.distributed.nn.functional.all_reduce``, which is
    what the JAX package's one SPMD program computes. Inside a checkpointed
    block (:func:`checkpoint_block`) the statistics move in the forward only
    and the recompute reuses the forward's reduced sums, as flax's
    ``nn.remat`` updates ``batch_stats`` once."""

    momentum = 0.9   # flax's: the weight of the running statistics

    def __init__(self, dim: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.process_group = None
        self.weight = nn.Parameter(torch.ones(dim))
        self.bias = nn.Parameter(torch.zeros(dim))
        self.register_buffer("running_mean", torch.zeros(dim))
        self.register_buffer("running_var", torch.ones(dim))

    def _batch_moments(self, xf: torch.Tensor):
        axes = tuple(range(xf.dim() - 1))
        if self.process_group is None:
            return xf.mean(axes), (xf * xf).mean(axes)
        c = xf.shape[-1]
        sums = _group_sums(torch.cat([
            xf.sum(axes), (xf * xf).sum(axes),
            xf.new_full((1,), float(xf.numel() // c))]), self.process_group)
        return sums[:c] / sums[-1], sums[c:2 * c] / sums[-1]

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xf = x.float()
        if self.training:
            mean, ex2 = self._batch_moments(xf)
            var = torch.clamp(ex2 - mean * mean, min=0.0)
            # moved once, by the forward: not again by its recompute
            if not remat_replaying():
                with torch.no_grad():
                    m = self.momentum
                    self.running_mean.copy_(m * self.running_mean
                                            + (1 - m) * mean.detach())
                    self.running_var.copy_(m * self.running_var
                                           + (1 - m) * var.detach())
        else:
            mean, var = self.running_mean.float(), self.running_var.float()
        mul = torch.rsqrt(var + self.eps) * self.weight.float()
        y = (xf - mean) * mul + self.bias.float()
        return y.to(x.dtype)


def set_batchnorm_group(model: nn.Module, group) -> int:
    """Make every :class:`BatchNorm` of ``model`` reduce its training
    statistics over ``group`` (None: this process's batch alone); returns
    how many there are."""
    norms = [m for m in model.modules() if isinstance(m, BatchNorm)]
    for m in norms:
        m.process_group = group
    return len(norms)


class Mlp(nn.Module):
    """fc1 -> exact GELU -> fc2 token MLP of any hidden width, run as the
    fused kernels with the block's pre-MLP LayerNorm absorbed: K2 alone
    without gradients (the JAX block's inference form with Pallas on), K2
    forward + K4 backward through ``FusedMlpFn`` with them (its
    ``fused_mlp_trainable``)."""

    def __init__(self, dim: int, hidden: int):
        super().__init__()
        self.fc1 = nn.Linear(dim, hidden)
        self.fc2 = nn.Linear(hidden, dim)

    def forward(self, x: torch.Tensor, ln: torch.Tensor,
                residual: bool = True) -> torch.Tensor:
        """[x +] mlp(LN(x)) for raw tokens x (M, C) in the compute dtype,
        with the LayerNorm's (2, C) scale/bias rows ``ln``."""
        if torch.is_grad_enabled():
            return kmlp.FusedMlpFn.apply(x.contiguous(), ln, self.fc1.weight,
                                         self.fc1.bias, self.fc2.weight,
                                         self.fc2.bias, 1e-5, residual)
        dt = x.dtype
        return kmlp.fused_mlp(x.contiguous(), self.fc1.weight.to(dt),
                              self.fc1.bias.float(), self.fc2.weight.to(dt),
                              self.fc2.bias.float(), ln=ln, residual=residual)

    def plain(self, x: torch.Tensor) -> torch.Tensor:
        """mlp(x) of LN'd tokens (..., C) in PyTorch ops that autograd
        differentiates, each dense in the compute dtype: the JAX module's
        XLA form, which the MONAI blocks run where they leave the kernels
        (training, or ``MEDSEG_OFFICIAL_FUSED`` off)."""
        return linear(F.gelu(linear(x, self.fc1)), self.fc2)


def tokens_to_volume(x: torch.Tensor, grid: Tuple3) -> torch.Tensor:
    """(B, N, C) -> (B, D, H, W, C)."""
    return x.reshape(x.shape[0], *grid, x.shape[-1])


def volume_to_tokens(x: torch.Tensor) -> torch.Tensor:
    """(B, D, H, W, C) -> (B, N, C)."""
    return x.reshape(x.shape[0], -1, x.shape[-1])


class BasicConv3d(nn.Module):
    """Conv (with bias) -> BatchNorm (eps 1e-3) -> exact GELU over
    (B, D, H, W, C), SwInception's conv unit (the JAX ``BasicConv3d``)."""

    def __init__(self, in_ch: int, out_ch: int, kernel_size: int = 1):
        super().__init__()
        self.conv = Conv3d(in_ch, out_ch, kernel_size, bias=True)
        self.bn = BatchNorm(out_ch, eps=1e-3)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.gelu(self.bn(self.conv(x)))


class InceptionMlp(nn.Module):
    """SwInception's token MLP: five parallel conv branches over the token
    grid, concatenated, then a dense layer back to C (the JAX
    ``InceptionMlp``). Each branch is ``int(hidden / 5)`` wide; the 3^3,
    5^3 and 7^3 branches bottleneck through ``C // 8`` channels and stack
    one, two and three 3^3 convs; the pool branch is a 3^3 average pool
    (padding counted) and a 1^3 conv. ``convs`` holds the eleven
    :class:`BasicConv3d` in the order the JAX module creates them
    (``BasicConv3d_0`` .. ``_10``): the 1^3 branch, the 3^3 branch's two,
    the 5^3 branch's three, the 7^3 branch's four, the pool branch's one.
    The 3^3 convs are ``Conv3d``'s 3^3 form (weight gradient through K5's
    gate, forward and input gradient through K9's)."""

    def __init__(self, dim: int, hidden: int):
        super().__init__()
        bd = int(hidden / 5)
        bn = max(dim // 8, 1)
        plan = ([(dim, bd, 1)]
                + [(dim, bn, 1), (bn, bd, 3)]
                + [(dim, bn, 1), (bn, bn, 3), (bn, bd, 3)]
                + [(dim, bn, 1), (bn, bn, 3), (bn, bn, 3), (bn, bd, 3)]
                + [(dim, bd, 1)])
        self.convs = nn.ModuleList([BasicConv3d(i, o, k) for i, o, k in plan])
        self.fc = nn.Linear(5 * bd, dim)

    def forward(self, x: torch.Tensor, grid: Tuple3) -> torch.Tensor:
        """Tokens (B, N, C) of the grid (D, H, W) -> (B, N, C)."""
        v = tokens_to_volume(x, grid)
        c = self.convs
        b1 = c[0](v)
        b3 = c[2](c[1](v))
        b5 = c[5](c[4](c[3](v)))
        b7 = c[9](c[8](c[7](c[6](v))))
        # the padding counts (count_include_pad); padded explicitly, as
        # avg_pool3d refuses grids smaller than its window; summed in fp32
        # (the CPU has no bf16 avg_pool3d) and rounded once
        padded = F.pad(v.float(), (0, 0, 1, 1, 1, 1, 1, 1))
        pool = F.avg_pool3d(to_ncdhw(padded), 3, stride=1)
        bp = c[10](to_ndhwc(pool).to(v.dtype))
        cat = torch.cat([b1, b3, b5, b7, bp], dim=-1)
        return linear(volume_to_tokens(cat), self.fc)


class DepthwiseConvMlp(nn.Module):
    """SwinDepth's token MLP: dense to the hidden width, exact GELU, three
    times (depthwise 3^3 conv with bias -> BatchNorm eps 1e-3 -> exact GELU)
    over the token grid, dense back to C (the JAX ``DepthwiseConvMlp``).
    The depthwise convs run PyTorch's own kernel, as the JAX package runs
    XLA there."""

    def __init__(self, dim: int, hidden: int):
        super().__init__()
        self.fc1 = nn.Linear(dim, hidden)
        self.convs = nn.ModuleList([Conv3d(hidden, hidden, 3, groups=hidden)
                                    for _ in range(3)])
        self.bns = nn.ModuleList([BatchNorm(hidden, eps=1e-3)
                                  for _ in range(3)])
        self.fc2 = nn.Linear(hidden, dim)

    def forward(self, x: torch.Tensor, grid: Tuple3) -> torch.Tensor:
        """Tokens (B, N, C) of the grid (D, H, W) -> (B, N, C)."""
        v = tokens_to_volume(F.gelu(linear(x, self.fc1)), grid)
        for conv, bn in zip(self.convs, self.bns):
            v = F.gelu(bn(conv(v)))
        return linear(volume_to_tokens(v), self.fc2)
