"""Fused DiceCE loss: the wrappers of kernel K8 (forward sums and the logits'
gradient), their plain PyTorch versions, and the autograd function that
joins them.

Replaces the TPU kernels of ``medicalsemseg_tpu/ops/pallas/dice_ce.py``:
``_fwd_sums`` (one pass over the logits gives the per-(batch, class) Dice
sums and the CE) and the backward call inside ``_fused_for`` (one pass
recomputes the softmax and writes dlogits). The one-hot target is never
materialised. The CUDA source is ``csrc/dice_ce.cu``; its header says what
bounds it on the card and how the design answers that. The voxel count M
needs no padding: the kernels bounds-check the last tile.

A CPU tensor goes through :func:`dice_ce_sums_plain` /
:func:`dice_ce_dlogits_plain`; a CUDA tensor launches the kernel or raises.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from medicalsemseg_tpu_torch.ops import kernels

# kernel launches through dice_ce_sums() and dice_ce_dlogits()
launches = 0
bwd_launches = 0

# a voxel's classes live in one thread's registers (kMaxCls in csrc/dice_ce.cu)
MAX_CLASSES = 32
# voxels per tile (kVox in csrc/dice_ce.cu)
TILE_VOXELS = 256


def dice_ce_sums_plain(logits: torch.Tensor, labels: torch.Tensor
                       ) -> torch.Tensor:
    """The forward kernel's function in plain PyTorch: logits (B, M, C)
    fp32, labels (B, M) integer in [0, C) -> (B, 4, C) fp32 with the rows
    sum p.t, sum p^2, sum t (class voxel counts) and sum -log(p).t."""
    logp = torch.log_softmax(logits, dim=-1)
    p = torch.softmax(logits, dim=-1)
    t = F.one_hot(labels.long(), logits.shape[-1]).to(logits.dtype)
    return torch.stack([(p * t).sum(1), (p * p).sum(1), t.sum(1),
                        -(logp * t).sum(1)], dim=1)


def dice_ce_dlogits_plain(logits: torch.Tensor, labels: torch.Tensor,
                          ca: torch.Tensor, cp: torch.Tensor,
                          ce: torch.Tensor) -> torch.Tensor:
    """The backward kernel's function in plain PyTorch:
    p.(g - sum_c g.p) + ce.(p - t) with g = ca.t + cp.p, for the per-(batch,
    class) coefficients ``ca``, ``cp`` (B, C) and the scalar ``ce``."""
    p = torch.softmax(logits, dim=-1)
    t = F.one_hot(labels.long(), logits.shape[-1]).to(logits.dtype)
    g = ca[:, None, :] * t + cp[:, None, :] * p
    return p * (g - (g * p).sum(-1, keepdim=True)) + ce * (p - t)


def _check(logits, labels):
    if logits.dim() != 3 or labels.shape != logits.shape[:2]:
        raise ValueError(f"dice_ce: logits {tuple(logits.shape)} and labels "
                         f"{tuple(labels.shape)} are not (B, M, C) and (B, M)")
    if logits.shape[-1] > MAX_CLASSES:
        raise ValueError(f"dice_ce: {logits.shape[-1]} classes, the kernel "
                         f"takes at most {MAX_CLASSES}")
    kernels.check_tensor("logits", logits, logits.device, torch.float32)
    if labels.dtype not in (torch.int32, torch.int64):
        raise ValueError(f"labels are {labels.dtype}, expected int32 or int64")
    kernels.check_tensor("labels", labels, logits.device, labels.dtype)


def dice_ce_sums(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """logits (B, M, C) fp32 and labels (B, M) int32 or int64, both
    contiguous -> the (B, 4, C) fp32 sums of :func:`dice_ce_sums_plain`."""
    if logits.device.type == "cpu":
        return dice_ce_sums_plain(logits, labels)
    if logits.device.type != "cuda":
        raise ValueError(f"dice_ce_sums: no kernel for {logits.device}")
    _check(logits, labels)

    global launches
    b, m, c = logits.shape
    dev = logits.device
    lib = kernels.load()
    blocks = max(1, min(-(-m // TILE_VOXELS),
                        kernels.resident_blocks(dev) // b))
    part = torch.empty((blocks, b * 4 * c), dtype=torch.float32, device=dev)
    out = torch.empty((b, 4, c), dtype=torch.float32, device=dev)
    err = lib.medseg_dice_ce_sums(
        kernels.ptr(logits), kernels.ptr(labels), kernels.ptr(part),
        kernels.ptr(out), b, m, c, blocks, int(labels.dtype == torch.int64),
        kernels.stream_handle(dev))
    kernels.check(lib, err, "dice_ce_sums")
    launches += 1
    return out


def dice_ce_dlogits(logits: torch.Tensor, labels: torch.Tensor,
                    ca: torch.Tensor, cp: torch.Tensor, ce: torch.Tensor
                    ) -> torch.Tensor:
    """Gradient of the loss with respect to the logits, (B, M, C) fp32;
    arguments as in :func:`dice_ce_dlogits_plain` (``ca``, ``cp`` (B, C)
    fp32, ``ce`` one fp32 element, all on the logits' device)."""
    if logits.device.type == "cpu":
        return dice_ce_dlogits_plain(logits, labels, ca, cp, ce)
    if logits.device.type != "cuda":
        raise ValueError(f"dice_ce_dlogits: no kernel for {logits.device}")
    _check(logits, labels)
    b, m, c = logits.shape
    dev = logits.device
    kernels.check_tensor("ca", ca, dev, torch.float32, (b, c))
    kernels.check_tensor("cp", cp, dev, torch.float32, (b, c))
    if ce.numel() != 1:
        raise ValueError(f"ce has {ce.numel()} elements, expected 1")
    kernels.check_tensor("ce", ce, dev, torch.float32)

    global bwd_launches
    lib = kernels.load()
    out = torch.empty_like(logits)
    err = lib.medseg_dice_ce_dlogits(
        kernels.ptr(logits), kernels.ptr(labels), kernels.ptr(ca),
        kernels.ptr(cp), kernels.ptr(ce), kernels.ptr(out), b, m, c,
        int(labels.dtype == torch.int64), kernels.stream_handle(dev))
    kernels.check(lib, err, "dice_ce_dlogits")
    bwd_launches += 1
    return out


class DiceCEFusedFn(torch.autograd.Function):
    """MONAI DiceCELoss (softmax, one-hot target, squared_pred) of logits
    (B, *spatial, C) and integer labels (B, *spatial): forward = the K8 sums
    and a little scalar algebra, backward = the K8 dlogits pass. The logits
    are cast to fp32; their gradient comes back in their own dtype."""

    @staticmethod
    def forward(ctx, logits, labels, smooth_nr, smooth_dr, lambda_dice,
                lambda_ce):
        b, c = logits.shape[0], logits.shape[-1]
        lm = logits.float().reshape(b, -1, c).contiguous()
        lb = labels.reshape(b, -1).contiguous()
        if lb.dtype not in (torch.int32, torch.int64):
            lb = lb.to(torch.int32)
        m = lm.shape[1]
        sums = dice_ce_sums(lm, lb)
        inter, denom = sums[:, 0], sums[:, 1] + sums[:, 2]
        f = 1.0 - (2.0 * inter + smooth_nr) / (denom + smooth_dr)
        loss = lambda_dice * f.mean() + lambda_ce * sums[:, 3].sum() / (b * m)
        ctx.save_for_backward(lm, lb, inter, denom)
        ctx.cfg = (smooth_nr, smooth_dr, lambda_dice, lambda_ce)
        ctx.logits_shape, ctx.logits_dtype = logits.shape, logits.dtype
        return loss

    @staticmethod
    def backward(ctx, ct):
        lm, lb, inter, denom = ctx.saved_tensors
        smooth_nr, smooth_dr, lambda_dice, lambda_ce = ctx.cfg
        b, m, c = lm.shape
        # f = 1 - (2I + nr) / (D + dr), the loss holds f / (B C):
        # df/dI = -2 / (D + dr), df/dD = (2I + nr) / (D + dr)^2, dD/dp = 2p
        dd = denom + smooth_dr
        scale = ct.float() * (lambda_dice / (b * c))
        ca = scale * (-2.0 / dd)
        cp = scale * 2.0 * (2.0 * inter + smooth_nr) / (dd * dd)
        ce = (ct.float() * (lambda_ce / (b * m))).reshape(1)
        dl = dice_ce_dlogits(lm, lb, ca.contiguous(), cp.contiguous(), ce)
        return (dl.reshape(ctx.logits_shape).to(ctx.logits_dtype), None, None,
                None, None, None)


def dice_ce_fused(logits: torch.Tensor, labels: torch.Tensor,
                  squared_pred: bool = True, smooth_nr: float = 1e-5,
                  smooth_dr: float = 1e-5, lambda_dice: float = 1.0,
                  lambda_ce: float = 1.0) -> torch.Tensor:
    """DiceCE loss through kernel K8; equals ``train.losses.dice_ce_loss``.
    ``squared_pred=False`` has no fused form and takes the unfused loss."""
    if not squared_pred:
        from medicalsemseg_tpu_torch.train.losses import dice_ce_loss

        return dice_ce_loss(logits, labels, squared_pred, smooth_nr,
                            smooth_dr, lambda_dice, lambda_ce)
    return DiceCEFusedFn.apply(logits, labels, float(smooth_nr),
                               float(smooth_dr), float(lambda_dice),
                               float(lambda_ce))
