"""3x3x3 / stride-1 / SAME convolution as Winograd F(2^3, 3^3): the wrapper
of kernel K9 and its plain PyTorch version.

Replaces the TPU kernel of ``medicalsemseg_tpu/ops/pallas/winograd3d.py``
(``winograd_conv3d_f23``): every 2^3 tile of outputs comes from the 4^3 tile
of inputs around it through 64 channel products instead of 216. For
channels-last ``x`` (B, D, H, W, C) and a torch-layout weight ``w``
(Co, C, 3, 3, 3) it returns (B, D, H, W, Co) in x's dtype. With
``epilogue=(scale, shift)``, each (B, C) fp32, the conv's input is
``lrelu?(x * scale + shift)``: the folded form of an InstanceNorm
(+ LeakyReLU) before the conv, so that the normalized volume never exists in
device memory. The SAME padding stays zero (it comes after the activation).

Rounding points, the TPU kernel's: the activation and each of the three
input-transform stages round to x's dtype, the weights are transformed in
fp32 and rounded once, products add in fp32, the output transform is fp32
and the result rounds once.

The JAX kernel computes in x's dtype, whatever it is (its fused decoder runs
it in the model's compute dtype), and so does K9. Two routes
(:func:`winograd_route`): bf16 and fp16 run on the tensor cores (``wgmma``,
the weights laid out by :func:`kernel_weights_f23` in x's type), fp32 on the
CUDA cores in fp32 FMA (TF32 would change the function; the weights go as
(64, C, Co) fp32). Any other dtype raises.

The CUDA source is ``csrc/winograd3d.cu``; its header says what bounds it on
the card and how the design answers that. It reads ``x`` from its own layout
and checks bounds at the border, so any D, H, W runs: the TPU kernel's shape
rules (D % 4, H % 4, (W / 2) % 8) are rules of its layout and have no
counterpart. What remains of its gate is the channel window
:data:`MIN_CHANNELS` <= C < :data:`MAX_CHANNELS`
(:func:`winograd_f23_applicable`): below it the products are outer products,
at 128 and above the direct conv fills the tensor cores anyway. The kernel
itself takes any channel counts.

A CPU tensor goes through :func:`winograd_conv3d_f23_plain`; a CUDA tensor
launches the kernel or raises.
"""

from __future__ import annotations

import functools

import torch
import torch.nn.functional as F

from medicalsemseg_tpu_torch.ops import kernels
from medicalsemseg_tpu_torch.utils import profiling

# the channel window of the gate (the JAX package's winograd_f23_applicable)
MIN_CHANNELS = 16
MAX_CHANNELS = 128

# K9 stages 48 input channels at a time (kCK) and owns 48 output channels a
# block: kernel_weights_f23 pads both to multiples
CHUNK_CHANNELS = 48

# test hook: CPU suites set it so that the gates built on this kernel
# (ops.convgrad.wino23_eligible, models.decoders.decoder_fuse_enabled) pass
# for CPU tensors, which the wrapper sends through the plain version
ALLOW_CPU = False

# F(2, 3): G (4 x 3) and A^T (2 x 4); B^T (4 x 4) is _combine4
_G = ((1.0, 0.0, 0.0), (0.5, 0.5, 0.5), (0.5, -0.5, 0.5), (0.0, 0.0, 1.0))
_AT = ((1.0, 1.0, 1.0, 0.0), (0.0, 1.0, -1.0, -1.0))


def winograd_route(dtype) -> str:
    """The route the dtype picks: the tensor cores for bf16 and fp16, the
    CUDA cores for fp32; raises for any other dtype."""
    kernels.dtype_code("x", dtype)
    return "tensor_core" if kernels.tensor_core_dtype(dtype) else "cuda_core"


def winograd_f23_applicable(shape, cin: int) -> bool:
    """Whether K9 is the route for a conv with ``cin`` input channels over a
    (D, H, W) volume: the channel window only."""
    del shape
    return MIN_CHANNELS <= cin < MAX_CHANNELS


@functools.lru_cache(maxsize=None)
def _points_matrix(device: torch.device) -> torch.Tensor:
    """(64, 27) fp32: row (a, b, c), column (r, s, t) holds G[a, r] G[b, s]
    G[c, t], the weight transform as one matrix (a constant, kept per
    device). Made outside inference mode: a cached inference tensor could
    not be saved for a later backward (a training step after a predictor
    call)."""
    with torch.inference_mode(False):
        g = torch.tensor(_G, dtype=torch.float32)
        return torch.einsum("ar,bs,ct->abcrst", g, g, g).reshape(
            64, 27).to(device)


def _transform_weights(w: torch.Tensor) -> torch.Tensor:
    """(Co, C, 3, 3, 3) -> (64, Co, C) fp32, the kernel's order."""
    co, c = w.shape[:2]
    return (_points_matrix(w.device) @ w.float().reshape(co * c, 27).t()
            ).reshape(64, co, c)


def transform_weights_f23(w: torch.Tensor) -> torch.Tensor:
    """(Co, C, 3, 3, 3) -> (64, C, Co) fp32 Winograd-domain weights, point
    (a, b, c) = (d, h, w) index in a-major order (the JAX package's
    function and layout)."""
    return _transform_weights(w).transpose(1, 2)


def kernel_weights_f23(u: torch.Tensor) -> torch.Tensor:
    """(64, Co, C) Winograd-domain weights -> K9's order, zero padded: (Co
    tiles, C chunks, 64 points, 3 k steps, 2 halves of 8 input channels, 48
    output channels, 8), so that the (a, b) pair of one chunk and Co tile,
    its 4 c points, is one contiguous 18 KB slab laid out as the K-major
    core matrices wgmma reads (csrc/winograd3d.cu)."""
    p, co, c = u.shape
    k = CHUNK_CHANNELS
    cop, cp = -(-co // k) * k, -(-c // k) * k
    out = u.new_zeros((p, cop, cp))
    out[:, :co, :c] = u
    out = out.reshape(p, cop // k, k, cp // k, k // 16, 2, 8)
    return out.permute(1, 3, 0, 4, 5, 2, 6).contiguous()


def _combine4(p):
    """The rows of B^T on the 4 phase arrays along one axis."""
    return (p[0] - p[2], p[1] + p[2], p[2] - p[1], p[1] - p[3])


def _phases(t: torch.Tensor, dim: int, n: int):
    """The 4 phase arrays of ``n`` tiles along ``dim``: element k of tile i
    is t[2 i + k]."""
    step = (slice(None),) * dim + (slice(None, None, 2),)
    return [t.narrow(dim, k, 2 * n - 1)[step] for k in range(4)]


def _plain_one(x, u, d, h, wd):
    """One sample (1, D, H, W, C), already activated; u (4, 4, 4, C, Co)
    fp32 holding values of x's dtype."""
    td, th, tw = -(-d // 2), -(-h // 2), -(-wd // 2)
    xp = F.pad(x, (0, 0, 1, 2 * tw + 1 - wd, 1, 2 * th + 1 - h,
                   1, 2 * td + 1 - d))
    cw = _combine4(_phases(xp, 3, tw))
    ch = [_combine4(_phases(a, 2, th)) for a in cw]       # ch[c][b]
    y = [[[None, None] for _ in range(2)] for _ in range(2)]

    def add(acc, coef, term):
        if coef == 0.0:
            return acc
        term = term if coef == 1.0 else -term
        return term if acc is None else acc + term

    for ia in range(4):
        q = [[None, None], [None, None]]
        for ib in range(4):
            m = []
            for ic in range(4):
                v = _combine4(_phases(ch[ic][ib], 1, td))[ia]
                m.append(v.float() @ u[ia, ib, ic])        # fp32 sums
            n = (m[0] + m[1] + m[2], m[1] - m[2] - m[3])
            for iv in range(2):
                for iw in range(2):
                    q[iv][iw] = add(q[iv][iw], _AT[iv][ib], n[iw])
        for iu in range(2):
            for iv in range(2):
                for iw in range(2):
                    y[iu][iv][iw] = add(y[iu][iv][iw], _AT[iu][ia], q[iv][iw])
    # (2, 2, 2, 1, td, th, tw, Co) -> (1, td, 2, th, 2, tw, 2, Co)
    out = torch.stack([torch.stack([torch.stack(r) for r in p]) for p in y])
    out = out.permute(3, 4, 0, 5, 1, 6, 2, 7)
    out = out.reshape(1, 2 * td, 2 * th, 2 * tw, -1)
    return out[:, :d, :h, :wd].to(x.dtype)


def winograd_conv3d_f23_plain(x: torch.Tensor, w: torch.Tensor, epilogue=None,
                              lrelu: bool = False,
                              neg_slope: float = 0.01) -> torch.Tensor:
    """The kernel's function in plain PyTorch, step by step with the same
    rounding points, one sample at a time (V holds 8 values per output
    voxel). Any float dtype."""
    b, d, h, wd, c = x.shape
    if epilogue is not None:
        scale, shift = epilogue
        v = (x.float() * scale.float()[:, None, None, None, :]
             + shift.float()[:, None, None, None, :])
        if lrelu:
            v = torch.where(v >= 0, v, v * neg_slope)
        x = v.to(x.dtype)
    u = transform_weights_f23(w).to(x.dtype).float().reshape(
        4, 4, 4, c, w.shape[0])     # rounded once, as the kernel's
    return torch.cat([_plain_one(x[i:i + 1], u, d, h, wd) for i in range(b)])


@profiling.spanned("K9")
def winograd_conv3d_f23(x: torch.Tensor, w: torch.Tensor, epilogue=None,
                        lrelu: bool = False,
                        neg_slope: float = 0.01) -> torch.Tensor:
    """SAME / stride-1 3^3 conv of ``x`` (B, D, H, W, C) with ``w``
    (Co, C, 3, 3, 3) through kernel K9 -> (B, D, H, W, Co) in x's dtype.
    ``epilogue=(scale, shift)``, each (B, C), and ``lrelu`` as in the module
    docstring (``lrelu`` without an epilogue is ignored, as in the TPU
    kernel). The weights are transformed at every call: nothing is cached
    that an optimizer step could make stale."""
    if x.dim() != 5 or tuple(w.shape[1:]) != (x.shape[-1], 3, 3, 3):
        raise ValueError(f"winograd_conv3d_f23: x {tuple(x.shape)} and w "
                         f"{tuple(w.shape)} are not (B, D, H, W, C) and "
                         "(Co, C, 3, 3, 3)")
    b, d, h, wd, c = x.shape
    co = w.shape[0]
    if epilogue is not None:
        scale, shift = epilogue
        if tuple(scale.shape) != (b, c) or tuple(shift.shape) != (b, c):
            raise ValueError(f"winograd_conv3d_f23: epilogue shapes "
                             f"{tuple(scale.shape)}, {tuple(shift.shape)}, "
                             f"expected {(b, c)}")
    if x.device.type == "cpu":
        return winograd_conv3d_f23_plain(x, w, epilogue, lrelu, neg_slope)
    if x.device.type != "cuda":
        raise ValueError(f"winograd_conv3d_f23: no kernel for {x.device}")
    return _launch(x, w, epilogue, lrelu, neg_slope)


def _launch(x, w, epilogue, lrelu, neg_slope):
    """The kernel's launch, whatever the device (the tests drive it on CPU
    tensors with a stand-in library)."""
    code = kernels.dtype_code("x", x.dtype)
    kernels.check_tensor("x", x, x.device, x.dtype)
    if w.device != x.device:
        raise ValueError(f"w is on {w.device}, expected {x.device}")
    route = winograd_route(x.dtype)
    b, d, h, wd, c = x.shape
    co = w.shape[0]
    if route == "tensor_core":
        u = kernel_weights_f23(_transform_weights(w).to(x.dtype))
        cp, cop = u.shape[1] * CHUNK_CHANNELS, u.shape[0] * CHUNK_CHANNELS
    else:
        u = transform_weights_f23(w).contiguous()
        cp, cop = c, co
    ep = None
    if epilogue is not None:
        scale, shift = epilogue
        ep = torch.stack([scale, shift], dim=1).float().contiguous()
        kernels.check_tensor("epilogue", ep, x.device, torch.float32,
                             (b, 2, c))
    y = torch.empty((b, d, h, wd, co), dtype=x.dtype, device=x.device)

    lib = kernels.load()
    err = lib.medseg_winograd_f23(
        kernels.ptr(x), kernels.ptr(u), kernels.ptr(ep), kernels.ptr(y),
        b, d, h, wd, c, co, cp, cop, int(lrelu), float(neg_slope), code,
        kernels.ROUTES[route], kernels.stream_handle(x.device))
    kernels.check(lib, err, "winograd_conv3d_f23")
    kernels.count_launch("K9", "forward", route)
    return y
