"""The port's hand-written kernels: their names in a device trace, and the
operations and bytes of one call (a frozen copy of ``chip_smoke.py``'s
``_work``, ``_bound`` and peaks; that script may change, this copy does
not).

A call's bound is the larger of its operations over the peak rate of its
route (989 TFLOP/s on the tensor cores, 67 on the CUDA cores) and its bytes
over 3.35 TB/s, counting each input read once and each output written once.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

from portbench.roofline import PEAK_BF16_FLOPS, PEAK_FP32_FLOPS, PEAK_HBM_BYTES

# kernel name fragments of the port's CUDA sources (csrc/*.cu), by kernel;
# a device op whose name holds one of them is the port's own
FAMILIES: Dict[str, Tuple[str, ...]] = {
    "K1": ("window_attention_heads", "window_attention_proj"),
    "K2": ("fused_mlp_kernel", "fused_mlp_tc", "mlp_tc_finish"),
    "K3": ("window_attention_bwd",),
    "K4": ("fused_mlp_bwd",),
    "K5": ("dw27_",),
    "K7": ("sr_attention",),
    "K8": ("dice_ce_",),
    "K9": ("winograd_f23",),
    "K10": ("conv3_wgmma", "conv3_cuda_core"),
    "reduce": ("sum_partials_kernel",),
}


def family(name: str) -> str:
    """The port's kernel a device op belongs to, or "" for a library's."""
    for fam, frags in FAMILIES.items():
        if any(f in name for f in frags):
            return fam
    return ""


def work(kind: str, t: int, n: int, c: int, nh: int,
         elem: int = 2) -> Tuple[float, float]:
    """(FLOPs, bytes) of one call on T windows of N tokens (M = T * N rows):
    every product of the function once, every input read once, every output
    written once (activations and weights of ``elem`` bytes, fp32 biases,
    bias table and weight gradients)."""
    m = t * n
    act = m * c * elem
    if kind == "window_attention":      # qkv, proj; q k^T and p v per head
        return (8 * m * c * c + 4 * t * n * n * c,
                2 * act + 4 * c * c * elem + 4 * c * 4 + 2 * c * 4
                + nh * n * n * 4)
    if kind == "window_attention_bwd":  # qkv, dout, dWproj, dx, dWqkv;
        # s, o, dp, dv, dq, dk per head
        return (22 * m * c * c + 12 * t * n * n * c,
                3 * act + 4 * c * c * (elem + 4) + 4 * c * (4 + 4) + 2 * c * 8
                + nh * n * n * 8)
    if kind == "fused_mlp":             # fc1, fc2 with hidden 4C
        return (16 * m * c * c,
                2 * act + 8 * c * c * elem + 5 * c * 4 + 2 * c * 4)
    if kind == "fused_mlp_bwd":         # h, dW2, da, dW1, dxn
        return (40 * m * c * c,
                3 * act + 8 * c * c * (elem + 4) + 5 * c * 8 + 2 * c * 8)
    raise ValueError(kind)


def bound_s(kind: str, t: int, n: int, c: int, nh: int, elem: int = 2
            ) -> float:
    """The least seconds one call can take on the route of its dtype."""
    flops, nbytes = work(kind, t, n, c, nh, elem)
    peak = PEAK_BF16_FLOPS if elem == 2 else PEAK_FP32_FLOPS
    return max(flops / peak, nbytes / PEAK_HBM_BYTES)


# the work of K1-K4 by the counters of the wrappers that launch them
KINDS = {"K1": "window_attention", "K2": "fused_mlp",
         "K3": "window_attention_bwd", "K4": "fused_mlp_bwd"}


def swin_bound_s(stages: List[Dict], calls: Dict[str, int],
                 batches: List[int], elem: int = 2) -> float:
    """The summed bound of the K1-K4 calls of a Swin encoder whose blocks
    make ``calls[K]`` calls of kernel K in all, spread evenly over the
    blocks and over the model calls of ``batches`` crops or windows each."""
    blocks = sum(st["depth"] for st in stages)
    total = 0.0
    for fam, kind in KINDS.items():
        n_calls = calls.get(fam, 0)
        if not n_calls:
            continue
        per = n_calls / (blocks * len(batches))
        for b in batches:
            for st in stages:
                ws = st["window"]
                t = b * int(round((st["grid"][0] / ws) * (st["grid"][1] / ws)
                                  * (st["grid"][2] / ws)))
                total += per * st["depth"] * bound_s(
                    kind, t, ws ** 3, st["dim"], st["heads"], elem)
    return total
