"""Typed configuration with a flag-compatible argparse front end.

The port's own copy of medicalsemseg_tpu/config.py: the same flags and
defaults, plus ``--device`` (default ``cuda``), the torch device the entry
points run on. Flags of paths that are not ported are still parsed; the
entry points raise ``NotImplementedError`` for them.

The reference drives everything through a flat argparse namespace built by six
`add_*_config_args` groups (reference: utils/arguments.py:4-313) and threads it
as ``cfg`` through every layer.  We keep the exact same CLI flag surface (so a
user of the reference can reuse their launch commands verbatim) but back it
with a frozen dataclass, and reproduce the reference's list-collapsing rule:
1-element list flags collapse to scalars, multi-element ones become tuples
(reference: utils/arguments.py:19-24).
"""

from __future__ import annotations

import argparse
import dataclasses
from dataclasses import dataclass
from typing import Optional, Tuple, Union

import torch

IntOr3 = Union[int, Tuple[int, int, int]]
FloatOr3 = Union[float, Tuple[float, float, float]]


def as_tuple3(v) -> Tuple[int, int, int]:
    """Expand a scalar or length-1/3 sequence to a 3-tuple (MONAI's ensure_tuple_rep)."""
    if isinstance(v, (int, float)):
        return (v, v, v)
    t = tuple(v)
    if len(t) == 1:
        return (t[0], t[0], t[0])
    if len(t) != 3:
        raise ValueError(f"expected scalar or 3-sequence, got {v!r}")
    return t


@dataclass
class Config:
    """All reference flags (reference: utils/arguments.py) as one typed record."""

    # --- model group (reference: utils/arguments.py:29-124) ---
    model: str = "nnFormerUNETR"  # the reference default 'UNETR_Official' silently
    # builds None (a reference bug); we default to the flagship.
    vol_size: IntOr3 = 96
    patch_size: IntOr3 = 2  # reference default 16 cannot feed its own decoder
    # (96/16 = 6 is not divisible by 2**4); 2 is the working flagship setting.
    window_size: Union[int, Tuple[int, ...]] = 6
    input_dim: int = 3
    output_dim: int = 3
    in_chans: int = 1
    hidden_dim: int = 48
    depths: Tuple[int, ...] = (2, 2, 2, 2)
    num_heads: Tuple[int, ...] = (3, 6, 12, 24)
    mlp_ratio: float = 4.0
    rel_pos_bias: bool = False
    rel_pos_bias_affine: bool = False
    abs_pos_emb: bool = False
    rel_crop_pos_emb: bool = False
    qkv_bias: bool = False
    gradient_clipping: Optional[float] = None
    mixed_precision: bool = False
    learned_cls_vectors: bool = False
    lcv_vector_dim: int = 6
    lcv_final_layer: bool = False
    lcv_sincos_emb: bool = False
    lcv_concat_vector: bool = False
    lcv_only: bool = False
    lcv_linear_comb: bool = False
    lcv_patch_voxel_mean: bool = False
    use_abs_pos_emb: bool = False
    global_token: bool = False
    deep_supervision: bool = False  # per-scale aux heads + weighted losses
    # (the reference's official nnFormer trains with ds heads,
    # nnformer_official.py:952-978; only --model nnFormer supports it)

    # --- transform group (reference: utils/arguments.py:127-218) ---
    t_voxel_spacings: bool = False
    t_voxel_dims: FloatOr3 = 1.0
    t_cubed_ct_intensity: bool = False
    t_fixed_ct_intensity: bool = False
    t_percentile_ct_intensity: bool = False
    t_ct_min: int = -1000
    t_ct_max: int = 1000
    t_crop_foreground_img: bool = False
    t_crop_foreground_kdiv: bool = False
    t_rand_crop_fgbg: bool = False
    t_rand_crop_pos_weight: float = 1.0
    t_rand_crop_neg_weight: float = 1.0
    t_rand_crop_classes: bool = False
    t_rand_crop_dilated_center: bool = False
    t_rand_spatial_crop: bool = False
    t_spatial_pad: bool = False
    t_convert_labels_to_brats: bool = False
    t_normalize: bool = False
    t_normalize_channel_wise: bool = False
    t_norm_mean: float = 0.1943
    t_norm_std: float = 0.2786
    t_n_patches_per_image: int = 1
    t_flip_prob: float = 0.0
    t_rot_prob: float = 0.0
    t_intensity_shift_os: float = 0.1
    t_intensity_shift_prob: float = 0.0
    t_intensity_scale_factors: float = 0.1
    t_intensity_scale_prob: float = 0.0

    # --- data group (reference: utils/arguments.py:221-244) ---
    data_path: str = "/datasets/"
    json_list: str = "dataset.json"
    task: str = "Task03_Liver"
    batch_size_val: int = 1
    n_images_per_batch: int = 8
    n_workers_train: int = 8
    n_workers_val: int = 2
    pin_mem: bool = True
    cache_dataset: bool = True
    cache_rate_train: float = 1.0
    cache_rate_val: float = 1.0

    # --- optimizer group (reference: utils/arguments.py:247-268) ---
    loss_fn: str = "DiceCE"
    tversky_alpha: float = 0.5
    tversky_beta: float = 0.5
    smooth_nr: float = 1e-5
    smooth_dr: float = 1e-5
    weight_decay: float = 1e-5
    lr: float = 4e-4
    momentum: float = 0.9
    warmup_epochs: int = 40

    # --- training group (reference: utils/arguments.py:271-295) ---
    start_epoch: int = 0
    epochs: int = 200
    save_ckpt_freq: int = 20
    val_interval: int = 20
    cv_fold: int = 0
    cv_max_folds: int = 5
    val_infer_overlap: float = 0.5
    world_size: int = 1
    local_rank: int = -1
    dist_on_itp: bool = False
    dist_url: str = "env://"
    backend: str = "jax"  # reference default 'nccl'; here the JAX runtime
    resume: str = ""
    pretrained: Optional[str] = None

    # --- misc group (reference: utils/arguments.py:298-313) ---
    seed: int = 13
    no_cuddn_auto_tuner: bool = False
    anomaly_detection: bool = False  # maps to jax_debug_nans + checkify guards
    log_dir: Optional[str] = None
    neptune_logging: bool = False  # no egress in this environment; kept for CLI parity
    save_eval_output: bool = False
    output_dir: Optional[str] = None
    description: Optional[str] = None

    # --- additions of the JAX package (no reference equivalent); the port
    # keeps every flag so that launch commands carry over ---
    compute_dtype: str = "bfloat16"  # bf16 replaces torch.cuda.amp fp16+GradScaler
    sw_batch_size: int = 16  # windows per sliding-window predictor call
    metric_readback_freq: int = 20  # steps between device->host metric reads
    profile_dir: Optional[str] = None  # not ported: the entry points raise
    mesh_shape: Optional[Tuple[int, ...]] = None  # multi-device layout; the
    # port runs one device
    drop_path_rate: float = 0.2
    device_data_pipeline: bool = False  # device-resident volume cache with
    # on-device crops and augmentation; not ported: the entry points raise
    remat: str = "conv"  # the JAX package's rematerialisation policy. The
    # port rematerialises nothing (batch 8 of the flagship fits one 80 GB
    # card as autograd saves it), so "none" and "conv" run the same code;
    # "full" and "mixed" are not ported and the training entry point raises
    # for them
    tta_mirror: bool = False  # nn-UNet-style 8-way flip TTA at inference
    sw_bucket_multiple: int = 32  # pad eval volumes to spatial multiples
    val_group_policy: str = "bucket"  # multi-device validation grouping;
    # one device here, no effect
    grad_accum_steps: int = 1  # micro-batch accumulation: gradients are
    # averaged and the optimizer steps every k-th call
    pallas_train: bool = True  # the JAX package's switch for its fused
    # kernels in training; the port always trains through its kernels
    ref_quirk_rel_pos: bool = False  # reproduce the reference's colliding
    # GC-ViT/nnFormer rel-pos index strides (GCViTUNETR reads it)
    flat_optimizer: bool = False  # not ported (make_optimizer raises)
    device_hd95: bool = False  # HD95 on the accelerator; not ported yet
    fused_loss: bool = False  # DiceCE through the fused kernel K8
    # (ops/kernels/dice_ce.py) where no mask is given
    device: str = "cuda"  # torch device of the entry points; a CUDA device
    # that is not there is an error, "cpu" runs the kernels' plain versions
    use_pallas_attention: bool = True  # the JAX package's switch for its
    # fused attention at inference; the port always runs its kernels

    # ---------------- derived helpers ----------------
    def vol_size3(self) -> Tuple[int, int, int]:
        return as_tuple3(self.vol_size)

    def patch_size3(self) -> Tuple[int, int, int]:
        return as_tuple3(self.patch_size)

    def window_sizes(self) -> Tuple[int, ...]:
        """Per-stage attention window sizes (scalar broadcasts to all stages)."""
        ws = self.window_size
        if isinstance(ws, int):
            return tuple([ws] * len(self.depths))
        ws = tuple(ws)
        if len(ws) == 1:
            return tuple([ws[0]] * len(self.depths))
        return ws

    def replace(self, **kw) -> "Config":
        return dataclasses.replace(self, **kw)

    def __post_init__(self):
        # --mixed_precision = the reference's fp16 autocast (run_training.py:95)
        # kept as a PARITY MODE: fp16 compute dtype, fp32 master params.
        # bf16 (the default) needs no loss scaling; fp16 mode is
        # for numerics comparisons, not the production path (SURVEY §2.3).
        if self.mixed_precision and self.compute_dtype == "bfloat16":
            self.compute_dtype = "float16"


def _add_bool_flag(group, name: str, default: bool, help: str = "", true_flag=None,
                   false_flag=None):
    dest = name
    if true_flag is None:
        true_flag = "--" + name
    if false_flag is not None:
        group.add_argument(false_flag, action="store_false", dest=dest, help=help)
    else:
        group.add_argument(true_flag, action="store_true", dest=dest, help=help)
    group.set_defaults(**{dest: default})


def build_parser() -> argparse.ArgumentParser:
    """Flag-for-flag mirror of the reference CLI (reference: utils/arguments.py:4-313)."""
    p = argparse.ArgumentParser(description="medicalsemseg_tpu_torch")
    d = Config()

    g = p.add_argument_group("model")
    g.add_argument("--model", default=d.model, type=str)
    g.add_argument("--vol_size", nargs="*", default=[96], type=int)
    g.add_argument("--patch_size", nargs="*", default=[2], type=int)
    g.add_argument("--window_size", nargs="*", default=[6], type=int)
    g.add_argument("--input_dim", default=3, type=int)
    g.add_argument("--output_dim", default=3, type=int)
    g.add_argument("--in_chans", default=1, type=int)
    g.add_argument("--hidden_dim", default=48, type=int)
    g.add_argument("--depths", nargs="*", default=[2, 2, 2, 2], type=int)
    g.add_argument("--num_heads", nargs="*", default=[3, 6, 12, 24], type=int)
    g.add_argument("--mlp_ratio", default=4.0, type=float)
    for flag in ("rel_pos_bias", "rel_pos_bias_affine", "abs_pos_emb",
                 "rel_crop_pos_emb", "qkv_bias", "mixed_precision",
                 "learned_cls_vectors", "lcv_final_layer", "lcv_sincos_emb",
                 "lcv_concat_vector", "lcv_only", "lcv_linear_comb",
                 "lcv_patch_voxel_mean", "use_abs_pos_emb", "global_token",
                 "deep_supervision"):
        _add_bool_flag(g, flag, False)
    g.add_argument("--gradient_clipping", type=float, default=None)
    g.add_argument("--lcv_vector_dim", default=6, type=int)

    g = p.add_argument_group("transform")
    for flag in ("t_voxel_spacings", "t_cubed_ct_intensity", "t_fixed_ct_intensity",
                 "t_percentile_ct_intensity", "t_crop_foreground_img",
                 "t_crop_foreground_kdiv", "t_rand_crop_fgbg", "t_rand_crop_classes",
                 "t_rand_crop_dilated_center", "t_rand_spatial_crop", "t_spatial_pad",
                 "t_convert_labels_to_brats", "t_normalize", "t_normalize_channel_wise"):
        _add_bool_flag(g, flag, False)
    g.add_argument("--t_voxel_dims", nargs="*", default=[1.0], type=float)
    g.add_argument("--t_ct_min", default=-1000, type=int)
    g.add_argument("--t_ct_max", default=1000, type=int)
    g.add_argument("--t_rand_crop_pos_weight", type=float, default=1.0)
    g.add_argument("--t_rand_crop_neg_weight", type=float, default=1.0)
    g.add_argument("--t_norm_mean", default=0.1943, type=float)
    g.add_argument("--t_norm_std", default=0.2786, type=float)
    g.add_argument("--t_n_patches_per_image", default=1, type=int)
    g.add_argument("--t_flip_prob", default=0.0, type=float)
    g.add_argument("--t_rot_prob", default=0.0, type=float)
    g.add_argument("--t_intensity_shift_os", default=0.1, type=float)
    g.add_argument("--t_intensity_shift_prob", default=0.0, type=float)
    g.add_argument("--t_intensity_scale_factors", default=0.1, type=float)
    g.add_argument("--t_intensity_scale_prob", default=0.0, type=float)

    g = p.add_argument_group("data")
    g.add_argument("--data_path", default="/datasets/", type=str)
    g.add_argument("--json_list", default="dataset.json", type=str)
    g.add_argument("--task", default="Task03_Liver", type=str)
    g.add_argument("--batch_size_val", type=int, default=1)
    g.add_argument("--n_images_per_batch", type=int, default=8)
    g.add_argument("--n_workers_train", type=int, default=8)
    g.add_argument("--n_workers_val", type=int, default=2)
    _add_bool_flag(g, "pin_mem", True, false_flag="--no_pin_memory")
    _add_bool_flag(g, "cache_dataset", True, false_flag="--no_cache_dataset")
    g.add_argument("--cache_rate_train", type=float, default=1.0)
    g.add_argument("--cache_rate_val", type=float, default=1.0)

    g = p.add_argument_group("optimizer")
    g.add_argument("--loss_fn", type=str, default="DiceCE")
    g.add_argument("--tversky_alpha", type=float, default=0.5)
    g.add_argument("--tversky_beta", type=float, default=0.5)
    g.add_argument("--smooth_nr", type=float, default=1e-5)
    g.add_argument("--smooth_dr", type=float, default=1e-5)
    g.add_argument("--weight_decay", type=float, default=1e-5)
    g.add_argument("--lr", type=float, default=4e-4)
    g.add_argument("--momentum", type=float, default=0.9)
    g.add_argument("--warmup_epochs", type=int, default=40)

    g = p.add_argument_group("training")
    g.add_argument("--start_epoch", default=0, type=int)
    g.add_argument("--epochs", type=int, default=200)
    g.add_argument("--save_ckpt_freq", default=20, type=int)
    g.add_argument("--val_interval", default=20, type=int)
    g.add_argument("--cv_fold", default=0, type=int)
    g.add_argument("--cv_max_folds", default=5, type=int)
    g.add_argument("--val_infer_overlap", default=0.5, type=float)
    g.add_argument("--world_size", default=1, type=int)
    g.add_argument("--local_rank", default=-1, type=int)
    _add_bool_flag(g, "dist_on_itp", False)
    g.add_argument("--dist_url", default="env://")
    g.add_argument("--backend", default="jax")
    g.add_argument("--resume", default="")
    g.add_argument("--pretrained", type=str, default=None)

    g = p.add_argument_group("misc")
    g.add_argument("--seed", type=int, default=13)
    _add_bool_flag(g, "no_cuddn_auto_tuner", False)
    _add_bool_flag(g, "anomaly_detection", False)
    g.add_argument("--log_dir", type=str, default=None)
    _add_bool_flag(g, "neptune_logging", False, false_flag="--no_neptune_logging")
    _add_bool_flag(g, "save_eval_output", False)
    g.add_argument("--output_dir", type=str, default=None)
    g.add_argument("--description", type=str, default=None)

    g = p.add_argument_group("additions of the JAX package")
    g.add_argument("--compute_dtype", type=str, default="bfloat16",
                   choices=["bfloat16", "float32", "float16"])
    g.add_argument("--sw_batch_size", type=int, default=16)
    g.add_argument("--metric_readback_freq", type=int, default=20)
    g.add_argument("--profile_dir", type=str, default=None)
    g.add_argument("--drop_path_rate", type=float, default=0.2)
    _add_bool_flag(g, "use_pallas_attention", True,
                   false_flag="--no_pallas_attention")
    g.add_argument("--grad_accum_steps", type=int, default=1)
    _add_bool_flag(g, "tta_mirror", False)
    g.add_argument("--remat", nargs="?", const="conv", default="conv",
                   choices=["none", "conv", "full", "mixed"],
                   help="rematerialize model blocks; 'conv' (default) saves "
                        "conv outputs and replays only elementwise chains. "
                        "'mixed' differs from 'conv' only for UNETR-style "
                        "decoders (their full-res blocks remat fully); other "
                        "heads treat it as 'conv'. "
                        "NB: bare --remat used to mean 'full' (round-1 bool "
                        "flag); it now selects 'conv' — pass --remat full "
                        "for the old behavior, --no_remat for none")
    # round-1 scripts used bool-style --no_remat; keep it as an alias
    g.add_argument("--no_remat", dest="remat", action="store_const",
                   const="none", help="alias for --remat none")
    _add_bool_flag(g, "device_data_pipeline", False)
    _add_bool_flag(g, "pallas_train", True,
                   false_flag="--no_pallas_train",
                   help="the JAX package's switch for its fused kernels in "
                        "training; no effect here")
    # round-2 scripts opted in with --pallas_train; keep it parseable
    g.add_argument("--pallas_train", dest="pallas_train",
                   action="store_true", help=argparse.SUPPRESS)
    _add_bool_flag(g, "flat_optimizer", False,
                   help="flat-buffer AdamW: the whole optimizer as one "
                        "fused pass (train/flat_optim.py)")
    _add_bool_flag(g, "fused_loss", False)
    _add_bool_flag(g, "device_hd95", False,
                   help="compute HD95 surface distances on the accelerator "
                        "(bit-identical to the host EDT path)")
    _add_bool_flag(g, "ref_quirk_rel_pos", False)
    g.add_argument("--val_group_policy", default="bucket",
                   choices=["bucket", "sorted_max"],
                   help="multi-chip volume-DP grouping: 'bucket' (default, "
                        "bit-identical logits) or 'sorted_max' (full groups "
                        "on shape-diverse folds; MONAI-equivalent logits)")

    p.add_argument("--device", default="cuda",
                   help="torch device to run on (default cuda); a CUDA "
                        "device that is not there is an error")
    return p


def resolve_device(name: str) -> torch.device:
    """The torch device that ``--device`` names; a CUDA device that is not
    there is an error, never a silent fall back to the CPU."""
    dev = torch.device(name)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"--device {name}: torch.cuda.is_available() is "
                           "false; pass --device cpu to run the plain path")
    return dev


def get_args(argv=None) -> Config:
    """Parse CLI flags into a Config, applying the reference list-collapsing rule
    (reference: utils/arguments.py:16-26)."""
    ns = build_parser().parse_args(argv)
    d = vars(ns)
    for k, v in list(d.items()):
        if isinstance(v, list):
            d[k] = v[0] if len(v) == 1 else tuple(v)
    known = {f.name for f in dataclasses.fields(Config)}
    return Config(**{k: v for k, v in d.items() if k in known})
