"""Parameter conversion between the JAX models and the port, and torch
checkpoints.

One key map (:func:`key_map`) pairs every leaf of a JAX model's parameter
tree (nested dicts of arrays; every model of the factory: nnFormerUNETR,
SwInception, SwinDepth and SwinSegFormer with every option of the Swin
encoder, SegFormer3D, GCViTUNETR, FocalNetUNETR, UNETR_Official, the
official nnFormer, SwinUNETR_Official, LRGFormerUNETR, VideoSwinUNETR,
Swin2D) with its key in the port's state_dict, which for the flagship is
also the reference PyTorch layout (for VideoSwinUNETR and SwinUNETR_Official
the Video-Swin and MONAI layouts, but for the MLP's ``fc1`` / ``fc2``), and
names the layout change between them:

  dense   Dense kernel (I, O)                  <-> Linear weight (O, I)
  conv    Conv kernel (k, k, k, I / g, O)      <-> Conv3d weight (O, I / g, k, k, k)
  conv2   Conv kernel (k, k, I, O)             <-> Conv2d weight (O, I, k, k)
  convT   ConvTranspose kernel (k, k, k, I, O) <-> un-flipped, (I, O, k, k, k)
  plain   norm scale / bias, biases, tables    <-> weight / bias, unchanged

:func:`state_dict_from_jax` (the inverse of
``medicalsemseg_tpu/utils/torch_import.py:import_swin_unetr_checkpoint``)
and :func:`jax_tree_from_state_dict` walk it in the two directions. Given the
variables {'params': ..., 'batch_stats': ...} instead of the bare parameter
tree, they also carry the running statistics of every BatchNorm, wherever
it sits (``batch_stats/<path>/{mean,var}`` <-> ``<prefix>.running_{mean,var}``,
``<prefix>`` being the state_dict prefix of ``params/<path>/scale``: the
SegFormer heads' ``<fuse>.bn``, SwInception's ``...mlp.convs.{k}.bn``,
SwinDepth's ``...mlp.bns.{k}``). Every change is a permutation of a leaf's
elements, so the same functions carry gradients and optimizer moments as well
as weights.
:func:`load_adamw_state_from_optax` fills ``torch.optim.AdamW``'s state from
optax's (mu, nu, count). All take numpy and import no jax.
:func:`load_pretrained_encoder` puts the ``encoder.*`` weights of a reference
checkpoint into a model, resizing relative-position bias tables that were
trained with another window size and stacking the reference's per-interval
class vectors (``encoder.lcv.vectors.{k}``) into the port's one table.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np
import torch

KeyMap = List[Tuple[Tuple[str, ...], str, str]]

_TO_PORT = {
    "dense": lambda a: a.T,
    "conv": lambda a: a.transpose(4, 3, 0, 1, 2),
    "conv2": lambda a: a.transpose(3, 2, 0, 1),
    "convT": lambda a: a[::-1, ::-1, ::-1].transpose(3, 4, 0, 1, 2),
    "plain": lambda a: a,
}
_TO_JAX = {
    "dense": lambda a: a.T,
    "conv": lambda a: a.transpose(2, 3, 4, 1, 0),
    "conv2": lambda a: a.transpose(2, 3, 1, 0),
    "convT": lambda a: a.transpose(2, 3, 4, 0, 1)[::-1, ::-1, ::-1],
    "plain": lambda a: a,
}


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, dtype=np.float32, order="C"))


def key_map(params: Dict) -> KeyMap:
    """(path in the JAX tree, state_dict key, layout change) for every leaf
    of a ported model's tree. ``params`` is the parameter tree ({'encoder':
    ..., 'decoder': ...} or, under a SegFormer head, {'encoder': ...,
    'linear_c1': ..., ...}), or the variables {'params': ..., 'batch_stats':
    ...}: then the paths start with the collection's name and the BatchNorm
    running statistics are mapped too."""
    if "params" in params:
        out = [(("params",) + path, key, kind)
               for path, key, kind in key_map(params["params"])]
        # a BatchNorm's statistics sit at its parameters' path in the other
        # collection; its state_dict prefix is that of its scale
        norms = {path[1:-1]: key[:-len(".weight")] for path, key, _ in out
                 if path[-1] == "scale"}
        for path in _stats_paths(params.get("batch_stats", {})):
            for leaf, buf in (("mean", "running_mean"), ("var", "running_var")):
                out.append((("batch_stats",) + path + (leaf,),
                            f"{norms[path]}.{buf}", "plain"))
        return out

    out: KeyMap = []

    def kernel(path, prefix, p, kind):
        out.append((path + ("kernel",), f"{prefix}.weight", kind))
        if "bias" in p:
            out.append((path + ("bias",), f"{prefix}.bias", "plain"))

    def conv(path, prefix, p):
        # the Conv3d wrapper: the conv's leaves sit under 'Conv_0'
        kernel(path + ("Conv_0",), prefix, p["Conv_0"], "conv")

    def norm(path, prefix, p):
        # LayerNorm wrapper ({'LayerNorm_0': {scale, bias}}), or InstanceNorm
        # / BatchNorm leaves
        if "LayerNorm_0" in p:
            path = path + ("LayerNorm_0",)
        out.append((path + ("scale",), f"{prefix}.weight", "plain"))
        out.append((path + ("bias",), f"{prefix}.bias", "plain"))

    def attn_leaves(path, prefix, p):
        # raw leaves qkv_kernel / proj_kernel (the local window attention)
        out.append((path + ("qkv_kernel",), f"{prefix}.qkv.weight", "dense"))
        if "qkv_bias" in p:
            out.append((path + ("qkv_bias",), f"{prefix}.qkv.bias", "plain"))
        out.append((path + ("proj_kernel",), f"{prefix}.proj.weight", "dense"))
        out.append((path + ("proj_bias",), f"{prefix}.proj.bias", "plain"))

    def table(path, prefix):
        out.append((path + ("relative_position_bias_table",),
                    f"{prefix}.relative_position_bias_table", "plain"))

    def res_block(path, prefix, p):
        for k in ("1", "2", "3"):
            if f"conv{k}" in p:
                conv(path + (f"conv{k}",), f"{prefix}.conv{k}.conv",
                     p[f"conv{k}"])
                norm(path + (f"norm{k}",), f"{prefix}.norm{k}", p[f"norm{k}"])

    def numbered(tree, stem):
        i = 0
        while f"{stem}{i}" in tree:
            yield i, tree[f"{stem}{i}"]
            i += 1

    def batch_norm(path, prefix, p):
        # the BatchNorm wrapper: the leaves sit under 'BatchNorm_0'
        norm(path + ("BatchNorm_0",), prefix, p["BatchNorm_0"])

    def swin_mlp(path, prefix, blk):
        # the dense MLP (Mlp_0), SwInception's (InceptionMlp_0: eleven
        # BasicConv3d_k, then Dense_0) or SwinDepth's (DepthwiseConvMlp_0:
        # Dense_0, Conv3d_k and BatchNorm_k, Dense_1)
        if "Mlp_0" in blk:
            for d, fc in (("Dense_0", "fc1"), ("Dense_1", "fc2")):
                kernel(path + ("Mlp_0", d), f"{prefix}.{fc}",
                       blk["Mlp_0"][d], "dense")
        elif "InceptionMlp_0" in blk:
            mp, m = path + ("InceptionMlp_0",), blk["InceptionMlp_0"]
            for k, bc in numbered(m, "BasicConv3d_"):
                bp = mp + (f"BasicConv3d_{k}",)
                conv(bp + ("Conv3d_0",), f"{prefix}.convs.{k}.conv",
                     bc["Conv3d_0"])
                batch_norm(bp + ("BatchNorm_0",), f"{prefix}.convs.{k}.bn",
                           bc["BatchNorm_0"])
            kernel(mp + ("Dense_0",), f"{prefix}.fc", m["Dense_0"], "dense")
        else:
            mp, m = path + ("DepthwiseConvMlp_0",), blk["DepthwiseConvMlp_0"]
            for d, fc in (("Dense_0", "fc1"), ("Dense_1", "fc2")):
                kernel(mp + (d,), f"{prefix}.{fc}", m[d], "dense")
            for k, c in numbered(m, "Conv3d_"):
                conv(mp + (f"Conv3d_{k}",), f"{prefix}.convs.{k}", c)
                batch_norm(mp + (f"BatchNorm_{k}",), f"{prefix}.bns.{k}",
                           m[f"BatchNorm_{k}"])

    def swin_block(bp, base, blk):
        # the flagship's SwinBlock: LayerNorm_0 / _1, raw attention leaves,
        # the bias table, the affine bias and global-token leaves, the MLP
        norm(bp + ("LayerNorm_0",), f"{base}.norm1", blk["LayerNorm_0"])
        norm(bp + ("LayerNorm_1",), f"{base}.norm2", blk["LayerNorm_1"])
        at, ap = blk["attn"], bp + ("attn",)
        attn_leaves(ap, f"{base}.attn", at)
        table(ap, f"{base}.attn")
        if "rel_pos_bias_affine_emb" in at:
            out.append((ap + ("rel_pos_bias_affine_emb",),
                        f"{base}.attn.rel_pos_bias_affine_emb", "plain"))
            kernel(ap + ("rel_pos_bias_affine_lin",),
                   f"{base}.attn.rel_pos_bias_affine_lin",
                   at["rel_pos_bias_affine_lin"], "dense")
        if "gt_proj" in at:
            kernel(ap + ("gt_proj",), f"{base}.attn.gt_proj", at["gt_proj"],
                   "dense")
        swin_mlp(bp, f"{base}.mlp", blk)

    def swin_merging(path, prefix, down):
        # the flagship's PatchMerging: GELU -> LN -> strided 3^3 conv
        norm(path + ("LayerNorm_0",), f"{prefix}.norm", down["LayerNorm_0"])
        conv(path + ("reduction",), f"{prefix}.reduction", down["reduction"])

    def dense_mlp(path, prefix, p):
        for d, fc in (("Dense_0", "fc1"), ("Dense_1", "fc2")):
            kernel(path + (d,), f"{prefix}.{fc}", p[d], "dense")

    def official_block(bp, base, blk):
        # MONAI's block: norm1 / norm2, nn.Dense-named qkv / proj, the
        # constructor window's table, the MLP
        norm(bp + ("norm1",), f"{base}.norm1", blk["norm1"])
        norm(bp + ("norm2",), f"{base}.norm2", blk["norm2"])
        for d in ("qkv", "proj"):
            kernel(bp + ("attn", d), f"{base}.attn.{d}", blk["attn"][d],
                   "dense")
        table(bp + ("attn",), f"{base}.attn")
        dense_mlp(bp + ("mlp",), f"{base}.mlp", blk["mlp"])

    def official_merging(path, prefix, down):
        # LN(8C) -> dense without bias
        norm(path + ("norm",), f"{prefix}.norm", down["norm"])
        kernel(path + ("reduction",), f"{prefix}.reduction",
               down["reduction"], "dense")

    def official_stages(root, tree, names, port_stage):
        # stage k: blocks f"{stem}{i}" and the merging at ``down``, where
        # (stem, down) = names(k), under the state_dict prefix port_stage(k)
        k = 0
        while names(k)[1] in tree:
            (stem, down), stage = names(k), port_stage(k)
            for i, blk in numbered(tree, stem):
                official_block(root + (f"{stem}{i}",), f"{stage}.blocks.{i}",
                               blk)
            official_merging(root + (down,), f"{stage}.downsample",
                             tree[down])
            k += 1

    def swin_encoder(enc):
        if "patch_embed" in enc:    # absent under --lcv_only
            pe = ("encoder", "patch_embed")
            conv(pe, "encoder.patch_embed.proj", enc["patch_embed"])
            norm(pe + ("LayerNorm_0",), "encoder.patch_embed.norm",
                 enc["patch_embed"]["LayerNorm_0"])
        lcv = enc.get("lcv", {})
        if "vectors" in lcv:
            out.append((("encoder", "lcv", "vectors"), "encoder.lcv.vectors",
                        "plain"))
        if "fc" in lcv:
            kernel(("encoder", "lcv", "fc"), "encoder.lcv.fc", lcv["fc"],
                   "dense")
        if "rel_crop_pos_emb" in enc:
            kernel(("encoder", "rel_crop_pos_emb"), "encoder.rel_crop_pos_emb",
                   enc["rel_crop_pos_emb"], "dense")
        if "global_token" in enc:
            out.append((("encoder", "global_token"), "encoder.global_token",
                        "plain"))
        for i, layer in numbered(enc, "layers_"):
            lp = ("encoder", f"layers_{i}")
            for j, blk in numbered(layer, "blocks_"):
                swin_block(lp + (f"blocks_{j}",),
                           f"encoder.layers.{i}.blocks.{j}", blk)
            swin_merging(lp + ("downsample",),
                         f"encoder.layers.{i}.downsample", layer["downsample"])
            if "gt_upsample" in layer:
                kernel(lp + ("gt_upsample",),
                       f"encoder.layers.{i}.gt_upsample",
                       layer["gt_upsample"], "dense")
            norm(("encoder", f"norm{i}"), f"encoder.norm{i}", enc[f"norm{i}"])

    def conv_se(path, prefix, p):
        conv(path + ("Conv3d_0",), f"{prefix}.dwconv", p["Conv3d_0"])
        conv(path + ("Conv3d_1",), f"{prefix}.pwconv", p["Conv3d_1"])
        for d, fc in (("Dense_0", "fc1"), ("Dense_1", "fc2")):
            kernel(path + ("SE_0", d), f"{prefix}.se.{fc}", p["SE_0"][d],
                   "dense")

    def gcvit_encoder(enc):
        conv(("encoder", "patch_embed"), "encoder.patch_embed",
             enc["patch_embed"])
        for i, level in numbered(enc, "levels_"):
            lp, base = ("encoder", f"levels_{i}"), f"encoder.levels.{i}"
            for k, fe in numbered(level, "to_q_global_"):
                conv_se(lp + (f"to_q_global_{k}", "_ConvSE_0"),
                        f"{base}.to_q_global.{k}.conv_se", fe["_ConvSE_0"])
            for j, blk in numbered(level, "blocks_"):
                bp, bb = lp + (f"blocks_{j}",), f"{base}.blocks.{j}"
                norm(bp + ("norm1",), f"{bb}.norm1", blk["norm1"])
                norm(bp + ("norm2",), f"{bb}.norm2", blk["norm2"])
                if "qkv" in blk["attn"]:    # global: nn.Dense-named leaves
                    for d in ("qkv", "proj"):
                        kernel(bp + ("attn", d), f"{bb}.attn.{d}",
                               blk["attn"][d], "dense")
                else:
                    attn_leaves(bp + ("attn",), f"{bb}.attn", blk["attn"])
                table(bp + ("attn",), f"{bb}.attn")
                for d, fc in (("Dense_0", "fc1"), ("Dense_1", "fc2")):
                    kernel(bp + ("mlp", d), f"{bb}.mlp.{fc}", blk["mlp"][d],
                           "dense")
            down, dp = level["downsample"], lp + ("downsample",)
            norm(dp + ("norm1",), f"{base}.downsample.norm1", down["norm1"])
            conv_se(dp + ("_ConvSE_0",), f"{base}.downsample.conv_se",
                    down["_ConvSE_0"])
            conv(dp + ("reduction",), f"{base}.downsample.reduction",
                 down["reduction"])
            norm(dp + ("norm2",), f"{base}.downsample.norm2", down["norm2"])
            norm(("encoder", f"norm{i}"), f"encoder.norm{i}", enc[f"norm{i}"])

    def segformer_encoder(enc):
        s = 1
        while f"patch_embed{s}" in enc:
            pe, pp = enc[f"patch_embed{s}"], ("encoder", f"patch_embed{s}")
            conv(pp + ("proj",), f"encoder.patch_embed{s}.proj", pe["proj"])
            norm(pp + ("norm",), f"encoder.patch_embed{s}.norm", pe["norm"])
            for i, blk in numbered(enc, f"block{s}_"):
                bp, bb = ("encoder", f"block{s}_{i}"), f"encoder.block{s}_{i}"
                norm(bp + ("norm1",), f"{bb}.norm1", blk["norm1"])
                norm(bp + ("norm2",), f"{bb}.norm2", blk["norm2"])
                at = blk["attn"]
                for d in ("q", "kv", "proj"):
                    kernel(bp + ("attn", d), f"{bb}.attn.{d}", at[d], "dense")
                if "sr" in at:
                    conv(bp + ("attn", "sr"), f"{bb}.attn.sr", at["sr"])
                    norm(bp + ("attn", "norm"), f"{bb}.attn.norm", at["norm"])
                for d in ("fc1", "fc2"):
                    kernel(bp + ("mlp", d), f"{bb}.mlp.{d}", blk["mlp"][d],
                           "dense")
                conv(bp + ("mlp", "dwconv"), f"{bb}.mlp.dwconv",
                     blk["mlp"]["dwconv"])
            norm(("encoder", f"norm{s}"), f"encoder.norm{s}", enc[f"norm{s}"])
            s += 1

    def unetr_decoder(dec):
        for k, blk in numbered(dec, "encoder"):
            res_block(("decoder", f"encoder{k}"), f"unet_encoders.{k}.layer",
                      blk)
        for k, d in numbered(dec, "decoder"):
            dp = ("decoder", f"decoder{k}")
            kernel(dp + ("transp_conv", "ConvTranspose_0"),
                   f"unet_decoders.{k}.transp_conv.conv",
                   d["transp_conv"]["ConvTranspose_0"], "convT")
            res_block(dp + ("conv_block",), f"unet_decoders.{k}.conv_block",
                      d["conv_block"])
        conv(("decoder", "out", "conv"), "out.conv.conv", dec["out"]["conv"])

    def segformer_head(tree):
        for name in sorted(tree):
            if name.startswith("linear_c"):
                kernel((name, "proj"), f"{name}.proj", tree[name]["proj"],
                       "dense")
            elif name.startswith("linear_fuse"):
                conv((name, "Conv3d_0"), f"{name}.conv",
                     tree[name]["Conv3d_0"])
                batch_norm((name, "BatchNorm_0"), f"{name}.bn",
                           tree[name]["BatchNorm_0"])
        conv(("linear_pred",), "linear_pred", tree["linear_pred"])

    def nnformer(tree):
        pe = tree["patch_embed"]
        for name in ("proj1_conv1", "proj1_conv2", "proj2_conv1",
                     "proj2_conv2"):
            conv(("patch_embed", name), f"patch_embed.{name}", pe[name])
        for name in ("proj1_norm", "proj1_norm2", "proj2_norm", "norm"):
            norm(("patch_embed", name), f"patch_embed.{name}", pe[name])
        for i, layer in numbered(tree, "layers_"):
            for j, blk in numbered(layer, "blocks_"):
                swin_block((f"layers_{i}", f"blocks_{j}"),
                           f"layers.{i}.blocks.{j}", blk)
            swin_merging((f"layers_{i}", "downsample"),
                         f"layers.{i}.downsample", layer["downsample"])
            norm((f"norm{i}",), f"norm{i}", tree[f"norm{i}"])
        for j, up in numbered(tree, "up_"):
            norm((f"up_{j}", "norm"), f"up.{j}.norm", up["norm"])
            kernel((f"up_{j}", "up", "ConvTranspose_0"), f"up.{j}.up",
                   up["up"]["ConvTranspose_0"], "convT")
            cp, cross = (f"dec_{j}_cross",), tree[f"dec_{j}_cross"]
            base = f"decoder.{j}.cross"
            norm(cp + ("norm1",), f"{base}.norm1", cross["norm1"])
            norm(cp + ("norm2",), f"{base}.norm2", cross["norm2"])
            for d in ("kv", "proj"):
                kernel(cp + ("attn", d), f"{base}.attn.{d}",
                       cross["attn"][d], "dense")
            table(cp + ("attn",), f"{base}.attn")
            dense_mlp(cp + ("mlp",), f"{base}.mlp", cross["mlp"])
            b = 1
            while f"dec_{j}_blocks_{b}" in tree:
                swin_block((f"dec_{j}_blocks_{b}",),
                           f"decoder.{j}.blocks.{b - 1}",
                           tree[f"dec_{j}_blocks_{b}"])
                b += 1
        for j, head in numbered(tree, "final_"):
            kernel((f"final_{j}", "ConvTranspose_0"), f"final.{j}",
                   head["ConvTranspose_0"], "convT")

    def swin_unetr_official(tree):
        vit = tree["swinViT"]
        conv(("swinViT", "patch_embed"), "swinViT.patch_embed.proj",
             vit["patch_embed"])
        official_stages(
            ("swinViT",), vit,
            lambda k: (f"layers{k + 1}_blocks", f"layers{k + 1}_downsample"),
            lambda k: f"swinViT.layers{k + 1}.0")
        if "encoder1" not in tree:     # the swinViT subtree alone
            return
        for name in ("encoder1", "encoder2", "encoder3", "encoder4",
                     "encoder10"):
            res_block((name,), f"{name}.layer", tree[name])
        for k in range(1, 6):
            dp, d = (f"decoder{k}",), tree[f"decoder{k}"]
            kernel(dp + ("transp_conv", "ConvTranspose_0"),
                   f"decoder{k}.transp_conv.conv",
                   d["transp_conv"]["ConvTranspose_0"], "convT")
            res_block(dp + ("conv_block",), f"decoder{k}.conv_block",
                      d["conv_block"])
        conv(("out", "conv"), "out.conv.conv", tree["out"]["conv"])

    def video_swin_encoder(enc):
        kernel(("encoder", "patch_embed"), "encoder.patch_embed.proj",
               enc["patch_embed"], "conv")
        if "patch_norm" in enc:
            norm(("encoder", "patch_norm"), "encoder.patch_embed.norm",
                 enc["patch_norm"])
        if "absolute_pos_embed" in enc:
            out.append((("encoder", "absolute_pos_embed"),
                        "encoder.absolute_pos_embed", "plain"))
        official_stages(
            ("encoder",), enc,
            lambda k: (f"layers_{k}_blocks_", f"layers_{k}_downsample"),
            lambda k: f"encoder.layers.{k}")

    def patch_embed3d(path, prefix, pe):
        # PatchEmbed3D: Conv_0, and its LayerNorm wrapper when it has one
        conv(path, f"{prefix}.proj", pe)
        if "LayerNorm_0" in pe:
            norm(path + ("LayerNorm_0",), f"{prefix}.norm", pe["LayerNorm_0"])

    def scales(path, prefix, p):
        # layer-scale vectors of a block
        for g in ("gamma_1", "gamma_2"):
            if g in p:
                out.append((path + (g,), f"{prefix}.{g}", "plain"))

    def focalnet_encoder(enc):
        patch_embed3d(("encoder", "patch_embed"), "encoder.patch_embed",
                      enc["patch_embed"])
        i = 0
        while f"layers_{i}_downsample" in enc:
            for j, blk in numbered(enc, f"layers_{i}_blocks_"):
                bp = ("encoder", f"layers_{i}_blocks_{j}")
                base = f"encoder.layers.{i}.blocks.{j}"
                norm(bp + ("norm1",), f"{base}.norm1", blk["norm1"])
                norm(bp + ("norm2",), f"{base}.norm2", blk["norm2"])
                mp, m = bp + ("modulation",), blk["modulation"]
                mod = f"{base}.modulation"
                kernel(mp + ("f",), f"{mod}.f", m["f"], "dense")
                for k, fl in numbered(m, "focal_layers_"):
                    conv(mp + (f"focal_layers_{k}",),
                         f"{mod}.focal_layers.{k}", fl)
                conv(mp + ("h",), f"{mod}.h", m["h"])
                kernel(mp + ("proj",), f"{mod}.proj", m["proj"], "dense")
                dense_mlp(bp + ("mlp",), f"{base}.mlp", blk["mlp"])
                scales(bp, base, blk)
            patch_embed3d(("encoder", f"layers_{i}_downsample"),
                          f"encoder.layers.{i}.downsample",
                          enc[f"layers_{i}_downsample"])
            norm(("encoder", f"norm{i}"), f"encoder.norm{i}", enc[f"norm{i}"])
            i += 1

    def lrg_encoder(enc):
        patch_embed3d(("encoder", "patch_embed_local"),
                      "encoder.patch_embed_local", enc["patch_embed_local"])
        for name, convs in (("patch_embed_region", ("down", "proj")),
                            ("patch_embed_global", ("down1", "down2",
                                                    "proj"))):
            pp, pe = ("encoder", name), enc[name]
            for c in convs:
                kernel(pp + (c,), f"encoder.{name}.{c}", pe[c], "conv")
            norm(pp + ("LayerNorm_0",), f"encoder.{name}.norm",
                 pe["LayerNorm_0"])
        i = 0
        while f"norm{i}" in enc:
            stage = f"encoder.layers.{i}"
            for j, blk in numbered(enc, f"layers_{i}_blocks_"):
                bp, base = ("encoder", f"layers_{i}_blocks_{j}"), \
                    f"{stage}.blocks.{j}"
                norm(bp + ("norm1",), f"{base}.norm1", blk["norm1"])
                norm(bp + ("norm2",), f"{base}.norm2", blk["norm2"])
                for d in ("qkv", "proj"):
                    for s in ("local", "region", "global"):
                        kernel(bp + ("attn", f"{d}_{s}"),
                               f"{base}.attn.{d}_{s}",
                               blk["attn"][f"{d}_{s}"], "dense")
                dense_mlp(bp + ("mlp",), f"{base}.mlp", blk["mlp"])
            for s in ("local", "region"):
                swin_merging(("encoder", f"downsample_{s}_{i}"),
                             f"{stage}.downsample_{s}",
                             enc[f"downsample_{s}_{i}"])
            kernel(("encoder", f"downsample_global_{i}"),
                   f"{stage}.downsample_global",
                   enc[f"downsample_global_{i}"], "dense")
            norm(("encoder", f"norm{i}"), f"encoder.norm{i}", enc[f"norm{i}"])
            i += 1

    def unetr(tree):
        vit = tree["vit"]
        conv(("vit", "patch_embed"), "vit.patch_embed.proj",
             vit["patch_embed"])
        for leaf in ("pos_embed", "cls_token"):
            if leaf in vit:
                out.append((("vit", leaf), f"vit.{leaf}", "plain"))
        for i, blk in numbered(vit, "blocks_"):
            bp, base = ("vit", f"blocks_{i}"), f"vit.blocks.{i}"
            norm(bp + ("norm1",), f"{base}.norm1", blk["norm1"])
            norm(bp + ("norm2",), f"{base}.norm2", blk["norm2"])
            for d in ("qkv", "proj"):
                kernel(bp + ("attn", d), f"{base}.attn.{d}", blk["attn"][d],
                       "dense")
            dense_mlp(bp + ("mlp",), f"{base}.mlp", blk["mlp"])
            scales(bp, base, blk)
        norm(("vit", "norm"), "vit.norm", vit["norm"])
        if "encoder1" not in tree:     # the vit subtree alone
            return
        res_block(("encoder1",), "encoder1", tree["encoder1"])
        for k in (2, 3, 4):
            ep, e = (f"encoder{k}",), tree[f"encoder{k}"]
            kernel(ep + ("transp_conv_init", "ConvTranspose_0"),
                   f"encoder{k}.transp_conv_init.conv",
                   e["transp_conv_init"]["ConvTranspose_0"], "convT")
            for i, up in numbered(e, "up_"):
                kernel(ep + (f"up_{i}", "ConvTranspose_0"),
                       f"encoder{k}.up.{i}.conv", up["ConvTranspose_0"],
                       "convT")
                res_block(ep + (f"res_{i}",), f"encoder{k}.res.{i}",
                          e[f"res_{i}"])
        for k in (5, 4, 3, 2):
            dp, d = (f"decoder{k}",), tree[f"decoder{k}"]
            kernel(dp + ("transp_conv", "ConvTranspose_0"),
                   f"decoder{k}.transp_conv.conv",
                   d["transp_conv"]["ConvTranspose_0"], "convT")
            res_block(dp + ("conv_block",), f"decoder{k}.conv_block",
                      d["conv_block"])
        conv(("out", "conv"), "out.conv.conv", tree["out"]["conv"])

    def swin2d(tree):
        bb, root = tree["backbone"], ("backbone",)
        pe = bb["patch_embed"]
        kernel(root + ("patch_embed", "proj"), "backbone.patch_embed.proj",
               pe["proj"], "conv2")
        norm(root + ("patch_embed", "norm"), "backbone.patch_embed.norm",
             pe["norm"])
        if "absolute_pos_embed" in bb:
            out.append((root + ("absolute_pos_embed",),
                        "backbone.absolute_pos_embed", "plain"))
        i = 0
        while f"layers_{i}_blocks_0" in bb:
            for j, blk in numbered(bb, f"layers_{i}_blocks_"):
                bp = root + (f"layers_{i}_blocks_{j}",)
                base = f"backbone.layers.{i}.blocks.{j}"
                norm(bp + ("norm1",), f"{base}.norm1", blk["norm1"])
                norm(bp + ("norm2",), f"{base}.norm2", blk["norm2"])
                for d in ("qkv", "proj"):
                    kernel(bp + ("attn", d), f"{base}.attn.{d}",
                           blk["attn"][d], "dense")
                table(bp + ("attn",), f"{base}.attn")
                dense_mlp(bp + ("mlp",), f"{base}.mlp", blk["mlp"])
            if f"layers_{i}_downsample" in bb:
                dp, d = root + (f"layers_{i}_downsample",), \
                    bb[f"layers_{i}_downsample"]
                norm(dp + ("norm",), f"backbone.layers.{i}.downsample.norm",
                     d["norm"])
                kernel(dp + ("reduction",),
                       f"backbone.layers.{i}.downsample.reduction",
                       d["reduction"], "dense")
            i += 1
        if "norm" in bb:
            norm(root + ("norm",), "backbone.norm", bb["norm"])
        if "head" in bb:
            kernel(root + ("head",), "backbone.head", bb["head"], "dense")
        for k, lin in numbered(tree, "linear_c"):
            kernel((f"linear_c{k}",), f"linear_c{k}", lin, "dense")
        kernel(("linear_fuse",), "linear_fuse", tree["linear_fuse"], "dense")
        norm(("fuse_norm",), "fuse_norm", tree["fuse_norm"])
        kernel(("linear_pred",), "linear_pred", tree["linear_pred"], "dense")

    if "swinViT" in params:
        swin_unetr_official(params)
        return out
    if "final_0" in params:
        nnformer(params)
        return out
    if "vit" in params:
        unetr(params)
        return out
    if "backbone" in params:
        swin2d(params)
        return out
    enc = params["encoder"]
    if "levels_0" in enc:
        gcvit_encoder(enc)
    elif "patch_embed1" in enc:
        segformer_encoder(enc)
    elif "patch_embed_local" in enc:
        lrg_encoder(enc)
    elif "modulation" in enc.get("layers_0_blocks_0", {}):
        focalnet_encoder(enc)
    elif "layers_0_downsample" in enc:
        video_swin_encoder(enc)
    else:
        swin_encoder(enc)
    if "decoder" in params:
        unetr_decoder(params["decoder"])
    elif "linear_pred" in params:
        segformer_head(params)
    return out


def _stats_paths(tree, path=()):
    """The paths of the BatchNorm statistics dicts ({'mean', 'var'}) of a
    ``batch_stats`` tree, in sorted order."""
    if "mean" in tree:
        return [path]
    return [p for k in sorted(tree) for p in _stats_paths(tree[k], path + (k,))]


def _get(tree, path):
    for k in path:
        tree = tree[k]
    return tree


def state_dict_from_jax(params: Dict) -> Dict[str, torch.Tensor]:
    """JAX parameter tree, or variables {'params': ..., 'batch_stats': ...},
    of a ported model (weights, or gradients or moments of the same
    structure) -> port state_dict."""
    return {key: _t(_TO_PORT[kind](np.asarray(_get(params, path))))
            for path, key, kind in key_map(params)}


def jax_tree_from_state_dict(sd: Dict[str, torch.Tensor],
                             template: Dict) -> Dict:
    """Port state_dict (or gradients keyed like it) -> nested dicts of numpy
    arrays in the JAX model's layout; ``template`` is any tree of that
    structure, parameters or variables (only its keys are read)."""
    tree: Dict = {}
    for path, key, kind in key_map(template):
        node = tree
        for k in path[:-1]:
            node = node.setdefault(k, {})
        a = sd[key].detach().cpu().numpy()
        node[path[-1]] = np.ascontiguousarray(_TO_JAX[kind](a))
    return tree


def load_adamw_state_from_optax(optimizer: torch.optim.Optimizer,
                                model: torch.nn.Module, mu: Dict, nu: Dict,
                                count: int) -> None:
    """Fill ``torch.optim.AdamW``'s state for ``model``'s parameters from an
    optax ``ScaleByAdamState``: first and second moments ``mu`` / ``nu``
    (trees shaped like the JAX parameters) and the update ``count``, so that
    the next update computes the same thing in both."""
    exp_avg, exp_avg_sq = state_dict_from_jax(mu), state_dict_from_jax(nu)
    for name, p in model.named_parameters():
        optimizer.state[p] = {
            "step": torch.tensor(float(count)),
            "exp_avg": exp_avg[name].to(p.device, p.dtype),
            "exp_avg_sq": exp_avg_sq[name].to(p.device, p.dtype),
        }


def strip_module_prefix(sd: Dict) -> Dict:
    """Drop the 'module.' prefix that DistributedDataParallel adds."""
    return {k[len("module."):] if k.startswith("module.") else k: v
            for k, v in sd.items()}


def load_checkpoint(path: str) -> Dict[str, torch.Tensor]:
    """A torch checkpoint file holding ``{'model': state_dict, ...}`` (the
    reference's layout) or a bare state_dict -> the model state_dict.
    Loaded with ``weights_only=True``: tensors and plain containers only."""
    payload = torch.load(path, map_location="cpu", weights_only=True)
    if isinstance(payload, dict) and isinstance(payload.get("model"), dict):
        payload = payload["model"]
    return strip_module_prefix(payload)


def _interp_grid(arr: np.ndarray, dst_shape) -> np.ndarray:
    """Trilinear resize of a (S1, S2, S3, C) grid to (*dst_shape, C) with
    align_corners=False sampling (torch F.interpolate semantics)."""
    from scipy.ndimage import map_coordinates

    src = arr.shape[:3]
    axes = [np.clip((np.arange(d) + 0.5) * s / d - 0.5, 0, s - 1)
            for d, s in zip(dst_shape, src)]
    grid = np.meshgrid(*axes, indexing="ij")
    coords = np.stack([g.ravel() for g in grid])
    out = np.empty(tuple(dst_shape) + arr.shape[3:], np.float32)
    for c in range(arr.shape[3]):
        out[..., c] = map_coordinates(
            arr[..., c].astype(np.float64), coords, order=1,
            mode="nearest").reshape(dst_shape)
    return out


def resize_rel_pos_bias_table(table: np.ndarray, src_window,
                              dst_window) -> np.ndarray:
    """Resize a 3D-window relative-position bias table across window sizes:
    (prod(2 ws - 1), nH) -> (prod(2 wd - 1), nH), the (2w - 1)^3 displacement
    grid resized trilinearly (align_corners=False) per head."""
    def grid_of(window):
        w3 = window if hasattr(window, "__len__") else (window,) * 3
        return tuple(2 * int(w) - 1 for w in w3)

    src, dst = grid_of(src_window), grid_of(dst_window)
    nh = table.shape[-1]
    if table.shape[0] != int(np.prod(src)):
        raise ValueError(f"table rows {table.shape[0]} != prod{src}")
    if src == dst:
        return table.astype(np.float32)
    grid = table.reshape(*src, nh).astype(np.float32)
    return _interp_grid(grid, dst).reshape(-1, nh)


def load_pretrained_encoder(model: torch.nn.Module, path: str) -> List[str]:
    """Load the ``encoder.*`` weights of the reference-format checkpoint at
    ``path`` into ``model`` (the rest of the model keeps its values) and
    return the keys loaded. A relative-position bias table whose row count
    differs from the model's (2 w - 1)^3 comes from another (cubic) window
    size and is resized to the model's. Class vectors stored a row a key
    (``encoder.lcv.vectors.{k}``, the reference's layout) are stacked. Raises if an encoder key of the
    model is missing from the file or the file has one the model lacks."""
    def window_of(rows: int) -> Tuple[int, int, int]:
        return (int(round((rows ** (1 / 3) + 1) / 2)),) * 3

    own = model.state_dict()
    enc = {k: v for k, v in load_checkpoint(path).items()
           if k.startswith("encoder.")}
    # the reference keeps the class vectors as a ParameterList, one row each
    rows = sorted((int(k.rsplit(".", 1)[1]), k) for k in enc
                  if k.startswith("encoder.lcv.vectors."))
    if rows:
        enc["encoder.lcv.vectors"] = torch.stack([enc.pop(k) for _, k in rows])
    for key, value in enc.items():
        if (key.endswith("relative_position_bias_table") and key in own
                and value.shape[0] != own[key].shape[0]):
            enc[key] = torch.from_numpy(resize_rel_pos_bias_table(
                value.float().numpy(), window_of(value.shape[0]),
                window_of(own[key].shape[0])))
    missing, unexpected = model.load_state_dict(enc, strict=False)
    missing = [k for k in missing if k.startswith("encoder.")]
    if missing or unexpected:
        raise KeyError(f"{path}: encoder keys missing {missing[:5]}, "
                       f"unexpected {list(unexpected)[:5]}")
    return sorted(enc)
