"""Reference R-Super torch checkpoints ↔ the port's MedFormer (the port's own
copy of ``rsuper_tpu/models/torch_port.py``).

The reference trains MedFormer in torch and ships ``.pth`` checkpoints
(``rsuper_train/train_ddp.py:184-197``: ``{'model_state_dict': ...,
'ema_model_state_dict': ...}``). ``convert_state_dict`` turns such a
state_dict into the flax parameter tree of the JAX package's MedFormer
(nested dicts of numpy arrays), which ``models/params.py:params_from_flax``
carries onto the port's model; ``export_state_dict`` is its exact inverse.
The mapping is numpy only:

* ``nn.Conv3d`` weight ``(O, I/g, kd, kh, kw)`` → flax ``(kd, kh, kw, I/g, O)``
  (one transpose covers dense, grouped and depthwise convs);
* ``nn.Linear`` ``(O, I)`` → flax ``(I, O)``;
* ``nn.LayerNorm`` ``weight/bias`` → flax ``scale/bias``;
* the bidirectional attention's qv projections: the reference splits their
  channels dim_head-major (``medformer_utils.py:46-52``
  ``view(b, dim_head, heads, -1)``), the model head-major: an exact
  permutation of the projection channels (``_perm_inner``).

Serve or train converted weights with ``MedFormer(torch_port=True)``
(``{"torch_port": true}`` in the model arguments): align-corners upsampling
and the torch default eps 1e-5 in the norms the reference does not build
through ``ConvNormAct``, so the forward pass is the reference's.
``python -m rsuper_tpu_torch.convert_checkpoint`` writes a converted
``.pth`` as a port checkpoint directory.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Sequence, Tuple

import numpy as np

from .params import _flatten, _strip_checkpoint

Transform = Callable[[np.ndarray], np.ndarray]


def _t_conv(w: np.ndarray) -> np.ndarray:
    """torch Conv3d (O, I/g, kd, kh, kw) → flax (kd, kh, kw, I/g, O)."""
    return np.transpose(w, (2, 3, 4, 1, 0))


def _t_conv_inv(w: np.ndarray) -> np.ndarray:
    return np.transpose(w, (4, 3, 0, 1, 2))


_t_conv.inv = _t_conv_inv
_t_conv_inv.inv = _t_conv


def _t_linear(w: np.ndarray) -> np.ndarray:
    return np.transpose(w, (1, 0))


_t_linear.inv = _t_linear  # 2-D transpose is an involution


def _ident(w: np.ndarray) -> np.ndarray:
    return np.asarray(w)


_ident.inv = _ident


def _perm_inner(heads: int, dim_head: int, axis: int,
                blocks: int = 1) -> Transform:
    """Reorder an `inner = heads*dim_head`-sized axis from the reference's
    dim_head-major channel factorisation to our head-major one. `blocks` = 2
    for the stacked q,v output channels (each permuted independently).
    ``.inv`` is the opposite reordering (used by the flax→torch export)."""

    def make(d0: int, d1: int):
        def f(w: np.ndarray) -> np.ndarray:
            w = np.asarray(w)
            ax = axis % w.ndim
            shape = w.shape
            split = shape[:ax] + (blocks, d0, d1) + shape[ax + 1:]
            w = w.reshape(split)
            w = np.swapaxes(w, ax + 1, ax + 2)
            return w.reshape(shape)

        return f

    f = make(dim_head, heads)
    f.inv = make(heads, dim_head)
    f.inv.inv = f
    return f


def _chain(*fns: Transform) -> Transform:
    def f(w):
        for fn in fns:
            w = fn(w)
        return w

    def inv(w):
        for fn in reversed(fns):
            w = fn.inv(w)
        return w

    f.inv = inv
    return f


class _MapBuilder:
    """Accumulates (torch_key → flax_path, transform) entries."""

    def __init__(self):
        self.entries: List[Tuple[str, Tuple[str, ...], Transform]] = []

    def add(self, torch_key: str, flax_path: str, transform: Transform):
        self.entries.append((torch_key, tuple(flax_path.split("/")), transform))

    def conv(self, tk: str, fp: str, bias: bool = False,
             out_t: Transform = None, in_t: Transform = None):
        """`out_t`/`in_t` are axis-bound transforms (``_perm_inner`` with
        axis=-1 for the flax kernel's O axis, axis=-2 for I)."""
        fns = [_t_conv] + [t for t in (in_t, out_t) if t]
        self.add(tk + ".weight", fp + "/kernel", _chain(*fns))
        if bias:
            self.add(tk + ".bias", fp + "/bias",
                     out_t if out_t else _ident)

    def dsconv(self, tk: str, fp: str, ch_t: Transform = None,
               out_t: Transform = None, in_t: Transform = None):
        """DepthwiseSeparableConv: depthwise (channel permute `ch_t` applies
        to its C axis, the flax kernel's last) + pointwise (in_t on I axis,
        out_t on O axis)."""
        dw_t = _chain(_t_conv, ch_t) if ch_t else _t_conv
        self.add(tk + ".depthwise.weight", fp + "/DepthwiseConv3_0/kernel",
                 dw_t)
        pw_fns = [_t_conv]
        if in_t:
            pw_fns.append(in_t)
        if out_t:
            pw_fns.append(out_t)
        self.add(tk + ".pointwise.weight", fp + "/Conv_0/kernel",
                 _chain(*pw_fns))

    def basic_block(self, tk: str, fp: str, shortcut: bool):
        self.conv(tk + ".conv1.conv", fp + "/ConvNormAct_0/Conv_0")
        self.conv(tk + ".conv2.conv", fp + "/ConvNormAct_1/Conv_0")
        if shortcut:
            self.conv(tk + ".shortcut.conv", fp + "/ConvNormAct_2/Conv_0")

    def mbconv(self, tk: str, fp: str):
        """Reference MBConv(out, out): expand 1x1 → depthwise k³ → SE →
        pointwise 1x1; in==out so no shortcut params (conv_layers.py:197)."""
        self.conv(tk + ".expand_proj.conv", fp + "/ConvNormAct_0/Conv_0")
        self.add(tk + ".depthwise.conv.weight",
                 fp + "/ConvNormAct_1/DepthwiseConv3_0/kernel", _t_conv)
        self.conv(tk + ".se.excitation.0", fp + "/SEBlock_0/Conv_0", bias=True)
        self.conv(tk + ".se.excitation.2", fp + "/SEBlock_0/Conv_1", bias=True)
        self.conv(tk + ".pointwise.conv", fp + "/ConvNormAct_2/Conv_0")

    def attention_block(self, tk: str, fp: str, heads: int, dim_head: int,
                        feat_dim: int, out_dim: int, no_map_out: bool):
        """BidirectionAttentionBlock (medformer_utils.py:104-140)."""
        qv_out = _perm_inner(heads, dim_head, axis=-1, blocks=2)
        inner_in = _perm_inner(heads, dim_head, axis=-2)
        inner_ch = _perm_inner(heads, dim_head, axis=-1)
        a_tk, a_fp = tk + ".attn", fp + "/BidirectionAttention_0"
        # feat_qv / feat_out are DepthwiseSeparableConv (proj_type depthwise)
        self.dsconv(a_tk + ".feat_qv", a_fp + "/DepthwiseSeparableConv_0",
                    out_t=qv_out)
        self.conv(a_tk + ".map_qv", a_fp + "/Conv_0", out_t=qv_out)
        self.dsconv(a_tk + ".feat_out", a_fp + "/DepthwiseSeparableConv_1",
                    ch_t=inner_ch, in_t=inner_in)
        if not no_map_out:
            self.conv(a_tk + ".map_out", a_fp + "/Conv_1", in_t=inner_in)
        if feat_dim != out_dim:
            self.conv(tk + ".shortcut.conv", fp + "/ConvNormAct_0/Conv_0")
        self.mbconv(tk + ".feedforward", fp + "/MBConv_0")

    def basic_layer(self, tk: str, fp: str, num_blocks: int, heads: int,
                    dim_head: int, feat_dim: int, out_dim: int,
                    no_map_out: bool):
        d1 = feat_dim
        for j in range(num_blocks):
            last = j == num_blocks - 1
            self.attention_block(
                f"{tk}.blocks.{j}", f"{fp}/BidirectionAttentionBlock_{j}",
                heads, dim_head, d1, out_dim, no_map_out and last)
            d1 = out_dim

    def transformer(self, tk: str, fp: str, depth: int):
        """trans_layers.py TransformerBlock: PreNorm(Attention)+PreNorm(Mlp).
        Reference `Attention` packs qkv head-major like ours — no permute."""
        for j in range(depth):
            self.add(f"{tk}.layers.{j}.0.norm.weight",
                     f"{fp}/LayerNorm_{2 * j}/scale", _ident)
            self.add(f"{tk}.layers.{j}.0.norm.bias",
                     f"{fp}/LayerNorm_{2 * j}/bias", _ident)
            self.add(f"{tk}.layers.{j}.0.fn.to_qkv.weight",
                     f"{fp}/MultiHeadSelfAttention_{j}/Dense_0/kernel",
                     _t_linear)
            self.add(f"{tk}.layers.{j}.0.fn.to_out.weight",
                     f"{fp}/MultiHeadSelfAttention_{j}/Dense_1/kernel",
                     _t_linear)
            self.add(f"{tk}.layers.{j}.0.fn.to_out.bias",
                     f"{fp}/MultiHeadSelfAttention_{j}/Dense_1/bias", _ident)
            self.add(f"{tk}.layers.{j}.1.norm.weight",
                     f"{fp}/LayerNorm_{2 * j + 1}/scale", _ident)
            self.add(f"{tk}.layers.{j}.1.norm.bias",
                     f"{fp}/LayerNorm_{2 * j + 1}/bias", _ident)
            self.add(f"{tk}.layers.{j}.1.fn.fc1.weight",
                     f"{fp}/Mlp_{j}/Dense_0/kernel", _t_linear)
            self.add(f"{tk}.layers.{j}.1.fn.fc1.bias",
                     f"{fp}/Mlp_{j}/Dense_0/bias", _ident)
            self.add(f"{tk}.layers.{j}.1.fn.fc2.weight",
                     f"{fp}/Mlp_{j}/Dense_1/kernel", _t_linear)
            self.add(f"{tk}.layers.{j}.1.fn.fc2.bias",
                     f"{fp}/Mlp_{j}/Dense_1/bias", _ident)


def medformer_key_map(
    base_chan: int = 32,
    chan_num: Sequence[int] = (64, 128, 256, 320, 256, 128, 64, 32),
    conv_num: Sequence[int] = (2, 0, 0, 0, 0, 0, 2, 2),
    trans_num: Sequence[int] = (0, 2, 4, 6, 4, 2, 0, 0),
    num_heads: Sequence[int] = (1, 4, 8, 10, 8, 4, 1, 1),
    fusion_depth: int = 2,
    aux_loss: bool = True,
    classification: bool = False,
    clip: bool = False,
) -> List[Tuple[str, Tuple[str, ...], Transform]]:
    """The full torch-key → flax-path map for a MedFormer configuration
    (defaults = the shipped ``config/abdomenatlas_ufo/medformer_3d.yaml``).

    Reference module tree: ``rsuper_train/model/dim3/medformer.py:120-141``
    (inc/down1..4/map_fusion/up1..4/aux_out/outc) over the blocks in
    ``medformer_utils.py`` / ``conv_layers.py`` / ``trans_layers.py``.
    """
    ch = list(chan_num)
    dim_head = [ch[i] // num_heads[i] for i in range(8)]
    b = _MapBuilder()

    # stem: inconv = plain conv + BasicBlock (medformer_utils.py:268-281)
    b.conv("inc.conv1", "Conv_0")
    b.basic_block("inc.conv2", "BasicBlock_0", shortcut=False)

    # encoder: down{i+1} ↔ DownBlockMF_{i}
    in_dim = base_chan
    for i in range(4):
        tk, fp = f"down{i + 1}", f"DownBlockMF_{i}"
        b.dsconv(tk + ".patch_merging.reduction",
                 fp + "/PatchMerging_0/DepthwiseSeparableConv_0")
        for j in range(conv_num[i]):
            b.basic_block(f"{tk}.conv_blocks.{j}", f"{fp}/BasicBlock_{j}",
                          shortcut=False)
        if i >= 1:  # map_generate on down2..4
            b.conv(tk + ".map_gen.base_proj",
                   fp + "/SemanticMapGeneration_0/Conv_0")
            b.conv(tk + ".map_gen.semantic_proj",
                   fp + "/SemanticMapGeneration_0/Conv_1")
        if trans_num[i]:
            b.basic_layer(tk + ".trans_blocks", fp + "/BasicLayer_0",
                          trans_num[i], num_heads[i], dim_head[i],
                          feat_dim=ch[i], out_dim=ch[i], no_map_out=False)
        in_dim = ch[i]

    # semantic-map fusion (medformer_utils.py:234-264)
    for i in range(3):
        b.conv(f"map_fusion.in_proj.{i}", f"SemanticMapFusion_0/in_proj{i}")
        b.conv(f"map_fusion.out_proj.{i}", f"SemanticMapFusion_0/out_proj{i}")
    b.transformer("map_fusion.fusion", "SemanticMapFusion_0/TransformerBlock_0",
                  fusion_depth)

    # decoder: up{i+1} ↔ UpBlockMF_{i}; feat dim into the attention layer is
    # in_ch+out_ch (skip concat), map_shortcut on up1/up2 only
    for i in range(4):
        stage = i + 4
        tk, fp = f"up{i + 1}", f"UpBlockMF_{i}"
        in_ch, out_ch = ch[stage - 1], ch[stage]
        if i < 2:  # map_shortcut
            b.conv(tk + ".map_reduction", fp + "/Conv_0")
        if trans_num[stage]:
            b.basic_layer(tk + ".trans_blocks", fp + "/BasicLayer_0",
                          trans_num[stage], num_heads[stage], dim_head[stage],
                          feat_dim=in_ch + out_ch, out_dim=out_ch,
                          no_map_out=(i == 1))
        d1 = out_ch if trans_num[stage] else in_ch + out_ch
        for j in range(conv_num[stage]):
            b.basic_block(f"{tk}.conv_blocks.{j}", f"{fp}/BasicBlock_{j}",
                          shortcut=(d1 != out_ch))
            d1 = out_ch

    if aux_loss:
        b.conv("aux_out", "aux_out", bias=True)
    b.conv("outc", "outc", bias=True)

    for flag, tname, fname in ((classification, "classification_branch",
                                "cls"), (clip, "clip_branch", "clip")):
        if not flag:
            continue
        tk, fp = tname + ".extra_layer", fname + "_extra"
        b.dsconv(tk + ".patch_merging.reduction",
                 fp + "/PatchMerging_0/DepthwiseSeparableConv_0")
        b.conv(tk + ".map_gen.base_proj",
               fp + "/SemanticMapGeneration_0/Conv_0")
        b.conv(tk + ".map_gen.semantic_proj",
               fp + "/SemanticMapGeneration_0/Conv_1")
        b.basic_layer(tk + ".trans_blocks", fp + "/BasicLayer_0", 1, 4,
                      dim_head[3], feat_dim=ch[3] // 2, out_dim=ch[3] // 2,
                      no_map_out=False)
        b.conv(tname + ".reducer", fname + "_branch/Conv_0", bias=True)
        b.transformer(tname + ".transformer",
                      fname + "_branch/TransformerBlock_0", 1)
        b.add(tname + ".head.weight", fname + "_branch/Dense_0/kernel",
              _t_linear)
        b.add(tname + ".head.bias", fname + "_branch/Dense_0/bias", _ident)

    return b.entries


def strip_prefixes(state: Dict[str, Any]) -> Dict[str, np.ndarray]:
    """Unwrap the reference's save format: pick `model_state_dict` (or
    `ema_model_state_dict` via convert_state_dict(..., ema=True) upstream)
    and drop DDP's `module.` / compile's `_orig_mod.` prefixes."""
    out = {}
    for k, v in state.items():
        for pre in ("module.", "_orig_mod."):
            if k.startswith(pre):
                k = k[len(pre):]
        out[k] = np.asarray(v)
    return out


def convert_state_dict(
    state: Dict[str, Any], *, strict: bool = True, **map_kwargs
) -> Tuple[Dict[str, Any], List[str], List[str]]:
    """torch state_dict → nested flax ``params`` dict.

    Returns (params, missing_torch_keys, unused_torch_keys). With
    ``strict=True`` raises if any mapped torch key is absent.
    """
    state = strip_prefixes(state)
    entries = medformer_key_map(**map_kwargs)
    params: Dict[str, Any] = {}
    missing: List[str] = []
    used = set()
    for tk, path, transform in entries:
        if tk not in state:
            missing.append(tk)
            continue
        used.add(tk)
        leaf = transform(np.asarray(state[tk], dtype=np.float32))
        node = params
        for p in path[:-1]:
            node = node.setdefault(p, {})
        node[path[-1]] = leaf
    unused = [k for k in state if k not in used]
    if strict and missing:
        raise KeyError(
            f"{len(missing)} torch keys missing (first 10): {missing[:10]}")
    return params, missing, unused


def export_state_dict(params: Dict[str, Any], **map_kwargs
                      ) -> Dict[str, np.ndarray]:
    """Inverse of :func:`convert_state_dict`: a flax ``params`` tree (nested,
    or flat ``{"a/b/kernel": array}`` as ``models/params.py:
    flax_from_state_dict`` gives it; remat's ``Checkpoint`` prefixes are
    dropped) → reference torch state_dict arrays. Exact round trip."""
    if "params" in params and len(params) == 1:
        params = params["params"]
    flat = {"/".join(_strip_checkpoint(p) for p in k.split("/")): v
            for k, v in _flatten(params).items()}
    out: Dict[str, np.ndarray] = {}
    for tk, path, transform in medformer_key_map(**map_kwargs):
        key = "/".join(path)
        if key not in flat:
            raise KeyError(
                f"flax param {key} (for torch key {tk}) missing — check the "
                "map kwargs match the model config")
        out[tk] = transform.inv(np.asarray(flat[key], dtype=np.float32))
    return out
