"""MedFormer 3D in PyTorch (counterpart of ``rsuper_tpu/models/medformer.py``).

Every configuration of the JAX model builds, and the route is chosen by
the function the configuration computes: the stem and every stage whose
conv blocks are BasicBlocks with instance norm, ReLU and 3³ kernels and
that has no attention run channel-first ``(B, D, C, H, W)`` through the
CUDA conv kernels (``BasicBlockCF``); everything else runs channels-last,
its convs on cuDNN (``layers.Conv``) and its 3³ stride-1 depthwise convs on
the depthwise kernel. In the default configuration that is the stem,
``DownBlockMF_0`` and the last two decoder stages, as in the JAX model's
default. Module names equal the flax
tree's (remat's ``Checkpoint`` prefix aside), so ``models/params.py`` maps a
JAX checkpoint onto this model one parameter at a time. With ``remat`` the
down and up blocks run under ``torch.utils.checkpoint`` as the JAX model
wraps them in ``nn.remat``: same loss and gradients, parameter names
unchanged.

With ``classification_classes`` and ``clip_branch`` the model has the
JAX model's two encoder heads (``cls_extra``/``cls_branch``,
``clip_extra``/``clip_branch``): an extra attention ``DownBlockMF`` on the
deepest features, then a ``ClassificationBranch``, not rematerialised.
``encoder`` and ``branches`` are the parts of ``forward`` that the heads
read, so a CLIP step runs them alone, without the decoder.

With ``torch_port`` the model computes as the reference's torch model
does, for weights imported from a reference ``.pth``
(``models/torch_port.py``): align-corners upsampling and the torch default
eps 1e-5 in the norms the reference does not build through ``ConvNormAct``
(the attention blocks', the patch merges', the LayerNorms), as the JAX
model's ``torch_port`` option. The instance norms of the conv blocks keep
1e-4 either way.

The JAX model's ``cf_fullres`` and ``cf_halfres`` choose the TPU's layout
and leave its function and parameter tree unchanged (which
``tests/test_models.py`` asserts); the port accepts them and routes as
above either way. The configurations the JAX model fails to build raise
``ValueError`` here: attention in the first encoder stage (it has no
semantic map) and attention after ``UpBlockMF_1`` on a semantic map of
another width.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from .layers import (
    BLOCKS,
    BasicBlockCF,
    CFConv1,
    CFConv3,
    Conv,
    Conv1,
    ConvNormAct,
    Dense,
    DepthwiseSeparableConv,
    FusedMBConv,
    MBConv,
    TransformerBlock,
    instance_norm,
    instance_norm_axes,
    is_3cubed,
    resize_trilinear,
    resize_trilinear_cf,
)


class SemanticMapGeneration(nn.Module):
    """Pool (B, D, H, W, C) into a (B, 3, 3, 3, map_dim) semantic map by
    learned spatial attention. Its two 3³ convs were never Pallas kernels in
    the JAX package; here they run on cuDNN (``layers.Conv``, ``weight`` in
    torch layout)."""

    def __init__(self, c_in: int, map_dim: int, map_size=(3, 3, 3),
                 dtype=torch.float32):
        super().__init__()
        code = map_size[0] * map_size[1] * map_size[2]
        self.Conv_0 = Conv(c_in, map_dim, 3, use_bias=False, dtype=dtype)
        self.Conv_1 = Conv(c_in, code, 3, use_bias=False, dtype=dtype)
        self.map_dim, self.map_size, self.code = map_dim, tuple(map_size), code

    def forward(self, x):
        b = x.shape[0]
        feat = self.Conv_0(x).reshape(b, -1, self.map_dim)
        weight = self.Conv_1(x).reshape(b, -1, self.code)
        weight = torch.softmax(weight.float(), dim=1).to(x.dtype)
        sem = torch.einsum("bsm,bsk->bkm", feat, weight)
        return sem.reshape(b, *self.map_size, self.map_dim)


def to_cf(x, cf: bool):
    """(B, D, H, W, C) → (B, D, C, H, W); a tensor already channel-first
    (`cf`) is returned as it is."""
    return x if cf else x.permute(0, 1, 4, 2, 3).contiguous()


def to_cl(x, cf: bool):
    """(B, D, C, H, W) → (B, D, H, W, C) when `cf`, else `x`."""
    return x.permute(0, 1, 3, 4, 2).contiguous() if cf else x


def cf_stage(conv_block: str, norm: str, act: str, kernel_size) -> bool:
    """True when a stage's conv blocks compute what the channel-first
    BasicBlock of the CUDA conv kernels computes: pre-activated BasicBlocks
    with instance norm, ReLU and 3³ kernels. The caller adds that the stage
    has conv blocks and no attention."""
    return (conv_block == "BasicBlock" and norm == "in" and act == "relu"
            and is_3cubed(kernel_size))


def _qv_proj(c_in: int, c_out: int, proj_type: str, kernel_size, dtype):
    """The feature side's projection: depthwise-separable k³ or 1×1."""
    if proj_type == "depthwise":
        return DepthwiseSeparableConv(c_in, c_out, kernel_size, dtype=dtype)
    return Conv1(c_in, c_out, False, dtype)


class BidirectionAttention(nn.Module):
    """Cross-attention both ways between feature tokens and the 27 map
    tokens; the (2, heads, dim_head) channel split of the JAX model. The
    feature side projects with depthwise-separable convs
    (``DepthwiseSeparableConv_0/1``, the map side ``Conv_0/1``) or, with
    ``proj_type="linear"``, 1×1 convs (``Conv_0`` … ``Conv_3`` in call
    order)."""

    def __init__(self, feat_dim: int, map_dim: int, out_dim: int, heads: int,
                 dim_head: int, map_size=(3, 3, 3), proj_type="depthwise",
                 kernel_size=3, no_map_out: bool = False,
                 dtype=torch.float32):
        super().__init__()
        inner = heads * dim_head
        names = (("DepthwiseSeparableConv_0", "Conv_0",
                  "DepthwiseSeparableConv_1", "Conv_1")
                 if proj_type == "depthwise"
                 else ("Conv_0", "Conv_1", "Conv_2", "Conv_3"))
        self.names = names
        self.add_module(names[0], _qv_proj(feat_dim, inner * 2, proj_type,
                                           kernel_size, dtype))
        self.add_module(names[1], Conv1(map_dim, inner * 2, False, dtype))
        self.add_module(names[2], _qv_proj(inner, out_dim, proj_type,
                                           kernel_size, dtype))
        if not no_map_out:
            self.add_module(names[3], Conv1(inner, map_dim, False, dtype))
        self.heads, self.dim_head = heads, dim_head
        self.map_size, self.no_map_out = tuple(map_size), no_map_out

    def forward(self, feat, sem):
        b, d, h, w, _ = feat.shape
        inner = self.heads * self.dim_head
        feat_qv = getattr(self, self.names[0])(feat)
        map_qv = getattr(self, self.names[1])(sem)

        def tokens(t):
            """(B, *, inner*2) -> q, v each (B, heads, L, dim_head)."""
            t = t.reshape(b, -1, 2, self.heads, self.dim_head)
            t = t.permute(2, 0, 3, 1, 4)
            return t[0], t[1]

        feat_q, feat_v = tokens(feat_qv)
        map_q, map_v = tokens(map_qv)
        attn = (feat_q @ map_q.transpose(-1, -2)) * (self.dim_head ** -0.5)
        attn32 = attn.float()
        feat_map_attn = torch.softmax(attn32, dim=-1).to(feat.dtype)
        map_feat_attn = torch.softmax(attn32, dim=-2).to(feat.dtype)

        feat_out = feat_map_attn @ map_v
        feat_out = feat_out.permute(0, 2, 1, 3).reshape(b, d, h, w, inner)
        map_out = map_feat_attn.transpose(-1, -2) @ feat_v
        map_out = map_out.permute(0, 2, 1, 3).reshape(b, *self.map_size,
                                                       inner)
        feat_out = getattr(self, self.names[2])(feat_out)
        if not self.no_map_out:
            map_out = getattr(self, self.names[3])(map_out)
        return feat_out, map_out


class BidirectionAttentionBlock(nn.Module):
    """norm → bidirectional attention → residual → feed-forward: an MBConv
    of the stage's kernel (``proj_type="depthwise"``) or a FusedMBConv of
    1³ kernels (``"linear"``), with the model's norm and activation."""

    def __init__(self, feat_dim: int, map_dim: int, out_dim: int, heads: int,
                 dim_head: int, expansion: int = 4, map_size=(3, 3, 3),
                 proj_type: str = "depthwise", kernel_size=3,
                 no_map_out: bool = False, norm: str = "in",
                 act: str = "relu", norm_eps: float = 1e-4,
                 dtype=torch.float32):
        super().__init__()
        self.BidirectionAttention_0 = BidirectionAttention(
            feat_dim, map_dim, out_dim, heads, dim_head, map_size, proj_type,
            kernel_size, no_map_out, dtype)
        self.shortcut = feat_dim != out_dim
        if self.shortcut:
            self.ConvNormAct_0 = ConvNormAct(feat_dim, out_dim, 1, norm=norm,
                                             act=act, preact=True,
                                             dtype=dtype)
        if proj_type == "depthwise":
            self.ff = "MBConv_0"
            ff = MBConv(out_dim, out_dim, expansion, kernel_size, norm=norm,
                        act=act, dtype=dtype)
        else:
            self.ff = "FusedMBConv_0"
            ff = FusedMBConv(out_dim, out_dim, expansion, 1, norm=norm,
                             act=act, dtype=dtype)
        self.add_module(self.ff, ff)
        self.no_map_out, self.norm_eps = no_map_out, norm_eps

    def forward(self, x, sem):
        feat = instance_norm(x, self.norm_eps)
        mapp = instance_norm(sem, self.norm_eps)
        out, map_out = self.BidirectionAttention_0(feat, mapp)
        shortcut = self.ConvNormAct_0(x) if self.shortcut else x
        out = getattr(self, self.ff)(out + shortcut)
        if not self.no_map_out:
            map_out = map_out + sem
        return out, map_out


class BasicLayer(nn.Module):
    def __init__(self, num_blocks: int, feat_dim: int, map_dim: int,
                 out_dim: int, heads: int, dim_head: int, expansion: int = 4,
                 map_size=(3, 3, 3), no_map_out: bool = False,
                 norm_eps: float = 1e-4, dtype=torch.float32, **block):
        super().__init__()
        self.num_blocks = num_blocks
        for i in range(num_blocks):
            last = i == num_blocks - 1
            self.add_module(f"BidirectionAttentionBlock_{i}",
                            BidirectionAttentionBlock(
                                feat_dim if i == 0 else out_dim, map_dim,
                                out_dim, heads, dim_head, expansion, map_size,
                                no_map_out=no_map_out and last,
                                norm_eps=norm_eps, dtype=dtype, **block))

    def forward(self, x, sem):
        for i in range(self.num_blocks):
            x, sem = getattr(self, f"BidirectionAttentionBlock_{i}")(x, sem)
        return x, sem


class PatchMerging(nn.Module):
    """Space-to-depth by `down_scale` + instance norm + a depthwise-separable
    k³ reduction (``DepthwiseSeparableConv_0``) or, with
    ``proj_type="linear"``, a 1×1 ``Conv_0``. The merged channel order is
    (sd, sh, sw, c) for channel-first and channels-last input alike, as in
    the JAX model."""

    def __init__(self, c_in: int, out_dim: int, down_scale=(2, 2, 2),
                 proj_type: str = "depthwise", kernel_size=3,
                 norm_eps: float = 1e-4, cf_input: bool = False,
                 dtype=torch.float32):
        super().__init__()
        sd, sh, sw = down_scale
        self.proj = ("DepthwiseSeparableConv_0" if proj_type == "depthwise"
                     else "Conv_0")
        self.add_module(self.proj, _qv_proj(sd * sh * sw * c_in, out_dim,
                                            proj_type, kernel_size, dtype))
        self.down_scale, self.norm_eps = tuple(down_scale), norm_eps
        self.cf_input = cf_input

    def forward(self, x):
        sd, sh, sw = self.down_scale
        if self.cf_input:
            b, d, c, h, w = x.shape
            x = x.reshape(b, d // sd, sd, c, h // sh, sh, w // sw, sw)
            x = instance_norm_axes(x, (1, 4, 6), self.norm_eps)
            x = x.permute(0, 1, 4, 6, 2, 5, 7, 3)
        else:
            b, d, h, w, c = x.shape
            x = x.reshape(b, d // sd, sd, h // sh, sh, w // sw, sw, c)
            x = instance_norm_axes(x, (1, 3, 5), self.norm_eps)
            x = x.permute(0, 1, 3, 5, 2, 4, 6, 7)
        x = x.reshape(b, d // sd, h // sh, w // sw, sd * sh * sw * c)
        return getattr(self, self.proj)(x)


def _conv_blocks(module: nn.Module, n: int, c_in: int, out_dim: int,
                 cf: bool, conv_block: str, kernel_size, norm: str, act: str,
                 dtype) -> list:
    """Add a stage's `n` conv blocks to `module`: channel-first
    ``BasicBlock_i`` (``BasicBlockCF``, the CUDA conv kernels) when `cf`,
    else ``{conv_block}_i`` of ``BLOCKS`` (cuDNN). Returns their names."""
    names = [f"{conv_block}_{i}" for i in range(n)]
    for i, name in enumerate(names):
        c = c_in if i == 0 else out_dim
        module.add_module(name, BasicBlockCF(c, out_dim, dtype) if cf else
                          BLOCKS[conv_block](c, out_dim,
                                             kernel_size=kernel_size,
                                             norm=norm, act=act, dtype=dtype))
    return names


class DownBlockMF(nn.Module):
    """patch-merge → conv blocks → (semantic-map generation) → attention
    blocks. The conv blocks run channel-first when `cf_convs`
    (``cf_stage``, no attention in the stage); the block returns
    channel-first output when they do and nothing after them needs
    channels-last (`cf_output`: no map, no attention). `cf_input`: the
    input arrives channel-first."""

    def __init__(self, c_in: int, out_dim: int, conv_num: int, trans_num: int,
                 heads: int, dim_head: int, expansion: int = 4,
                 down_scale=(2, 2, 2), map_size=(3, 3, 3),
                 proj_type: str = "depthwise", kernel_size=3,
                 conv_block: str = "BasicBlock", norm: str = "in",
                 act: str = "relu", map_generate: bool = False,
                 cf_convs: bool = False, cf_input: bool = False,
                 torch_port: bool = False, dtype=torch.float32):
        super().__init__()
        block_eps = 1e-5 if torch_port else 1e-4
        self.cf_convs = cf_convs and conv_num > 0
        self.cf_output = self.cf_convs and not (map_generate or trans_num)
        self.PatchMerging_0 = PatchMerging(c_in, out_dim, down_scale,
                                           proj_type, kernel_size, block_eps,
                                           cf_input, dtype)
        self.blocks = _conv_blocks(self, conv_num, out_dim, out_dim,
                                   self.cf_convs, conv_block, kernel_size,
                                   norm, act, dtype)
        if map_generate:
            self.SemanticMapGeneration_0 = SemanticMapGeneration(
                out_dim, out_dim, map_size, dtype)
        if trans_num:
            self.BasicLayer_0 = BasicLayer(
                trans_num, out_dim, out_dim, out_dim, heads, dim_head,
                expansion, map_size, norm_eps=block_eps, dtype=dtype,
                proj_type=proj_type, kernel_size=kernel_size, norm=norm,
                act=act)
        self.trans_num, self.map_generate = trans_num, map_generate

    def forward(self, x):
        x = self.PatchMerging_0(x)
        if self.cf_convs:
            x = to_cf(x, False)
        for name in self.blocks:
            x = getattr(self, name)(x)
        if self.cf_output:
            return x, None
        x = to_cl(x, self.cf_convs)
        sem = self.SemanticMapGeneration_0(x) if self.map_generate else None
        if self.trans_num:
            x, sem = self.BasicLayer_0(x, sem)
        return x, sem


class UpBlockMF(nn.Module):
    """upsample + skip-concat (+ map shortcut ``Conv_0``) → attention
    blocks → conv blocks. With `cf` (``cf_stage``, no attention) it works
    channel-first from the concatenation on, its conv blocks on the CUDA
    conv kernels, and returns channel-first output; else channels-last.
    `low_cf` and `skip_cf` give the layouts its inputs arrive in."""

    def __init__(self, c_low: int, c_skip: int, out_dim: int, conv_num: int,
                 trans_num: int, heads: int, dim_head: int,
                 expansion: int = 4, map_size=(3, 3, 3),
                 proj_type: str = "depthwise", kernel_size=3,
                 conv_block: str = "BasicBlock", norm: str = "in",
                 act: str = "relu", map_shortcut: bool = False,
                 map_dims=(0, 0), no_map_out: bool = False, cf: bool = False,
                 low_cf: bool = False, skip_cf: bool = False,
                 torch_port: bool = False, dtype=torch.float32):
        super().__init__()
        self.cf = cf and conv_num > 0 and trans_num == 0
        self.low_cf, self.skip_cf = low_cf, skip_cf
        if map_shortcut:
            self.Conv_0 = Conv1(map_dims[0] + map_dims[1], out_dim, False,
                                dtype)
        c = c_low + c_skip
        if trans_num:
            self.BasicLayer_0 = BasicLayer(
                trans_num, c, out_dim, out_dim, heads, dim_head, expansion,
                map_size, no_map_out,
                norm_eps=1e-5 if torch_port else 1e-4, dtype=dtype,
                proj_type=proj_type, kernel_size=kernel_size, norm=norm,
                act=act)
            c = out_dim
        self.blocks = _conv_blocks(self, conv_num, c, out_dim, self.cf,
                                   conv_block, kernel_size, norm, act, dtype)
        self.trans_num = trans_num
        self.map_shortcut, self.align_corners = map_shortcut, torch_port

    def forward(self, x_low, x_skip, map_low, map_skip=None):
        if self.cf:  # the resize reads the low input through a view
            low = x_low if self.low_cf else x_low.permute(0, 1, 4, 2, 3)
            skip = to_cf(x_skip, self.skip_cf)
            sk = skip.shape
            x = resize_trilinear_cf(low, (sk[1], sk[3], sk[4]),
                                    self.align_corners).to(low.dtype)
            feat = torch.cat([x, skip.to(x.dtype)], dim=2)
        else:
            low, skip = to_cl(x_low, self.low_cf), to_cl(x_skip, self.skip_cf)
            x = resize_trilinear(low, skip.shape[1:4],
                                 self.align_corners).to(low.dtype)
            feat = torch.cat([x, skip.to(x.dtype)], dim=-1)
        if self.map_shortcut and map_skip is not None:
            sem = self.Conv_0(torch.cat([map_low, map_skip], dim=-1))
        else:
            sem = map_low
        if self.trans_num:
            feat, sem = self.BasicLayer_0(feat, sem)
        for name in self.blocks:
            feat = getattr(self, name)(feat)
        return feat, sem


class SemanticMapFusion(nn.Module):
    """Fuse the three encoder semantic maps with a small transformer."""

    def __init__(self, in_dims: Sequence[int], dim: int, heads: int,
                 depth: int = 2, ln_eps: float = 1e-6, dtype=torch.float32):
        super().__init__()
        for i, c in enumerate(in_dims):
            self.add_module(f"in_proj{i}", Conv1(c, dim, False, dtype))
            self.add_module(f"out_proj{i}", Conv1(dim, c, False, dtype))
        self.TransformerBlock_0 = TransformerBlock(dim, depth, heads,
                                                   dim // heads, dim, ln_eps,
                                                   dtype)
        self.n, self.dim = len(in_dims), dim

    def forward(self, maps):
        b = maps[0].shape[0]
        toks = [getattr(self, f"in_proj{i}")(m).reshape(b, -1, self.dim)
                for i, m in enumerate(maps)]
        fused = self.TransformerBlock_0(torch.cat(toks, dim=1))
        outs, start = [], 0
        for i, m in enumerate(maps):
            n = toks[i].shape[1]
            seg = fused[:, start:start + n].reshape(b, *m.shape[1:4], self.dim)
            start += n
            outs.append(getattr(self, f"out_proj{i}")(seg))
        return outs


class ClassificationBranch(nn.Module):
    """Bottleneck classifier: 1×1 conv (with bias) to `reduced_dim` → one
    transformer block → the mean over the tokens → a float32 ``Dense``
    (the JAX model's ``ClassificationBranch``, reference
    ``medformer.py:12-78``)."""

    def __init__(self, c_in: int, num_outputs: int, reduced_dim: int = 64,
                 heads: int = 4, dim_head: int = 16, mlp_dim: int = 320,
                 ln_eps: float = 1e-6, dtype=torch.float32):
        super().__init__()
        self.Conv_0 = Conv1(c_in, reduced_dim, True, dtype)
        self.TransformerBlock_0 = TransformerBlock(
            reduced_dim, 1, heads, dim_head, mlp_dim, ln_eps, dtype)
        self.Dense_0 = Dense(reduced_dim, num_outputs, True, torch.float32)
        self.reduced_dim = reduced_dim

    def forward(self, x):
        t = self.Conv_0(x).reshape(x.shape[0], -1, self.reduced_dim)
        t = self.TransformerBlock_0(t)
        t = t.float().mean(dim=1).to(t.dtype)
        return self.Dense_0(t)


class MedFormer(nn.Module):
    """(B, D, H, W, 1) volumes → ``{"segmentation": [logits, aux]}`` (or
    ``logits`` alone without ``aux_loss``), channels-last, in ``dtype``;
    with the heads also ``"classification"`` (B, classification_classes)
    and ``"clip"`` (B, clip_feats), float32.

    Every configuration the JAX model builds builds here. The stem and each
    stage whose conv blocks ``cf_stage`` admits and that has no attention
    run channel-first on the CUDA conv kernels; the rest run channels-last
    on cuDNN. ``cf_fullres`` and ``cf_halfres`` are the JAX model's TPU
    layout switches: its function and parameter tree do not depend on them,
    so they are accepted and change nothing here."""

    def __init__(self, num_classes: int, base_chan: int = 32,
                 map_size: Tuple[int, int, int] = (3, 3, 3),
                 conv_block: str = "BasicBlock",
                 conv_num: Sequence[int] = (2, 0, 0, 0, 0, 0, 2, 2),
                 trans_num: Sequence[int] = (0, 2, 4, 6, 4, 2, 0, 0),
                 chan_num: Sequence[int] = (64, 128, 256, 320, 256, 128, 64,
                                            32),
                 num_heads: Sequence[int] = (1, 4, 8, 10, 8, 4, 1, 1),
                 fusion_depth: int = 2, fusion_dim: int = 320,
                 fusion_heads: int = 10, expansion: int = 4,
                 proj_type: str = "depthwise", norm: str = "in",
                 act: str = "relu", kernel_size=(3, 3, 3, 3, 3),
                 scale=((2, 2, 2),) * 4, aux_loss: bool = True,
                 classification_classes: int = 0, clip_branch: bool = False,
                 clip_feats: int = 768, remat: bool = True,
                 cf_fullres: bool = True, cf_halfres: bool = True,
                 torch_port: bool = False, dtype=torch.float32):
        super().__init__()
        cn, tn, ch, nh = conv_num, trans_num, chan_num, num_heads
        if tn[0]:
            # DownBlockMF_0 generates no semantic map, and the JAX model's
            # attention blocks fail on the missing map there
            raise ValueError("trans_num[0] must be 0: the first encoder "
                             "stage has no semantic map to attend to")
        scale = [tuple(s) if isinstance(s, (tuple, list)) else (s,) * 3
                 for s in scale]
        ks = [k if isinstance(k, int) else tuple(k) for k in kernel_size]
        dim_head = [ch[i] // nh[i] for i in range(8)]
        # an attention stage after UpBlockMF_1 adds its map output to the
        # map it receives: the widths must agree, as the JAX model's add does
        width = nh[5] * dim_head[5] if tn[5] else ch[5]
        for i in (6, 7):
            if tn[i] and width != ch[i]:
                raise ValueError(
                    f"trans_num[{i}] > 0 needs chan_num[{i}] equal to the "
                    f"width of the semantic map it receives ({width})")
            width = ch[i] if tn[i] else width
        self.num_classes, self.aux_loss, self.dtype = num_classes, aux_loss, \
            dtype
        self.remat, self.torch_port = remat, torch_port
        ln_eps = 1e-5 if torch_port else 1e-6
        blk = dict(conv_block=conv_block, norm=norm, act=act)

        def cf(i, k):
            return cf_stage(conv_block, norm, act, k) and cn[i] > 0 \
                and tn[i] == 0

        # the stem: Conv_0 + one block, channel-first on the CUDA kernels
        # (the stem kernel, then a BasicBlockCF) where its block allows
        self.stem_cf = cf_stage(conv_block, norm, act, ks[0])
        if self.stem_cf:
            self.Conv_0 = CFConv3(1, base_chan, dtype=dtype)
            self.stem = "BasicBlock_0"
            self.BasicBlock_0 = BasicBlockCF(base_chan, base_chan, dtype)
        else:
            self.Conv_0 = Conv(1, base_chan, 3, use_bias=False, dtype=dtype)
            self.stem = f"{conv_block}_0"
            self.add_module(self.stem, BLOCKS[conv_block](
                base_chan, base_chan, kernel_size=ks[0], norm=norm, act=act,
                dtype=dtype))
        c_prev, prev_cf = base_chan, self.stem_cf
        self.skip_cf = [self.stem_cf]  # layout of x0 … x4
        for i in range(4):
            down = DownBlockMF(
                c_prev, ch[i], cn[i], tn[i], nh[i], dim_head[i], expansion,
                scale[i], map_size, proj_type, ks[min(i + 1, 4)],
                map_generate=i >= 1, cf_convs=cf(i, ks[min(i + 1, 4)]),
                cf_input=prev_cf, torch_port=torch_port, dtype=dtype, **blk)
            self.add_module(f"DownBlockMF_{i}", down)
            c_prev, prev_cf = ch[i], down.cf_output
            self.skip_cf.append(prev_cf)
        self.SemanticMapFusion_0 = SemanticMapFusion(
            (ch[1], ch[2], ch[3]), fusion_dim, fusion_heads, fusion_depth,
            ln_eps, dtype)
        skips = (ch[2], ch[1], ch[0], base_chan)
        c_low, low_cf = ch[3], False
        for j, i in enumerate(range(4, 8)):
            up = UpBlockMF(
                c_low, skips[j], ch[i], cn[i], tn[i], nh[i], dim_head[i],
                expansion, map_size, proj_type, ks[7 - i],
                map_shortcut=i < 6, map_dims=(ch[i - 1], skips[j]),
                no_map_out=i == 5, cf=cf(i, ks[7 - i]), low_cf=low_cf,
                skip_cf=self.skip_cf[3 - j], torch_port=torch_port,
                dtype=dtype, **blk)
            self.add_module(f"UpBlockMF_{j}", up)
            c_low = ch[i] if (cn[i] or tn[i]) else c_low + skips[j]
            low_cf = up.cf
            if i == 5:
                self.aux_cf = low_cf
                if aux_loss:
                    self.aux_out = (CFConv1 if low_cf else Conv1)(
                        c_low, num_classes, True, dtype)
        self.out_cf = low_cf
        self.outc = (CFConv1 if low_cf else Conv1)(c_low, num_classes, True,
                                                   dtype)
        # the encoder heads: an attention stage of ch[3] // 2 channels and 4
        # heads on x4, then the classifier (JAX ``cls_extra``/``clip_extra``)
        heads = [("cls", classification_classes)] if classification_classes \
            else []
        if clip_branch:
            heads.append(("clip", clip_feats))
        self.heads = tuple(name for name, _ in heads)
        for name, n_out in heads:
            self.add_module(f"{name}_extra", DownBlockMF(
                ch[3], ch[3] // 2, 0, 1, 4, dim_head[3], expansion, scale[3],
                map_size, proj_type, ks[4], map_generate=True,
                torch_port=torch_port, dtype=dtype, **blk))
            self.add_module(f"{name}_branch", ClassificationBranch(
                ch[3] // 2, n_out, ln_eps=ln_eps, dtype=dtype))

    def _block(self, name: str, *args):
        """Run a down or up block; with ``remat`` under autograd its
        activations are dropped after the forward and recomputed in the
        backward (the blocks the JAX model wraps in ``nn.remat``)."""
        block = getattr(self, name)
        if self.remat and torch.is_grad_enabled():
            return checkpoint(block, *args, use_reentrant=False)
        return block(*args)

    def encoder(self, x):
        """The encoder: the skips ``x0`` … ``x3``, the deepest features
        ``x4`` and the three semantic maps, as a tuple in that order; a skip
        is channel-first where ``skip_cf`` says so."""
        x = x.to(self.dtype)
        x0 = self.Conv_0(to_cf(x, False) if self.stem_cf else x)
        x0 = getattr(self, self.stem)(x0)
        x1, _ = self._block("DownBlockMF_0", x0)
        x2, map2 = self._block("DownBlockMF_1", x1)
        x3, map3 = self._block("DownBlockMF_2", x2)
        x4, map4 = self._block("DownBlockMF_3", x3)
        return x0, x1, x2, x3, x4, (map2, map3, map4)

    def branches(self, x4):
        """The encoder heads on the deepest features: ``{"classification":
        (B, classification_classes), "clip": (B, clip_feats)}``, those the
        model has, float32."""
        out = {}
        for name in self.heads:
            feats, _ = getattr(self, f"{name}_extra")(x4)
            key = "classification" if name == "cls" else name
            out[key] = getattr(self, f"{name}_branch")(feats)
        return out

    def forward(self, x):
        x0, x1, x2, x3, x4, maps = self.encoder(x)
        heads = self.branches(x4)
        map2, map3, map4 = self.SemanticMapFusion_0(list(maps))

        out, sem = self._block("UpBlockMF_0", x4, x3, map4, map3)
        out, sem = self._block("UpBlockMF_1", out, x2, sem, map2)
        aux = None
        if self.aux_loss:
            a = self.aux_out(out)
            aux = resize_trilinear(a.permute(0, 1, 3, 4, 2) if self.aux_cf
                                   else a, x.shape[1:4], self.torch_port)
        out, sem = self._block("UpBlockMF_2", out, x1, sem)
        out, sem = self._block("UpBlockMF_3", out, x0, sem)
        logits = self.outc(out)
        if self.out_cf:
            logits = logits.permute(0, 1, 3, 4, 2)
        return {"segmentation": [logits, aux] if self.aux_loss else logits,
                **heads}
