"""MedFormer 3D in PyTorch (counterpart of ``rsuper_tpu/models/medformer.py``).

The default configuration runs as the JAX model's default does: the stem,
``DownBlockMF_0`` and the last two decoder stages channel-first
``(B, D, C, H, W)`` through the CUDA conv kernels (``cf_fullres`` and
``cf_halfres``), everything else channels-last. Module names equal the flax
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

Not ported: configurations that leave the channel-first path (the
constructor raises for those).
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from .layers import (
    BasicBlockCF,
    CFConv1,
    CFConv3,
    Conv1,
    ConvNormAct,
    Dense,
    DepthwiseSeparableConv,
    MBConv,
    TransformerBlock,
    instance_norm,
    instance_norm_axes,
    resize_trilinear,
    resize_trilinear_cf,
)


class SemanticMapGeneration(nn.Module):
    """Pool (B, D, H, W, C) into a (B, 3, 3, 3, map_dim) semantic map by
    learned spatial attention. Its two 3³ convs were never Pallas kernels in
    the JAX package; here they run as ``F.conv3d`` (``weight`` in torch
    layout)."""

    def __init__(self, c_in: int, map_dim: int, map_size=(3, 3, 3),
                 dtype=torch.float32):
        super().__init__()
        code = map_size[0] * map_size[1] * map_size[2]
        self.Conv_0 = _Conv3d(c_in, map_dim, dtype)
        self.Conv_1 = _Conv3d(c_in, code, dtype)
        self.map_dim, self.map_size, self.code = map_dim, tuple(map_size), code

    def forward(self, x):
        b = x.shape[0]
        feat = self.Conv_0(x).reshape(b, -1, self.map_dim)
        weight = self.Conv_1(x).reshape(b, -1, self.code)
        weight = torch.softmax(weight.float(), dim=1).to(x.dtype)
        sem = torch.einsum("bsm,bsk->bkm", feat, weight)
        return sem.reshape(b, *self.map_size, self.map_dim)


class _Conv3d(nn.Module):
    """Dense 3³ SAME conv, no bias, channels-last in and out, via F.conv3d."""

    def __init__(self, c_in: int, features: int, dtype=torch.float32):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(features, c_in, 3, 3, 3))
        self.dtype = dtype

    def forward(self, x):
        y = nn.functional.conv3d(x.to(self.dtype).permute(0, 4, 1, 2, 3),
                                 self.weight.to(self.dtype), padding=1)
        return y.permute(0, 2, 3, 4, 1)


class BidirectionAttention(nn.Module):
    """Cross-attention both ways between feature tokens and the 27 map
    tokens; the (2, heads, dim_head) channel split of the JAX model."""

    def __init__(self, feat_dim: int, map_dim: int, out_dim: int, heads: int,
                 dim_head: int, map_size=(3, 3, 3), no_map_out: bool = False,
                 dtype=torch.float32):
        super().__init__()
        inner = heads * dim_head
        self.DepthwiseSeparableConv_0 = DepthwiseSeparableConv(
            feat_dim, inner * 2, dtype=dtype)
        self.Conv_0 = Conv1(map_dim, inner * 2, False, dtype)
        self.DepthwiseSeparableConv_1 = DepthwiseSeparableConv(
            inner, out_dim, dtype=dtype)
        if not no_map_out:
            self.Conv_1 = Conv1(inner, map_dim, False, dtype)
        self.heads, self.dim_head = heads, dim_head
        self.map_size, self.no_map_out = tuple(map_size), no_map_out

    def forward(self, feat, sem):
        b, d, h, w, _ = feat.shape
        inner = self.heads * self.dim_head
        feat_qv = self.DepthwiseSeparableConv_0(feat)
        map_qv = self.Conv_0(sem)

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
        feat_out = self.DepthwiseSeparableConv_1(feat_out)
        if not self.no_map_out:
            map_out = self.Conv_1(map_out)
        return feat_out, map_out


class BidirectionAttentionBlock(nn.Module):
    """norm → bidirectional attention → residual → MBConv feed-forward."""

    def __init__(self, feat_dim: int, map_dim: int, out_dim: int, heads: int,
                 dim_head: int, expansion: int = 4, map_size=(3, 3, 3),
                 no_map_out: bool = False, norm_eps: float = 1e-4,
                 dtype=torch.float32):
        super().__init__()
        self.BidirectionAttention_0 = BidirectionAttention(
            feat_dim, map_dim, out_dim, heads, dim_head, map_size, no_map_out,
            dtype)
        if feat_dim != out_dim:
            self.ConvNormAct_0 = ConvNormAct(feat_dim, out_dim, 1,
                                             preact=True, dtype=dtype)
        self.MBConv_0 = MBConv(out_dim, out_dim, expansion, dtype)
        self.shortcut = feat_dim != out_dim
        self.no_map_out, self.norm_eps = no_map_out, norm_eps

    def forward(self, x, sem):
        feat = instance_norm(x, self.norm_eps)
        mapp = instance_norm(sem, self.norm_eps)
        out, map_out = self.BidirectionAttention_0(feat, mapp)
        shortcut = self.ConvNormAct_0(x) if self.shortcut else x
        out = self.MBConv_0(out + shortcut)
        if not self.no_map_out:
            map_out = map_out + sem
        return out, map_out


class BasicLayer(nn.Module):
    def __init__(self, num_blocks: int, feat_dim: int, map_dim: int,
                 out_dim: int, heads: int, dim_head: int, expansion: int = 4,
                 map_size=(3, 3, 3), no_map_out: bool = False,
                 norm_eps: float = 1e-4, dtype=torch.float32):
        super().__init__()
        self.num_blocks = num_blocks
        for i in range(num_blocks):
            last = i == num_blocks - 1
            self.add_module(f"BidirectionAttentionBlock_{i}",
                            BidirectionAttentionBlock(
                                feat_dim if i == 0 else out_dim, map_dim,
                                out_dim, heads, dim_head, expansion, map_size,
                                no_map_out and last, norm_eps, dtype))

    def forward(self, x, sem):
        for i in range(self.num_blocks):
            x, sem = getattr(self, f"BidirectionAttentionBlock_{i}")(x, sem)
        return x, sem


class PatchMerging(nn.Module):
    """Space-to-depth ×2 + instance norm + depthwise-separable reduction.
    The merged channel order is (sd, sh, sw, c) for channel-first and
    channels-last input alike, as in the JAX model."""

    def __init__(self, c_in: int, out_dim: int, down_scale=(2, 2, 2),
                 norm_eps: float = 1e-4, cf_input: bool = False,
                 dtype=torch.float32):
        super().__init__()
        sd, sh, sw = down_scale
        self.DepthwiseSeparableConv_0 = DepthwiseSeparableConv(
            sd * sh * sw * c_in, out_dim, dtype=dtype)
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
        return self.DepthwiseSeparableConv_0(x)


class DownBlockMF(nn.Module):
    """patch-merge → channel-first conv blocks, or → (semantic map) →
    attention blocks. With ``cf_output`` the conv output is returned
    channel-first."""

    def __init__(self, c_in: int, out_dim: int, conv_num: int, trans_num: int,
                 heads: int, dim_head: int, expansion: int = 4,
                 down_scale=(2, 2, 2), map_size=(3, 3, 3),
                 map_generate: bool = False,
                 cf_input: bool = False, cf_output: bool = False,
                 torch_port: bool = False, dtype=torch.float32):
        super().__init__()
        block_eps = 1e-5 if torch_port else 1e-4
        if conv_num and (trans_num or map_generate):
            raise NotImplementedError("conv blocks beside attention in one "
                                      "encoder stage are not ported")
        if cf_output and not conv_num:
            raise ValueError("cf_output needs the channel-first conv blocks")
        self.PatchMerging_0 = PatchMerging(c_in, out_dim, down_scale,
                                           block_eps, cf_input, dtype)
        for i in range(conv_num):
            self.add_module(f"BasicBlock_{i}", BasicBlockCF(
                out_dim, out_dim, dtype))
        if map_generate:
            self.SemanticMapGeneration_0 = SemanticMapGeneration(
                out_dim, out_dim, map_size, dtype)
        if trans_num:
            self.BasicLayer_0 = BasicLayer(
                trans_num, out_dim, out_dim, out_dim, heads, dim_head,
                expansion, map_size, norm_eps=block_eps, dtype=dtype)
        self.conv_num, self.trans_num = conv_num, trans_num
        self.map_generate, self.cf_output = map_generate, cf_output

    def forward(self, x):
        x = self.PatchMerging_0(x)
        if self.conv_num:
            xc = x.permute(0, 1, 4, 2, 3).contiguous()  # (B, D, C, H, W)
            for i in range(self.conv_num):
                xc = getattr(self, f"BasicBlock_{i}")(xc)
            if self.cf_output:
                return xc, None
            x = xc.permute(0, 1, 3, 4, 2).contiguous()
        sem = self.SemanticMapGeneration_0(x) if self.map_generate else None
        if self.trans_num:
            x, sem = self.BasicLayer_0(x, sem)
        return x, sem


class UpBlockMF(nn.Module):
    """upsample + skip-concat (+ map shortcut) → attention blocks
    (channels-last; the decoder's attention stages)."""

    def __init__(self, c_low: int, c_skip: int, out_dim: int, trans_num: int,
                 heads: int, dim_head: int, expansion: int = 4,
                 map_size=(3, 3, 3), map_shortcut: bool = False,
                 map_dims=(0, 0), no_map_out: bool = False,
                 torch_port: bool = False, dtype=torch.float32):
        super().__init__()
        if map_shortcut:
            self.Conv_0 = Conv1(map_dims[0] + map_dims[1], out_dim, False,
                                dtype)
        self.BasicLayer_0 = BasicLayer(
            trans_num, c_low + c_skip, out_dim, out_dim, heads, dim_head,
            expansion, map_size, no_map_out,
            norm_eps=1e-5 if torch_port else 1e-4, dtype=dtype)
        self.map_shortcut, self.align_corners = map_shortcut, torch_port

    def forward(self, x_low, x_skip, map_low, map_skip=None):
        x = resize_trilinear(x_low, x_skip.shape[1:4],
                             self.align_corners).to(x_low.dtype)
        feat = torch.cat([x, x_skip.to(x.dtype)], dim=-1)
        if self.map_shortcut and map_skip is not None:
            sem = self.Conv_0(torch.cat([map_low, map_skip], dim=-1))
        else:
            sem = map_low
        return self.BasicLayer_0(feat, sem)


class UpBlockCF(nn.Module):
    """Channel-first decoder stage: upsample + skip-concat + conv blocks."""

    def __init__(self, c_low: int, c_skip: int, out_dim: int, conv_num: int,
                 torch_port: bool = False, dtype=torch.float32):
        super().__init__()
        self.conv_num, self.align_corners = conv_num, torch_port
        for i in range(conv_num):
            self.add_module(f"BasicBlock_{i}", BasicBlockCF(
                c_low + c_skip if i == 0 else out_dim, out_dim, dtype))

    def forward(self, x_low_cf, x_skip_cf):
        sk = x_skip_cf.shape
        x = resize_trilinear_cf(x_low_cf, (sk[1], sk[3], sk[4]),
                                self.align_corners).to(x_low_cf.dtype)
        feat = torch.cat([x, x_skip_cf.to(x.dtype)], dim=2)
        for i in range(self.conv_num):
            feat = getattr(self, f"BasicBlock_{i}")(feat)
        return feat


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
    and ``"clip"`` (B, clip_feats), float32."""

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
                 torch_port: bool = False, dtype=torch.float32):
        super().__init__()
        cn, tn, ch, nh = conv_num, trans_num, chan_num, num_heads
        scale = [tuple(s) if isinstance(s, (tuple, list)) else (s,) * 3
                 for s in scale]
        ks = [k if isinstance(k, int) else tuple(k) for k in kernel_size]
        supported = (
            conv_block == "BasicBlock" and norm == "in" and act == "relu"
            and proj_type == "depthwise"
            and all(k in (3, (3, 3, 3)) for k in ks)
            and all(s == (2, 2, 2) for s in scale)
            and tn[0] == 0 and tn[6] == 0 and tn[7] == 0 and cn[0] > 0
            and all(cn[i] == 0 for i in range(1, 6))
            and all(tn[i] > 0 for i in range(1, 6))
        )
        if not supported:
            raise NotImplementedError(
                "the port runs MedFormer's default configuration only "
                "(instance norm and ReLU; BasicBlock conv stages at full and "
                "half resolution, depthwise attention stages in between)")
        dim_head = [ch[i] // nh[i] for i in range(8)]
        self.num_classes, self.aux_loss, self.dtype = num_classes, aux_loss, \
            dtype
        self.remat, self.torch_port = remat, torch_port
        ln_eps = 1e-5 if torch_port else 1e-6

        self.Conv_0 = CFConv3(1, base_chan, dtype=dtype)
        self.BasicBlock_0 = BasicBlockCF(base_chan, base_chan, dtype)
        c_prev = base_chan
        for i in range(4):
            self.add_module(f"DownBlockMF_{i}", DownBlockMF(
                c_prev, ch[i], cn[i], tn[i], nh[i], dim_head[i], expansion,
                scale[i], map_size, map_generate=i >= 1,
                cf_input=i <= 1, cf_output=i == 0, torch_port=torch_port,
                dtype=dtype))
            c_prev = ch[i]
        self.SemanticMapFusion_0 = SemanticMapFusion(
            (ch[1], ch[2], ch[3]), fusion_dim, fusion_heads, fusion_depth,
            ln_eps, dtype)
        self.UpBlockMF_0 = UpBlockMF(
            ch[3], ch[2], ch[4], tn[4], nh[4], dim_head[4], expansion,
            map_size, map_shortcut=True, map_dims=(ch[3], ch[2]),
            torch_port=torch_port, dtype=dtype)
        self.UpBlockMF_1 = UpBlockMF(
            ch[4], ch[1], ch[5], tn[5], nh[5], dim_head[5], expansion,
            map_size, map_shortcut=True, map_dims=(ch[4], ch[1]),
            no_map_out=True, torch_port=torch_port, dtype=dtype)
        if aux_loss:
            self.aux_out = Conv1(ch[5], num_classes, True, dtype)
        self.UpBlockMF_2 = UpBlockCF(ch[5], ch[0], ch[6], cn[6], torch_port,
                                     dtype)
        self.UpBlockMF_3 = UpBlockCF(ch[6], base_chan, ch[7], cn[7],
                                     torch_port, dtype)
        self.outc = CFConv1(ch[7], num_classes, True, dtype)
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
                map_size, map_generate=True, torch_port=torch_port,
                dtype=dtype))
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
        """The encoder: the skips ``x0_cf``, ``x1_cf`` (channel-first),
        ``x2``, ``x3``, the deepest features ``x4`` and the three semantic
        maps, as a tuple in that order."""
        x = x.to(self.dtype)
        x_cf = x.permute(0, 1, 4, 2, 3).contiguous()  # (B, D, 1, H, W)
        x0_cf = self.BasicBlock_0(self.Conv_0(x_cf))
        x1_cf, _ = self._block("DownBlockMF_0", x0_cf)
        x2, map2 = self._block("DownBlockMF_1", x1_cf)
        x3, map3 = self._block("DownBlockMF_2", x2)
        x4, map4 = self._block("DownBlockMF_3", x3)
        return x0_cf, x1_cf, x2, x3, x4, (map2, map3, map4)

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
        x0_cf, x1_cf, x2, x3, x4, maps = self.encoder(x)
        heads = self.branches(x4)
        map2, map3, map4 = self.SemanticMapFusion_0(list(maps))

        out, sem = self._block("UpBlockMF_0", x4, x3, map4, map3)
        out, sem = self._block("UpBlockMF_1", out, x2, sem, map2)
        aux = None
        if self.aux_loss:
            aux = resize_trilinear(self.aux_out(out), x.shape[1:4],
                                   self.torch_port)
        out_cf = self._block("UpBlockMF_2", out.permute(0, 1, 4, 2, 3), x1_cf)
        out_cf = self._block("UpBlockMF_3", out_cf, x0_cf)
        logits = self.outc(out_cf).permute(0, 1, 3, 4, 2)
        return {"segmentation": [logits, aux] if self.aux_loss else logits,
                **heads}
