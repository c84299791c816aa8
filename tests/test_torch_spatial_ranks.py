"""The rank side of the spatial-sharding tests, and the checks of spatial
sharding that need no JAX, on the CPU with PyTorch alone (every rank is a
fresh interpreter that imports this file).

``python tests/test_torch_spatial_ranks.py rank JOB RANK WORLD S PORT
INPUTS OUT`` joins a gloo job of WORLD ranks in a ``(WORLD / S) × S`` grid
at 127.0.0.1:PORT and writes what it saw to ``OUT/JOB{RANK}.pt``:

* job ``res`` (2 × 2): the ResUNet (base 4) step, ``train.step.gradients``
  at the global batch of 2 (its data rank's item), in ``RES_MODES``: the
  global loss terms and the reduced gradients;
* job ``mf`` (1 × 2): the tiny MedFormer with both heads at ``MF_SHAPE``,
  every mode of ``MODES``, and ``dice`` again with ``remat``; the gathered
  logits of a forward; the unit checks (``units``): the collectives, the
  sharded convs, norms, fused prologue, depthwise conv and resizes, each
  against its unsharded self on the whole volume, as relative errors;
* job ``units`` (1 × 4): the unit checks again, where the middle ranks
  exchange halos with two neighbours;
* job ``configs`` (1 × 2, INPUTS ``-``: seeded weights and volumes): each
  MedFormer configuration and UNet block of ``MF_CONFIGS`` and
  ``UNET_BLOCKS`` on the rank's planes against its whole volume.

``... one MODEL INPUTS OUT`` writes the port's one-process steps of MODEL
(``res`` or ``mf``) on the whole batches to ``OUT/one_MODEL.pt`` (an item at
a time, ``PerItem``), the MedFormer's also on the nudged batches
(``nudged``: one float32 rounding of the image), whose move is the noise
floor of its float32 gradients.

Below: the CLI through its local spawner (``--dist_num_processes 2
--spatial_shard 2``, then a one-process resume; world 4 with ZeRO-1), the
loop's guards with the JAX loop's messages, every 3D and 2D arch,
MedFormer configuration and UNet block accepted (the MedFormers and the
blocks sharded by job ``configs``).
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent
for p in (ROOT, ROOT / "tests"):
    if str(p) not in sys.path:
        sys.path.insert(0, str(p))

from test_torch_parallel_ranks import (CLASSES, HEADS, LMAP, MODES, TINY,  # noqa: E402
                                       _cat)

RESUNET = {"base_chan": 4}
RES_MODES = ("dice", "ball_dice_last")
RES_SIZE = 64  # the JAX package's spatial test: 4 planes deepest, 2 a shard
MF_SHAPE = (64, 32, 32)  # the JAX loop's guard: 64 // 16 >= 2·2
# the CLIP step reads the encoder's heads alone: at 64×32×32 they normalise
# 2 voxels, whose float32 gradient is noise (as at 32³ in
# tests/test_torch_parallel.py, which takes 64³ for it too)
MF_CLIP_SHAPE = (64, 64, 64)
B = 2
NUDGE = 2.0 ** -22  # one float32 rounding of the image


def nudged(batch):
    """`batch` with its image moved by one rounding: x·(1 ± NUDGE), the
    signs seeded."""
    sign = np.random.default_rng(3).random(batch["image"].shape) > 0.5
    image = batch["image"] * (1 + NUDGE * (2 * sign - 1)).astype(np.float32)
    return {**batch, "image": image.astype(np.float32)}


def resunet(state=None):
    from rsuper_tpu_torch.models import get_model

    m = get_model("resunet", len(CLASSES), RESUNET, dtype=torch.float32)
    if state is not None:
        m.load_state_dict(state)
    return m


def medformer(state=None, remat=False):
    from rsuper_tpu_torch.models import get_model

    m = get_model("medformer", len(CLASSES), {**TINY, **HEADS,
                                              "remat": remat},
                  dtype=torch.float32)
    if state is not None:
        m.load_state_dict(state)
    return m


class PerItem(torch.nn.Module):
    """`m` run an item at a time (the CPU rounds otherwise at batch 1 and
    2), also depth-sharded: the extra argument is the ``Spatial``."""

    def __init__(self, m):
        super().__init__()
        self.m = m

    def forward(self, x, *spatial):
        return _cat([self.m(x[i:i + 1], *spatial) for i in range(len(x))])

    def encoder(self, x, *spatial):
        self.spatial = spatial
        return [None] * 4 + [x]

    def branches(self, x):
        return _cat([self.m.branches(self.m.encoder(x[i:i + 1],
                                                    *self.spatial)[4])
                     for i in range(len(x))])


def step(model, batch, mode, group=None):
    """(loss terms, every parameter's gradient) of ``gradients``."""
    from rsuper_tpu_torch.train.step import gradients

    cfg, clip_only = MODES[mode]
    losses = gradients(PerItem(model), batch, LMAP, cfg, clip_only=clip_only,
                       group=group)
    return ({k: v.clone() for k, v in losses.items()},
            {k: p.grad.clone() for k, p in model.named_parameters()})


def rows(batch, idx):
    return {k: torch.from_numpy(np.ascontiguousarray(v[idx]))
            for k, v in batch.items()}


# ------------------------------------------------------------ unit checks
def _rel(a, b) -> float:
    return float((a - b).abs().max() / b.abs().max().clamp_min(1e-30))


def _compare(fn, x, params, sp, seed=7):
    """Relative errors of fn(x, spatial) on the rank's planes against
    fn(x, None) on the whole volume: the output, then the gradients of x
    and of `params` under a seeded cotangent."""
    from rsuper_tpu_torch.parallel import spatial as S

    xw = x.clone().requires_grad_()
    for p in params:
        p.grad = None
    yw = fn(xw, None)
    gy = torch.randn(yw.shape, dtype=yw.dtype,
                     generator=torch.Generator().manual_seed(seed))
    (yw * gy).sum().backward()
    gx, gp = xw.grad.clone(), [p.grad.clone() for p in params]
    for p in params:
        p.grad = None
    xl = S.shard_depth(x, sp).detach().requires_grad_()
    yl = S.gather_depth(fn(xl, sp), sp)
    (yl * gy / sp.size).sum().backward()
    d = xl.shape[1]
    errs = [_rel(yl.detach(), yw.detach()),
            _rel(xl.grad, gx[:, sp.rank * d:(sp.rank + 1) * d])]
    errs += [_rel(S.reduce_sum(p.grad, sp), w) for p, w in zip(params, gp)]
    return errs


def _collectives(sp):
    """halo_exchange, shard_depth, gather_depth and reduce_sum in float64
    against the whole volume's slices, pads and sums (reduce_sum leaves its
    input as it was)."""
    from rsuper_tpu_torch.parallel import spatial as S

    f64, d, out = torch.float64, 3, {}
    x = torch.randn(2, d * sp.size, 4, 3, dtype=f64,
                    generator=torch.Generator().manual_seed(1))
    w = [torch.randn(2, d * sp.size + 4, 4, 3, dtype=f64,
                     generator=torch.Generator().manual_seed(2 + r))
         for r in range(sp.size)]
    for outer in ("zeros", "drop"):
        for lo, hi in ((1, 1), (0, 1), (2, 1)):
            loc = S.shard_depth(x, sp).detach().requires_grad_()
            slab = S.halo_exchange(loc, lo, hi, sp, outer)
            pad = torch.cat([x.new_zeros(2, lo, 4, 3), x,
                             x.new_zeros(2, hi, 4, 3)], dim=1)
            l, h = (lo, hi) if outer == "zeros" else sp.halo(lo, hi)
            start = sp.rank * d + lo - l
            want = pad[:, start:start + d + l + h]
            # every rank's cotangent on its slab, added where it lies
            total = torch.zeros_like(pad)
            for r in range(sp.size):
                lr, hr = ((lo, hi) if outer == "zeros" else
                          (lo if r else 0, hi if r < sp.size - 1 else 0))
                s0 = r * d + lo - lr
                total[:, s0:s0 + d + lr + hr] += w[r][:, :d + lr + hr]
            (slab * w[sp.rank][:, :slab.shape[1]]).sum().backward()
            g_want = total[:, lo + sp.rank * d:lo + (sp.rank + 1) * d]
            out[f"halo_{outer}_{lo}{hi}"] = [
                float((slab - want).abs().max()) if slab.shape == want.shape
                else float("inf"), _rel(loc.grad, g_want)]
    xw = x.clone().requires_grad_()
    loc = S.shard_depth(xw, sp)
    (loc * w[0][:, :d]).sum().backward()
    pad = torch.zeros_like(x)
    pad[:, sp.rank * d:(sp.rank + 1) * d] = w[0][:, :d]
    out["shard_depth"] = [float((loc - x[:, sp.rank * d:(sp.rank + 1) * d])
                                .abs().max()), float((xw.grad - pad).abs()
                                                     .max())]
    loc = loc.detach().requires_grad_()
    whole = S.gather_depth(loc, sp)
    (whole * w[0][:, :whole.shape[1]]).sum().backward()
    # every rank's cotangent is w[0]: the reduce-scatter sums S of them
    out["gather_depth"] = [float((whole - x).abs().max()),
                           _rel(loc.grad, sp.size * w[0][:, sp.rank * d:
                                                         (sp.rank + 1) * d])]
    v = torch.randn(5, dtype=f64, generator=torch.Generator().manual_seed(
        10 + sp.rank))
    total = S.reduce_sum(v, sp)
    want = sum(torch.randn(5, dtype=f64, generator=torch.Generator()
                           .manual_seed(10 + r)) for r in range(sp.size))
    out["reduce_sum"] = [_rel(total, want), float((v - torch.randn(
        5, dtype=f64, generator=torch.Generator().manual_seed(
            10 + sp.rank))).abs().max())]
    return out


def units(sp):
    """Every sharded layer against its unsharded self on float64 inputs:
    cuDNN's convs and the resizes compute in float64, the norm's
    statistics and the CUDA kernels' plain versions in float32."""
    from rsuper_tpu_torch.models import layers as L
    from rsuper_tpu_torch.ops import conv_cf

    torch.manual_seed(0)
    g = torch.Generator().manual_seed(0)
    f64 = torch.float64
    out = _collectives(sp)
    x = torch.randn(2, 4 * sp.size, 6, 5, 3, generator=g, dtype=f64) + 0.5
    for k, s in ((3, 1), (3, 2), (1, 1), (2, 2)):
        conv = L.Conv(3, 4, k, s, dtype=f64).double()
        torch.nn.init.normal_(conv.weight, generator=g)
        torch.nn.init.normal_(conv.bias, generator=g)
        out[f"conv_k{k}_s{s}"] = _compare(lambda t, sp_, c=conv: c(t, sp_),
                                          x, list(conv.parameters()), sp)
    out["instance_norm"] = _compare(
        lambda t, sp_: L.instance_norm(t, spatial=sp_), x, [], sp)
    out["resize_x2"] = _compare(lambda t, sp_: L.resize_trilinear(
        t, (2 * t.shape[1], 9, 7), spatial=sp_), x, [], sp)
    out["resize_x4"] = _compare(lambda t, sp_: L.resize_trilinear(
        t, (4 * t.shape[1], 6, 5), spatial=sp_), x, [], sp)
    out["resize_x1"] = _compare(lambda t, sp_: L.resize_trilinear(
        t, (t.shape[1], 12, 10), spatial=sp_), x, [], sp)
    out["resize_align_corners"] = _compare(lambda t, sp_: L.resize_trilinear(
        t, (2 * t.shape[1], 11, 9), True, spatial=sp_), x, [], sp)
    xcf = torch.randn(2, 4 * sp.size, 3, 6, 5, generator=g, dtype=f64)
    out["resize_cf_x2"] = _compare(lambda t, sp_: L.resize_trilinear_cf(
        t, (2 * t.shape[1], 12, 10), spatial=sp_), xcf, [], sp)

    f32 = torch.float32
    xcf = xcf.to(f32) + 0.5
    w = torch.randn(3, 3, 3, 3, 4, generator=g).requires_grad_()
    out["conv3x3x3_cf"] = _compare(
        lambda t, sp_: conv_cf.conv3x3x3_cf(t, w, spatial=sp_), xcf, [w], sp)
    out["in_relu_conv3x3x3_cf"] = _compare(
        lambda t, sp_: conv_cf.in_relu_conv3x3x3_cf(t, w, spatial=sp_), xcf,
        [w], sp)
    return _fused_pieces(sp, out)


def _fused_pieces(sp, out):
    """The fused prologue's plain pieces (the whole volume's stats from the
    shards' sums, the conv of the normalised slab, the closed-form backward
    with the whole volume's means) and the depthwise conv, float32."""
    from rsuper_tpu_torch.models import layers as L
    from rsuper_tpu_torch.ops import conv_cf
    from rsuper_tpu_torch.parallel import spatial as S

    g = torch.Generator().manual_seed(3)
    x = torch.randn(2, 4 * sp.size, 3, 6, 5, generator=g) * 2 + 1
    da = torch.randn(x.shape, generator=g)
    xl, dal = S.shard_depth(x, sp), S.shard_depth(da, sp)
    stats = conv_cf._in_stats_cf(x, 1e-4)
    stats_l = conv_cf._in_stats_cf(xl, 1e-4, sp)
    d = xl.shape[1]
    out["in_stats_cf"] = [_rel(stats_l, stats)]
    out["in_relu_bwd"] = [_rel(
        conv_cf._in_relu_bwd(xl, stats, dal, sp),
        conv_cf._in_relu_bwd(x, stats, da)[:, sp.rank * d:(sp.rank + 1) * d])]
    slab = S.halo_planes(xl, 1, 1, sp, "drop")
    w = torch.randn(3, 3, 3, 3, 4, generator=g)
    y = conv_cf._conv3_cf_plain(conv_cf._in_relu(slab, stats), w)
    y = y.narrow(1, sp.halo(1, 1)[0], d)
    out["in_relu_conv_plain"] = [_rel(
        y, conv_cf._in_relu_conv_plain(x, w, 1e-4)[:, sp.rank * d:
                                                    (sp.rank + 1) * d])]
    xcl = torch.randn(2, 4 * sp.size, 6, 4, 5, generator=g) + 0.5
    dw = L.DepthwiseConv3(5)
    torch.nn.init.normal_(dw.kernel, generator=g)
    out["depthwise_conv3x3x3"] = _compare(lambda t, sp_: dw(t, sp_), xcl,
                                          [dw.kernel], sp)
    return _zoo_pieces(sp, out)


def _seeded(module, g):
    """`module` with every parameter drawn from `g` (normal, scaled down
    so the deeper pieces stay in range)."""
    for p in module.parameters():
        torch.nn.init.normal_(p, std=0.5, generator=g)
    return module


def _zoo_pieces(sp, out):
    """The layers the 3D zoo shards with: the 2³ transposed conv (float64),
    and in float32 (their statistics, softmax and LayerNorm are float32
    inside) the squeeze-and-excitation block, whole MBConv and FusedMBConv
    blocks, a token stage run whole between ``gather_depth`` and
    ``shard_depth`` (a ViT block over the flattened volume), and the
    per-voxel layers, which take the rank's planes as they are. The blocks
    run without norm: an instance norm after the SE gate divides its
    per-channel scale out again, which leaves the SE weights a gradient of
    rounding noise alone."""
    from rsuper_tpu_torch.models import layers as L
    from rsuper_tpu_torch.models.vnet import PReLU
    from rsuper_tpu_torch.parallel import spatial as S

    g = torch.Generator().manual_seed(4)
    f64 = torch.float64
    x = torch.randn(2, 4 * sp.size, 6, 5, 3, generator=g, dtype=f64)
    up = _seeded(L.ConvTranspose(3, 4, 2, 2, dtype=f64).double(), g)
    out["conv_transpose_k2_s2"] = _compare(lambda t, sp_: up(t, sp_), x,
                                           list(up.parameters()), sp)
    x = torch.randn(2, 4 * sp.size, 6, 5, 8, generator=g) + 0.5
    se = _seeded(L.SEBlock(8), g)
    out["se_block"] = _compare(lambda t, sp_: se(t, sp_), x,
                               list(se.parameters()), sp)
    for name, Block in (("mbconv", L.MBConv), ("fused_mbconv",
                                               L.FusedMBConv)):
        blk = _seeded(Block(8, 6, expansion=2, act="gelu", norm="none"), g)
        out[name] = _compare(lambda t, sp_, b=blk: b(t, sp_), x,
                             list(blk.parameters()), sp)
    tb = _seeded(L.TransformerBlock(8, 1, 2, 4, 16), g)

    def tokens(t):
        return tb(t.reshape(t.shape[0], -1, 8)).reshape(t.shape)

    out["token_stage"] = _compare(
        lambda t, sp_: tokens(t) if sp_ is None else S.shard_depth(
            tokens(S.gather_depth(t, sp_)), sp_), x, list(tb.parameters()),
        sp)
    ln, mlp, act = L.LayerNorm(8), _seeded(L.Mlp(8, 16), g), PReLU(8)
    torch.nn.init.ones_(ln.weight)
    torch.nn.init.zeros_(ln.bias)
    torch.nn.init.constant_(act.alpha, 0.25)
    pieces = [*ln.parameters(), *mlp.parameters(), act.alpha]
    out["per_voxel"] = _compare(lambda t, sp_: act(mlp(ln(t))), x, pieces,
                                sp)
    return out


# -------------------------------------------------- whole configurations
# the MedFormer configurations and UNet blocks whose stages shard beside
# the default ones: attention in UpBlockMF_2 (gathered, run whole, sharded
# again), channels-last MBConv/FusedMBConv stages, no norm; UNets of every
# block, squeeze-and-excitation included
MF_CONFIGS = {
    "attention_in_up2": dict(trans_num=(0, 1, 2, 1, 1, 1, 1, 0),
                             chan_num=(8, 16, 32, 40, 32, 16, 16, 4)),
    "mbconv": dict(conv_block="MBConv"),
    "fused_mbconv": dict(conv_block="FusedMBConv"),
    "no_norm": dict(norm="none"),
}
UNET_BLOCKS = ("ConvNormAct", "BasicBlock", "Bottleneck", "MBConv",
               "FusedMBConv")
CONFIG_SHAPE = MF_SHAPE
# gradients: ‖Δg‖ ≤ max(CONFIG_GRAD_TOL, 4·min(ρ, CONFIG_RHO_MAX))·(‖g‖ +
# 1e-3·max‖g‖) per parameter, ρ the parameter's relative move under one
# float32 rounding of the input (the bounds of tests/test_torch_train.py
# and tests/test_torch_spatial.py: the float32 kernels' plain versions
# leave no float64 run)
CONFIG_LOGITS_TOL, CONFIG_GRAD_TOL, CONFIG_RHO_MAX = 1e-4, 2e-3, 2e-2


def config_model(case: str):
    """A MedFormer configuration (TINY's widths) or a UNet block (base 4),
    float32, seeded weights."""
    from rsuper_tpu_torch.models import get_model, init_params

    if case in MF_CONFIGS:
        m = get_model("medformer", len(CLASSES), {**TINY, **MF_CONFIGS[case]},
                      dtype=torch.float32)
    else:
        m = get_model("unet", len(CLASSES), {"base_chan": 4, "block": case},
                      dtype=torch.float32)
    return init_params(m, seed=0)


def configs(sp):
    """Each configuration's forward on the rank's planes against its
    forward on the whole volume, float32: the full-resolution logits' max
    relative error, and per parameter ‖Δg‖ of the gradients under a seeded
    cotangent (the rank's summed over the group), ‖g‖ and the move ‖g' −
    g‖ of the whole volume's gradient when the input moves by one float32
    rounding."""
    from rsuper_tpu_torch.parallel import spatial as S

    out = {}
    for case in (*MF_CONFIGS, *UNET_BLOCKS):
        m = config_model(case)
        g = torch.Generator().manual_seed(6)
        x = torch.randn(1, *CONFIG_SHAPE, 1, generator=g)
        sign = torch.rand(x.shape, generator=g) > 0.5
        xn = x * (1 + NUDGE * (2 * sign.float() - 1))

        def logits(t, sp_):
            seg = m(t, sp_)["segmentation"]
            return seg[0] if isinstance(seg, (list, tuple)) else seg

        def grads(t, sp_, gy):
            m.zero_grad(set_to_none=True)
            y = logits(t if sp_ is None else S.shard_depth(t, sp_), sp_)
            y = y if sp_ is None else S.gather_depth(y, sp_)
            (y * gy / (1 if sp_ is None else sp_.size)).sum().backward()
            return y.detach(), {
                k: p.grad.clone() if sp_ is None else S.reduce_sum(p.grad, sp_)
                for k, p in m.named_parameters() if p.grad is not None}

        with torch.no_grad():
            shape = logits(x, None).shape
        gy = torch.randn(shape, generator=g)
        yw, whole = grads(x, None, gy)
        _, moved = grads(xn, None, gy)
        yl, local = grads(x, sp, gy)
        assert sorted(local) == sorted(whole), case
        out[case] = dict(
            logits=_rel(yl, yw),
            grads={k: (float((local[k] - w).norm()), float(w.norm()),
                       float((moved[k] - w).norm())) for k, w in whole.items()})
    return out


# ------------------------------------------------------------- the jobs
def _job_res(data, dp):
    from rsuper_tpu_torch.parallel.multihost import local_rows

    batch = rows(data["res_batch"], local_rows(B, dp.rank, dp.world))
    return {mode: step(resunet(data["res_state"]), batch, mode, dp)
            for mode in RES_MODES}


def _job_mf(data, dp):
    from rsuper_tpu_torch.parallel import spatial as S

    sp = dp.spatial
    res = {}
    for mode in MODES:
        b = data["mf_clip_batch"] if mode == "clip" else data["mf_batch"]
        res[mode] = step(medformer(data["mf_state"]), rows(b, slice(None)),
                         mode, dp)
    res["dice_remat"] = step(medformer(data["mf_state"], remat=True),
                             rows(data["mf_batch"], slice(None)), "dice", dp)
    m = medformer(data["mf_state"])
    with torch.no_grad():
        x = torch.from_numpy(data["mf_batch"]["image"])
        out = m(S.shard_depth(x, sp), sp)
        seg = S.gather_segmentation(out, sp, x.shape[1] // sp.size)
    res["logits"] = [t.clone() for t in seg["segmentation"]]
    res["units"] = units(sp)
    return res


def run_rank(job: str, rank: int, world: int, S: int, port: int,
             inputs: str, out: str):
    import torch.distributed as dist

    from rsuper_tpu_torch.parallel.mesh import forget_grids, grid

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            world_size=world, rank=rank)
    try:
        dp = grid(S)
        if job == "configs":  # seeded weights and inputs: no input file
            res = {"configs": configs(dp.spatial)}
        elif job == "units":
            res = {"units": units(dp.spatial)}
        else:
            data = torch.load(inputs, weights_only=False)
            res = (_job_res if job == "res" else _job_mf)(data, dp)
        res["place"] = (dp.rank, dp.world, dp.spatial.rank, dp.spatial.size)
        torch.save(res, os.path.join(out, f"{job}{rank}.pt"))
    finally:
        forget_grids()
        dist.destroy_process_group()


def run_one(model: str, inputs: str, out: str):
    """The port's one-process steps on the whole batches; the MedFormer's
    also on the nudged batches."""
    torch.set_num_threads(1)
    data = torch.load(inputs, weights_only=False)
    res = {}
    if model == "res":
        for mode in RES_MODES:
            res[mode] = step(resunet(data["res_state"]),
                             rows(data["res_batch"], slice(None)), mode)
    else:
        for mode in MODES:
            b = data["mf_clip_batch"] if mode == "clip" else data["mf_batch"]
            res[mode] = step(medformer(data["mf_state"]),
                             rows(b, slice(None)), mode)
            res[f"{mode}/nudged"] = step(medformer(data["mf_state"]),
                                         rows(nudged(b), slice(None)), mode)
    torch.save(res, os.path.join(out, f"one_{model}.pt"))


# ------------------------------------------------------- checks without JAX
def test_loop_guards_keep_the_jax_loops_messages(tmp_path):
    """The JAX loop's two rules: S divides the ranks (one process is one
    device), and the deepest map keeps 2 planes a shard."""
    from rsuper_tpu_torch.config import load_config
    from rsuper_tpu_torch.train import loop

    preset = "abdomenatlas_ufo/medformer_3d"
    cfg = load_config(preset, overrides={"spatial_shard": 2,
                                         "training_size": (48, 64, 64)})
    with pytest.raises(ValueError, match=r"spatial_shard 2 too large for "
                       r"depth 48: the deepest feature map \(3 planes\) must "
                       r"keep >= 2 planes per shard"):
        loop.check_config(cfg)
    loop.check_config(load_config(preset, overrides={"spatial_shard": 2}))
    cfg = load_config(preset, overrides={"spatial_shard": 2})
    with pytest.raises(ValueError, match="spatial_shard 2 must divide the 1 "
                       "available devices"):
        loop.train(cfg, medformer(), [None], device="cpu")


# the 2D pathway: every 2D arch of the factory (rows in the JAX package)
ARCHS_2D = ("unet_2d", "resunet_2d", "attention_unet_2d",
            "dual_attention_unet_2d", "transunet_2d", "swin_unet_2d",
            "unetpp_2d", "medformer_2d")
ARCHS_3D = ("unet", "resunet", "medformer", "vnet", "unetr",
            "attention_unet", "unetpp", "swin_unetr", "nnformer", "vtunet")


@pytest.mark.parametrize("overrides", [
    {"arch": a, "training_size": (64, 64)} for a in ARCHS_2D],
    ids=lambda o: o["arch"])
def test_every_2d_arch_passes_the_loops_checks(overrides):
    """Every 2D arch of the factory shards its rows: the loop's checks
    accept it at 64² slices, whose deepest map keeps 2 rows a shard (the
    steps: ``tests/test_torch_spatial_2d.py``)."""
    from rsuper_tpu_torch.config import load_config
    from rsuper_tpu_torch.train import loop

    loop.check_config(load_config("abdomenatlas/resunet_3d",
                                  overrides={"spatial_shard": 2,
                                             **overrides}))


@pytest.mark.parametrize("arch", ARCHS_3D)
def test_every_3d_arch_passes_the_loops_checks(arch):
    """Every 3D arch of the factory shards: the loop's checks accept it at
    the preset's 128³ crops."""
    from rsuper_tpu_torch.config import load_config
    from rsuper_tpu_torch.train import loop

    loop.check_config(load_config("abdomenatlas/resunet_3d",
                                  overrides={"spatial_shard": 2,
                                             "arch": arch}))


@pytest.fixture(scope="module")
def config_runs(tmp_path_factory):
    """``configs`` on both ranks of a 1 × 2 gloo grid."""
    import socket

    tmp = tmp_path_factory.mktemp("spatial_configs")
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = str(sock.getsockname()[1])
    _finish([subprocess.Popen(
        [sys.executable, __file__, "rank", "configs", str(r), "2", "2", port,
         "-", str(tmp)], env=_env(), cwd=str(ROOT), stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for r in range(2)])
    return [torch.load(tmp / f"configs{r}.pt", weights_only=False)["configs"]
            for r in range(2)]


def _check_config_shards(runs, case):
    """Both ranks' results the same, the logits within CONFIG_LOGITS_TOL
    of the whole volume's and every gradient within its ρ bound."""
    res = runs[0][case]
    assert runs[1][case] == res, case
    assert res["logits"] <= CONFIG_LOGITS_TOL, (case, res["logits"])
    top = max(n for _, n, _ in res["grads"].values())
    for k, (err, norm, moved) in res["grads"].items():
        rho = moved / max(norm, 1e-30)
        tol = max(CONFIG_GRAD_TOL, 4 * min(rho, CONFIG_RHO_MAX))
        assert err <= tol * (norm + 1e-3 * top), (case, k, err, norm, rho)


@pytest.mark.parametrize("case", list(MF_CONFIGS))
def test_medformer_configurations_pass_the_loops_checks(config_runs, case):
    """The MedFormers whose full- and half-resolution stages hold
    attention, channels-last blocks or no norm pass the loop's checks and
    shard: on a 1 × 2 grid their logits and gradients meet the whole
    volume's (the first two are also held against the JAX spatial step in
    ``tests/test_torch_spatial_mf.py``)."""
    from rsuper_tpu_torch.config import load_config
    from rsuper_tpu_torch.train import loop

    m = config_model(case)
    assert not (m.stem_cf and m.UpBlockMF_2.cf and m.UpBlockMF_3.cf)
    loop.check_config(load_config("abdomenatlas_ufo/medformer_3d",
                                  overrides={"spatial_shard": 2,
                                             "model_args": {
                                                 **TINY, **MF_CONFIGS[case]}}))
    _check_config_shards(config_runs, case)


@pytest.mark.parametrize("block", UNET_BLOCKS)
def test_unet_blocks_pass_the_loops_checks(config_runs, block):
    """UNets of every block, squeeze-and-excitation included, pass the
    loop's checks and shard: on a 1 × 2 grid their logits and gradients
    meet the whole volume's."""
    from rsuper_tpu_torch.config import load_config
    from rsuper_tpu_torch.train import loop

    loop.check_config(load_config("abdomenatlas/resunet_3d", overrides={
        "spatial_shard": 2, "arch": "unet",
        "model_args": {"base_chan": 4, "block": block}}))
    _check_config_shards(config_runs, block)


def test_spawner_builds_the_jax_loops_mesh(monkeypatch, capsys):
    """On 8 cards with batch 2 and ``--spatial_shard 2`` the spawner runs a
    2x2 grid (4 ranks) and prints the JAX loop's line; on 3 cards S = 2
    does not divide them."""
    import torch.multiprocessing as mp

    from rsuper_tpu_torch.train import __main__ as cli

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 8)
    seen = {}
    monkeypatch.setattr(mp, "spawn", lambda fn, args, nprocs, join:
                        seen.update(nprocs=nprocs, args=args))
    assert cli.main(["--batch_size", "2", "--spatial_shard", "2"]) is None
    assert seen["nprocs"] == 4 and seen["args"][1] == 4
    assert "[train] using a 2x2 (data x model) mesh over 8 devices " \
           "(batch 2)" in capsys.readouterr().out
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 3)
    with pytest.raises(ValueError, match="spatial_shard 2 must divide the 3 "
                       "available devices"):
        cli.main(["--batch_size", "2", "--spatial_shard", "2"])
    # --dist_num_processes alone spawns that many ranks, here on the CPU
    assert cli.main(["--device", "cpu", "--dist_num_processes", "3"]) is None
    assert seen["nprocs"] == 3


def test_sharded_cli_raises_without_cuda(monkeypatch, tmp_path):
    """Without ``--device cpu`` the sharded CLI asks for CUDA before it
    joins a job."""
    from rsuper_tpu_torch.train import __main__ as cli

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        cli.main(["--data_root", str(tmp_path), "--spatial_shard", "2",
                  "--dist_coordinator", "127.0.0.1:1",
                  "--dist_num_processes", "2", "--dist_process_id", "0"])


# ---------------------------------------------------------------- the CLI
def _env():
    env = {k: v for k, v in os.environ.items() if k != "XLA_FLAGS"}
    env.update(OMP_NUM_THREADS="1", PYTHONPATH=str(ROOT))
    return env


def _write_cases(root: Path, shape, n: int = 4):
    """CT-Mask cases exactly the loader's load size for `shape` crops, so
    every crop is the whole case."""
    from rsuper_tpu_torch.data.dataset import RSuperDataConfig

    names = ["background", "liver", "liver_lesion", "pancreas"]
    load = RSuperDataConfig(classes=tuple(names), report_classes=(),
                            crop_size=tuple(shape)).load_size
    root.mkdir(parents=True)
    (root / "classes.json").write_text(json.dumps(names))
    for k in range(n):
        rng = np.random.default_rng(30 + k)
        lab = np.zeros((len(names), *load), bool)
        lab[1, 10:40, 6:30, 8:30 - k] = True
        lab[2, 20:26, 12:18, 12:18] = k % 2 == 0
        lab[3, 40:60, 10:30, 14:34] = True
        np.savez_compressed(root / f"BDMAP_S{k}.npz",
                            image=rng.normal(size=load).astype(np.float32),
                            labels=np.packbits(lab, axis=0),
                            num_classes=len(names))


@pytest.fixture(scope="module")
def cli_data(tmp_path_factory):
    yaml = pytest.importorskip("yaml")
    tmp = tmp_path_factory.mktemp("spatial_cli")
    _write_cases(tmp / "masks", MF_SHAPE)
    yaml.safe_dump({"model_args": {k: list(v) if isinstance(v, tuple) else v
                                   for k, v in TINY.items()},
                    "training_size": list(MF_SHAPE),
                    "compute_dtype": "float32", "num_workers": 1,
                    "warmup_epochs": 0, "nan_check_every": 1},
                   open(tmp / "tiny.yaml", "w"))
    return tmp


def _cli(tmp, name, extra):
    cmd = [sys.executable, "-m", "rsuper_tpu_torch.train", "--device", "cpu",
           "--config", str(tmp / "tiny.yaml"), "--data_root",
           str(tmp / "masks"), "--all_train", "--batch_size", "2",
           "--iter_per_epoch", "2", "--epochs", "2", "--max_steps", "2",
           "--unique_name", name, "--cp_path", str(tmp / "exp"), *extra]
    return subprocess.Popen(cmd, env=_env(), cwd=str(ROOT),
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                            text=True)


def _finish(procs):
    logs = [p.communicate(timeout=600)[0] for p in procs]
    for p, log in zip(procs, logs):
        assert p.returncode == 0, log[-4000:]


def _train_records(path):
    return [r for r in (json.loads(x) for x in open(path))
            if "train/overall" in r]


@pytest.fixture(scope="module")
def cli_runs(cli_data):
    """Two steps of the preset's MedFormer (tiny) through the spawner on a
    1x2 grid, on a 2x2 grid with ZeRO-1, and one process; then a resume
    of the 1x2 run's checkpoint in one process."""
    tmp = cli_data
    procs = [_cli(tmp, "sp", ["--dist_num_processes", "2",
                              "--spatial_shard", "2"]),
             _cli(tmp, "sp4", ["--dist_num_processes", "4",
                               "--spatial_shard", "2", "--zero_opt",
                               "--zero_ema"]),
             _cli(tmp, "one", [])]
    _finish(procs)
    _finish([_cli(tmp, "sp", ["--resume", "--max_steps", "1"])])
    return tmp / "exp"


@pytest.mark.parametrize("name,world", [("sp", 2), ("sp4", 4)])
def test_cli_spatial_ranks_in_lockstep_match_one_process(cli_runs, name,
                                                         world):
    """Every rank logs the same bits; the global losses lie within 1e-4 of
    one process's at the same global batch (the cases are the load size:
    no crop draw differs)."""
    ranks = [_train_records(cli_runs / name / f"metrics.rank{r}.jsonl")
             for r in range(world)]
    one = _train_records(cli_runs / "one" / "metrics.jsonl")
    assert len(one) >= 1 and all(len(r) >= len(one) for r in ranks)
    for i, ref in enumerate(one):
        keys = sorted(k for k in ref if k.startswith("train/"))
        for r in ranks:
            assert sorted(k for k in r[i] if k.startswith("train/")) == keys
            for k in keys:
                assert r[i][k] == ranks[0][i][k], (k, r[i][k])
                assert abs(r[i][k] - ref[k]) <= 1e-4 * abs(ref[k]) + 1e-7, \
                    (name, k, r[i][k], ref[k])


def test_cli_spatial_checkpoint_resumes_in_one_process(cli_runs):
    ckpt = torch.load(cli_runs / "sp" / "latest", weights_only=True)
    assert ckpt["step"] == 3  # 2 sharded steps, then 1 resumed
    zero = torch.load(cli_runs / "sp4" / "latest", weights_only=True)
    one = torch.load(cli_runs / "one" / "latest", weights_only=True)
    assert zero["step"] == one["step"] == 2
    assert sorted(zero["opt_state"]["state"]) == sorted(
        one["opt_state"]["state"])
    for k, v in one["params"].items():  # whole tensors in the checkpoint
        assert zero["params"][k].shape == v.shape
        assert zero["ema_params"][k].shape == v.shape
    recs = _train_records(cli_runs / "sp" / "metrics.jsonl")
    assert recs and all(np.isfinite(r["train/overall"]) for r in recs)


if __name__ == "__main__":
    if sys.argv[1] == "one":
        run_one(*sys.argv[2:5])
    else:
        job = sys.argv[2]
        r, w, s, p = (int(a) for a in sys.argv[3:7])
        run_rank(job, r, w, s, p, sys.argv[7], sys.argv[8])
