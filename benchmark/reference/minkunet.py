"""Plain PyTorch reference of MinkUNet with the Stage-2 heads, in float32.

The network (MinkUNet, Choy et al. 2019, as GCDLSS's `models/minkunet.py`
builds it): a k = 5 stem to `init_dim` channels, batch norm and ReLU; four
levels down, each a k = 2 s = 2 conv keeping the width, batch norm, ReLU and
a stack of basic residual blocks to `planes[i]`; four levels up, each a
k = 2 s = 2 transpose conv to `planes[4 + j]`, batch norm, ReLU, the skip of
that level concatenated after it, and a stack of blocks. A basic block is
conv3-BN-ReLU-conv3-BN plus the input (through a 1x1 product and BN where
the width changes), then ReLU. Batch norm normalizes with the batch's biased
variance over the level's voxels and moves its running statistics by 0.1
towards the batch's mean and unbiased variance. Three linear heads read the
last level-0 features: `final` (known classes), `final2` (NCC heads) and
`final3` (novel classes).

Parameters and statistics are dicts keyed by the names of GCDLSS's
checkpoints (`encoder.block1.0.conv1.kernel`, ...), kernels [K, Ci, Co].
A reference backbone (the contract in `reference/__init__.py`): `spec`,
`forward` and `pass_work`.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from .sparse import QuantMatmul, conv
from .work import bound_ms, conv_work, dense_ops, pairs


def spec(cfg: dict) -> dict:
    """name -> (shape, init) of every parameter and ("stat", shape, value)
    of every batch-norm statistic. Inits: ("normal", std) or ("const", v)."""
    p = {}

    def bn(name, c):
        p[f"{name}.weight"] = ((c,), ("const", 1.0))
        p[f"{name}.bias"] = ((c,), ("const", 0.0))
        p[f"{name}.running_mean"] = ((c,), ("stat", 0.0))
        p[f"{name}.running_var"] = ((c,), ("stat", 1.0))

    def kernel(name, k, ci, co):
        p[f"{name}.kernel"] = ((k, ci, co), ("normal", math.sqrt(2.0 / (k * co))))

    def linear(name, ci, co, bias):
        p[f"{name}.kernel"] = ((ci, co), ("normal", 1.0 / math.sqrt(ci)))
        if bias:
            p[f"{name}.bias"] = ((co,), ("const", 0.0))

    def blocks(name, cin, planes, n):
        for b in range(n):
            pre = f"encoder.{name}.{b}"
            ci = cin if b == 0 else planes
            kernel(f"{pre}.conv1", 27, ci, planes)
            bn(f"{pre}.norm1", planes)
            kernel(f"{pre}.conv2", 27, planes, planes)
            bn(f"{pre}.norm2", planes)
            if ci != planes:
                linear(f"{pre}.downsample.0", ci, planes, False)
                bn(f"{pre}.downsample.1", planes)

    planes, nblocks, c = cfg["planes"], cfg["blocks"], cfg["init_dim"]
    kernel("encoder.conv0p1s1", cfg["stem_kernel"] ** 3, cfg["in_channels"], c)
    bn("encoder.bn0", c)
    skips = [c]
    for i in range(4):
        kernel(f"encoder.conv{i + 1}p{2 ** i}s2", 8, c, c)
        bn(f"encoder.bn{i + 1}", c)
        blocks(f"block{i + 1}", c, planes[i], nblocks[i])
        c = planes[i]
        skips.append(c)
    for j in range(4):
        kernel(f"encoder.convtr{4 + j}p{2 ** (4 - j)}s2", 8, c, planes[4 + j])
        bn(f"encoder.bntr{4 + j}", planes[4 + j])
        blocks(f"block{5 + j}", planes[4 + j] + skips[3 - j], planes[4 + j], nblocks[4 + j])
        c = planes[4 + j]
    linear("encoder.final", c, cfg["num_known"], True)
    linear("encoder.final2", c, cfg["ncc_heads"], True)
    linear("encoder.final3", c, cfg["num_novel"], True)
    return p


def _bn(x, params, stats, name):
    return F.batch_norm(x, stats[f"{name}.running_mean"], stats[f"{name}.running_var"],
                        params[f"{name}.weight"], params[f"{name}.bias"], training=True,
                        momentum=0.1, eps=1e-5)


def _linear(x, params, name, quant):
    w = params[f"{name}.kernel"]
    return x @ w if quant is None else QuantMatmul.apply(x, w, quant)


def _blocks(x, params, stats, name, n, book, quant):
    for b in range(n):
        pre = f"encoder.{name}.{b}"
        out = conv(x, params[f"{pre}.conv1.kernel"], book, x.shape[0], quant)
        out = torch.relu(_bn(out, params, stats, f"{pre}.norm1"))
        out = conv(out, params[f"{pre}.conv2.kernel"], book, x.shape[0], quant)
        out = _bn(out, params, stats, f"{pre}.norm2")
        res = x
        if f"{pre}.downsample.0.kernel" in params:
            res = _bn(_linear(x, params, f"{pre}.downsample.0", quant), params, stats,
                      f"{pre}.downsample.1")
        x = torch.relu(out + res)
    return x


def forward(params: dict, stats: dict, plan, feats: torch.Tensor, cfg: dict,
            quant=None) -> dict:
    """Outputs on the plan's level-0 voxels: `feats` [n0, C] and the logits
    of the three heads. Batch norm runs in training mode and moves `stats`."""
    lv, nb = plan.levels, cfg["blocks"]
    x = conv(feats, params["encoder.conv0p1s1.kernel"], plan.stem, lv[0].n, quant)
    x = torch.relu(_bn(x, params, stats, "encoder.bn0"))
    skips = [x]
    for i in range(4):
        x = conv(x, params[f"encoder.conv{i + 1}p{2 ** i}s2.kernel"], plan.down[i],
                 lv[i + 1].n, quant)
        x = torch.relu(_bn(x, params, stats, f"encoder.bn{i + 1}"))
        x = _blocks(x, params, stats, f"block{i + 1}", nb[i], plan.cube[i + 1], quant)
        skips.append(x)
    for j in range(4):
        lvl = 3 - j
        x = conv(x, params[f"encoder.convtr{4 + j}p{2 ** (4 - j)}s2.kernel"], plan.up[lvl],
                 lv[lvl].n, quant)
        x = torch.relu(_bn(x, params, stats, f"encoder.bntr{4 + j}"))
        x = torch.cat([x, skips[lvl]], dim=1)
        x = _blocks(x, params, stats, f"block{5 + j}", nb[4 + j], plan.cube[lvl], quant)

    def head(name):
        return x @ params[f"encoder.{name}.kernel"] + params[f"encoder.{name}.bias"]

    return {"feats": x, "known": head("final"), "ncc": head("final2"), "novel": head("final3")}



def pass_work(plan, cfg: dict, grad: bool) -> dict:
    """{"conv_ops", "conv_bound_ms", "dense_ops"} of one MinkUNet pass over a
    reference `Plan`: forward, and with `grad` its backward (the stem's input
    needs no gradient)."""
    lv = plan.levels
    planes, nblocks, c = cfg["planes"], cfg["blocks"], cfg["init_dim"]
    ab = cfg.get("act_bytes", 2)
    convs, dense = [], 0

    def sub(book, level, ci, co, need_dx=True):
        convs.extend(conv_work(pairs(book), len(book), ci, co, lv[level].n, lv[level].n, ab,
                               grad, need_dx))

    def stack(level, cin, width, n):
        nonlocal dense
        for b in range(n):
            ci = cin if b == 0 else width
            sub(plan.cube[level], level, ci, width)
            sub(plan.cube[level], level, width, width)
            if ci != width:
                dense += dense_ops(lv[level].n, ci, width, grad)

    sub(plan.stem, 0, cfg["in_channels"], c, need_dx=False)
    skips = [c]
    for i in range(4):
        book = plan.down[i]
        convs.extend(conv_work(pairs(book), 8, c, c, lv[i + 1].n, lv[i].n, ab, grad))
        stack(i + 1, c, planes[i], nblocks[i])
        c = planes[i]
        skips.append(c)
    for j in range(4):
        lvl = 3 - j
        book = plan.up[lvl]
        convs.extend(conv_work(pairs(book), 8, c, planes[4 + j], lv[lvl].n, lv[lvl + 1].n, ab,
                               grad))
        stack(lvl, planes[4 + j] + skips[lvl], planes[4 + j], nblocks[4 + j])
        c = planes[4 + j]
    heads = cfg["num_known"] + cfg["ncc_heads"] + cfg["num_novel"]
    dense += dense_ops(lv[0].n, c, heads, grad)
    return {"conv_ops": sum(o for _, o, _ in convs),
            "conv_bound_ms": sum(bound_ms(b, o)[0] for _, o, b in convs),
            "dense_ops": dense}
