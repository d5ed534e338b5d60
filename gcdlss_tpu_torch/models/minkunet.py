"""MinkUNet on the port's sparse-conv engine (PyTorch).

Port of `gcdlss_tpu/models/minkunet.py` (reference `models/minkunet.py:44-132`,
`models/resnet.py:90-122`, `models/multiheadminkunet.py:309-340`): k=5 stem,
four k=2 s=2 downs and four transpose ups with skip concatenation, residual
block stacks per level (basic blocks for MinkUNet14/18/34, bottlenecks of
expansion 4 for MinkUNet50/101), and a linear or cosine (`NormedLinear`)
`final` head. `remat=True` recomputes each residual block's forward in the
backward pass (`torch.utils.checkpoint`) instead of keeping its activations,
as the JAX package's `nn.remat` does; batch norm updates its running
statistics once, in the forward. Submodules carry the reference
checkpoint's names (`encoder.conv0p1s1`, `encoder.conv1p1s2`,
`encoder.block1.0.conv1`, `encoder.block1.0.downsample.0`, `encoder.final`),
so its state dicts map on key by key (`utils.weights`). Kernel offsets keep
this repository's order (z fastest). `MinkUNetSeg` is the Stage-1 model,
`MinkUNetRC` the Stage-2 one (`gcdlss_tpu/models/minkunet.py:312-395`).

Given a rank's voxel-sharded plan (`parallel.sp_step.shard_plan`) the same
modules run the rank's row block (`models.layers`); the halos travel in the
plan's window books, ten of them in the JAX package's order (stem,
subm0..4, pool0..3). The outputs are the rank's rows, with the entries the
windows dropped in `sp_overflow` (`MinkUNetBackbone.sp_overflow`).

Precision (docs/ARCHITECTURE.md §3): activations in `dtype` (bf16 on the
card), parameters, batch-norm statistics, the head and the loss in f32.
"""

from __future__ import annotations

import contextlib

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..parallel.voxel_shard import WindowBook
from .layers import (Linear, NormedLinear, SparseBatchNorm, SparseConv, SparseDownConv,
                     SparseUpConv, frozen_batch_norm_stats, mask_rows)

# name -> (block type, blocks per stage); 'basic' expansion 1, 'bottleneck' 4
ARCHS = {
    "MinkUNet14": ("basic", (1, 1, 1, 1, 1, 1, 1, 1)),
    "MinkUNet18": ("basic", (2, 2, 2, 2, 2, 2, 2, 2)),
    "MinkUNet34": ("basic", (2, 3, 4, 6, 2, 2, 2, 2)),
    "MinkUNet50": ("bottleneck", (2, 3, 4, 6, 2, 2, 2, 2)),
    "MinkUNet101": ("bottleneck", (2, 3, 4, 23, 2, 2, 2, 2)),
}

DEFAULT_PLANES = (32, 64, 128, 256, 256, 128, 96, 96)
PLANE_VARIANTS = {
    "A14": (32, 64, 128, 256, 128, 128, 96, 96),
    "B14": (32, 64, 128, 256, 128, 128, 128, 128),
    "C14": (32, 64, 128, 256, 192, 192, 128, 128),
    "D14": (32, 64, 128, 256, 384, 384, 384, 384),
    "A18": (32, 64, 128, 256, 256, 128, 96, 96),
    "B18": (32, 64, 128, 256, 128, 128, 128, 128),
    "D18": (32, 64, 128, 256, 384, 384, 384, 384),
    "A34": (32, 64, 128, 256, 256, 128, 64, 64),
    "B34": (32, 64, 128, 256, 256, 128, 64, 32),
    "C34": (32, 64, 128, 256, 256, 128, 96, 96),
}


class BasicBlock(nn.Module):
    """conv3-bn-relu-conv3-bn + (1x1 projection if the width changes), relu."""

    def __init__(self, inplanes: int, planes: int, dtype: torch.dtype,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.conv1 = SparseConv(inplanes, planes, 27, generator)
        self.norm1 = SparseBatchNorm(planes)
        self.conv2 = SparseConv(planes, planes, 27, generator)
        self.norm2 = SparseBatchNorm(planes)
        self.downsample = None
        if inplanes != planes:
            self.downsample = nn.ModuleList([
                Linear(inplanes, planes, bias=False, dtype=dtype, generator=generator),
                SparseBatchNorm(planes),
            ])

    def forward(self, x, nbr, valid):
        out = torch.relu(self.norm1(self.conv1(x, nbr, valid), valid))
        out = self.norm2(self.conv2(out, nbr, valid), valid)
        residual = x
        if self.downsample is not None:
            proj, norm = self.downsample
            residual = norm(proj(x), valid)
        return mask_rows(torch.relu(out + residual), valid)


class Bottleneck(nn.Module):
    """1x1 - bn - relu - k3 - bn - relu - 1x1 (x4) - bn + (1x1 projection if
    the width changes), relu. The 1x1 convs are dense products (`Linear`),
    as the JAX package leaves them to XLA; the k3 conv is the sparse one."""

    EXPANSION = 4

    def __init__(self, inplanes: int, planes: int, dtype: torch.dtype,
                 generator: torch.Generator | None = None):
        super().__init__()
        out = planes * self.EXPANSION
        self.conv1 = Linear(inplanes, planes, bias=False, dtype=dtype, generator=generator)
        self.norm1 = SparseBatchNorm(planes)
        self.conv2 = SparseConv(planes, planes, 27, generator)
        self.norm2 = SparseBatchNorm(planes)
        self.conv3 = Linear(planes, out, bias=False, dtype=dtype, generator=generator)
        self.norm3 = SparseBatchNorm(out)
        self.downsample = None
        if inplanes != out:
            self.downsample = nn.ModuleList([
                Linear(inplanes, out, bias=False, dtype=dtype, generator=generator),
                SparseBatchNorm(out),
            ])

    def forward(self, x, nbr, valid):
        out = torch.relu(self.norm1(self.conv1(x), valid))
        out = torch.relu(self.norm2(self.conv2(out, nbr, valid), valid))
        out = self.norm3(self.conv3(out), valid)
        residual = x
        if self.downsample is not None:
            proj, norm = self.downsample
            residual = norm(proj(x), valid)
        return mask_rows(torch.relu(out + residual), valid)


BLOCKS = {"basic": (BasicBlock, 1), "bottleneck": (Bottleneck, Bottleneck.EXPANSION)}


def _recompute_contexts():
    """(forward, recompute) contexts of a checkpointed block: batch norm
    updates its running statistics in the forward only."""
    return contextlib.nullcontext(), frozen_batch_norm_stats()


class ResLayer(nn.ModuleList):
    """A stack of residual blocks named 0, 1, ... as in the reference. With
    `remat`, each block's activations are recomputed in the backward pass
    (while gradients are recorded; a no-grad forward runs as it is)."""

    def __init__(self, inplanes: int, planes: int, blocks: int, dtype: torch.dtype,
                 generator: torch.Generator | None = None, kind: str = "basic",
                 remat: bool = False):
        cls, exp = BLOCKS[kind]
        super().__init__([cls(inplanes if i == 0 else planes * exp, planes, dtype, generator)
                          for i in range(blocks)])
        self.remat = remat

    def forward(self, x, nbr, valid):
        for block in self:
            if self.remat and torch.is_grad_enabled():
                x = checkpoint(block, x, nbr, valid, use_reentrant=False,
                               context_fn=_recompute_contexts)
            else:
                x = block(x, nbr, valid)
        return x


class MinkUNetBackbone(nn.Module):
    """Sparse UNet over a 5-level `UNetPlan`; returns stride-1 features."""

    def __init__(self, arch: str = "MinkUNet34", planes: tuple = DEFAULT_PLANES,
                 in_channels: int = 1, init_dim: int = 32,
                 dtype: torch.dtype = torch.float32,
                 generator: torch.Generator | None = None, remat: bool = False):
        super().__init__()
        kind, layers = ARCHS[arch]
        exp = BLOCKS[kind][1]
        self.dtype = dtype
        g = generator
        self.conv0p1s1 = SparseConv(in_channels, init_dim, 125, g)
        self.bn0 = SparseBatchNorm(init_dim)
        c = init_dim
        skip_channels = [c]
        for i in range(4):
            self.add_module(f"conv{i + 1}p{2 ** i}s2", SparseDownConv(c, c, g))
            self.add_module(f"bn{i + 1}", SparseBatchNorm(c))
            self.add_module(f"block{i + 1}", ResLayer(c, planes[i], layers[i], dtype, g, kind,
                                                      remat))
            c = planes[i] * exp
            skip_channels.append(c)
        for j in range(4):
            lvl = 3 - j
            self.add_module(f"convtr{4 + j}p{2 ** (4 - j)}s2",
                            SparseUpConv(c, planes[4 + j], g))
            self.add_module(f"bntr{4 + j}", SparseBatchNorm(planes[4 + j]))
            self.add_module(f"block{5 + j}", ResLayer(
                planes[4 + j] + skip_channels[lvl], planes[4 + j], layers[4 + j], dtype, g, kind,
                remat))
            c = planes[4 + j] * exp
        self.out_channels = c

    def forward(self, plan, feats):
        lv, pools = plan.levels, plan.pools
        x = self.conv0p1s1(feats.to(self.dtype), plan.stem_nbr, lv[0].valid)
        x = torch.relu(self.bn0(x, lv[0].valid))
        skips = [x]
        for i in range(4):
            down = getattr(self, f"conv{i + 1}p{2 ** i}s2")
            x = down(x, pools[i], lv[i + 1].valid)
            x = torch.relu(getattr(self, f"bn{i + 1}")(x, lv[i + 1].valid))
            x = getattr(self, f"block{i + 1}")(x, lv[i + 1].nbr3, lv[i + 1].valid)
            skips.append(x)
        for j in range(4):
            lvl = 3 - j
            up = getattr(self, f"convtr{4 + j}p{2 ** (4 - j)}s2")
            x = up(x, pools[lvl], lv[lvl].valid)
            x = torch.relu(getattr(self, f"bntr{4 + j}")(x, lv[lvl].valid))
            x = torch.cat([x, skips[lvl]], dim=1)
            x = getattr(self, f"block{5 + j}")(x, lv[lvl].nbr3, lv[lvl].valid)
        return x  # [cap0, planes[7] x expansion]

    def sp_overflow(self, plan) -> torch.Tensor:
        """The book entries a sharded plan's windows dropped over one
        forward, each conv counting its book's once, as the JAX package's
        layers sow them: the stem, every block's k3 convs on its level's
        book, and each pool edge twice (its down and its up conv)."""
        total = plan.stem_nbr.overflow + 2 * sum(p.overflow for p in plan.pools)
        for name, layer in self.named_children():
            if isinstance(layer, ResLayer):
                b = int(name[len("block"):])
                lvl = b if b <= 4 else 8 - b
                convs = sum(isinstance(m, SparseConv) for m in layer.modules())
                total = total + convs * plan.levels[lvl].nbr3.overflow
        return total


def is_sharded(plan) -> bool:
    """Whether `plan` is a rank's voxel-sharded plan (window books)."""
    return isinstance(plan.stem_nbr, WindowBook)


HEADS = ("linear", "cosine")


def make_head(kind: str, in_channels: int, out_channels: int,
              generator: torch.Generator | None = None) -> nn.Module:
    """A `final` / `final2` head: `Linear` or, for "cosine" (the reference's
    `MinkUNetBaseCosine` / `MinkUNetRCCosine`), `NormedLinear`."""
    if kind not in HEADS:
        raise ValueError(f"head must be one of {HEADS}, got {kind!r}")
    cls = NormedLinear if kind == "cosine" else Linear
    return cls(in_channels, out_channels, generator=generator)


class MinkUNetSeg(nn.Module):
    """Backbone + `final` head (linear or cosine): the Stage-1 pretrain model.

    Returns {'logits' [cap0, num_classes] f32, 'feats' [cap0, C] f32}. The
    head is registered inside the encoder (`encoder.final`), where the
    reference checkpoint keeps it."""

    def __init__(self, num_classes: int, arch: str = "MinkUNet34",
                 planes: tuple = DEFAULT_PLANES, in_channels: int = 1,
                 dtype: torch.dtype = torch.float32,
                 generator: torch.Generator | None = None, head: str = "linear",
                 remat: bool = False):
        super().__init__()
        self.encoder = MinkUNetBackbone(arch, planes, in_channels, dtype=dtype,
                                        generator=generator, remat=remat)
        self.encoder.final = make_head(head, self.encoder.out_channels, num_classes, generator)

    def forward(self, plan, feats):
        h = self.encoder(plan, feats).float()
        logits = self.encoder.final(h)
        out = {"logits": mask_rows(logits, plan.levels[0].valid), "feats": h}
        if is_sharded(plan):
            out["sp_overflow"] = self.encoder.sp_overflow(plan)
        return out


class MinkUNetRC(nn.Module):
    """Backbone + `final` (K known), `final2` (NCC, `ncc_heads`) and `final3`
    (Ku novel) heads: the Stage-1.5 and Stage-2 model. With `head="cosine"`
    (the reference's `MinkUNetRCCosine`) `final` and `final2` are
    `NormedLinear`; `final3` stays linear.

    Returns {'feats', 'logits_known', 'logits_ncc', 'logits_novel'}; the
    assemblers below build the reference's logit layouts. The heads sit
    inside the encoder (`encoder.final`, `encoder.final2`, `encoder.final3`),
    where the reference checkpoint keeps them."""

    def __init__(self, num_labeled: int, num_novel: int, ncc_heads: int = 3,
                 arch: str = "MinkUNet34", planes: tuple = DEFAULT_PLANES,
                 in_channels: int = 1, dtype: torch.dtype = torch.float32,
                 generator: torch.Generator | None = None, head: str = "linear",
                 remat: bool = False):
        super().__init__()
        self.encoder = MinkUNetBackbone(arch, planes, in_channels, dtype=dtype,
                                        generator=generator, remat=remat)
        c = self.encoder.out_channels
        self.encoder.final = make_head(head, c, num_labeled, generator)
        self.encoder.final2 = make_head(head, c, ncc_heads, generator)
        self.encoder.final3 = Linear(c, num_novel, generator=generator)

    def forward(self, plan, feats):
        h = self.encoder(plan, feats).float()
        valid = plan.levels[0].valid
        out = {
            "feats": h,
            "logits_known": mask_rows(self.encoder.final(h), valid),
            "logits_ncc": mask_rows(self.encoder.final2(h), valid),
            "logits_novel": mask_rows(self.encoder.final3(h), valid),
        }
        if is_sharded(plan):
            out["sp_overflow"] = self.encoder.sp_overflow(plan)
        return out


def assemble_dummy_logits(out: dict) -> torch.Tensor:
    """[final | max(final2)]: the reference's `forward_dummy`."""
    ncc_max = out["logits_ncc"].max(dim=-1, keepdim=True).values
    return torch.cat([out["logits_known"], ncc_max], dim=-1)


def assemble_dummy_logits_mean(out: dict) -> torch.Tensor:
    """[final | mean(final2)]: the RCAblation mean NCC pooling (reference
    `models/minkunet.py:324-334`)."""
    return torch.cat([out["logits_known"], out["logits_ncc"].mean(dim=-1, keepdim=True)], dim=-1)


def assemble_dummy_logits_sum(out: dict) -> torch.Tensor:
    """[final | sum(final2)]: the RCAblation sum NCC pooling (reference
    `models/minkunet.py:336-346`)."""
    return torch.cat([out["logits_known"], out["logits_ncc"].sum(dim=-1, keepdim=True)], dim=-1)


def assemble_novel_logits(out: dict) -> torch.Tensor:
    """[final | final3 | max(final2)]: the reference's `forward_novel`."""
    ncc_max = out["logits_ncc"].max(dim=-1, keepdim=True).values
    return torch.cat([out["logits_known"], out["logits_novel"], ncc_max], dim=-1)


def assemble_dummy_logits_from_heads(feats: torch.Tensor, params_final: dict,
                                     params_final2: dict) -> torch.Tensor:
    """Dummy logits [known | max(ncc)] from raw head weights (`kernel`
    [Ci, Co], `bias`), for mixed features (reference
    `exp_merge_mean_teacher.py:2822-2825` reads `.kernel` / `.bias`)."""
    kin = feats @ params_final["kernel"] + params_final["bias"]
    kout = feats @ params_final2["kernel"] + params_final2["bias"]
    return torch.cat([kin, kout.amax(dim=-1, keepdim=True)], dim=-1)
