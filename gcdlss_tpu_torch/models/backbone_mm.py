"""mmdet3d-topology MinkUNet backbone and the LaserMix-baseline wrapper
(PyTorch port of `gcdlss_tpu/models/backbone_mm.py`).

  * `MinkUNetBackboneMM` (reference `models/backbone.py:47-254`): a stem of
    two k3 submanifold convs at `base_channels` on `levels[0].nbr3` (not the
    k5 `stem_nbr`); per encoder stage a channel-preserving k2s2 down conv,
    batch norm, ReLU and `encoder_blocks[i]` residual blocks to
    `encoder_channels[i]`; per decoder stage a k2s2 up conv to
    `decoder_channels[i]`, batch norm, ReLU, the lateral concat and
    `decoder_blocks[i]` blocks, the first of which changes the width through
    its 1x1 projection (384 -> 256 at L3, 192 -> 128, 128 -> 96, 128 -> 96
    at L0 at the default widths).
  * `MultiHeadMinkUnet18` (reference `models/minkunet_lasermix.py:54-181`):
    that backbone + `head_lab` Prototypes + `head_unlab` MultiHead (+ the
    over-clustering heads). Unlike `MultiHeadMinkUnet`, it tests
    `num_heads is not None` and zeroes the unlabeled logits of invalid rows.

It runs on the port's `UNetPlan`, its convs and blocks (`models.minkunet`'s
`BasicBlock` / `Bottleneck`): every sparse conv through K1 / K2 on the card.
Module names are the flax ones (`conv_input{s}`, `bn_input{s}`,
`enc{i}_down`, `enc{i}_bn`, `enc{i}_blocks.{j}`, `dec{i}_up`, `dec{i}_bn`,
`dec{i}_blocks.{j}`), with the blocks' projection under `downsample`, as in
`models.minkunet`.
"""

from __future__ import annotations

import torch
from torch import nn

from .heads import MultiHead, Prototypes
from .layers import SparseBatchNorm, SparseConv, SparseDownConv, SparseUpConv, mask_rows
from .minkunet import BLOCKS, ResLayer


class _MMResLayer(ResLayer):
    """`blocks` residual blocks of `kind`; the first changes the width (with
    a 1x1 projection, `backbone.py:156-166`)."""

    def __init__(self, kind: str, inplanes: int, planes: int, blocks: int,
                 dtype: torch.dtype, generator: torch.Generator | None = None):
        super().__init__(inplanes, planes, blocks, dtype, generator, kind)


class MinkUNetBackboneMM(nn.Module):
    """mmdet3d `MinkUNetBackbone` over a 5-level `UNetPlan` (stride-1 out)."""

    def __init__(self, in_channels: int = 1, base_channels: int = 32,
                 encoder_channels: tuple = (32, 64, 128, 256),
                 decoder_channels: tuple = (256, 128, 96, 96),
                 encoder_blocks: tuple = (2, 2, 2, 2), decoder_blocks: tuple = (2, 2, 2, 2),
                 block_type: str = "basic", dtype: torch.dtype = torch.float32,
                 generator: torch.Generator | None = None):
        super().__init__()
        if len(encoder_channels) != len(decoder_channels):
            raise ValueError("the encoder and decoder need as many stages")
        self.dtype = dtype
        self.n_stages = len(encoder_channels)
        exp = BLOCKS[block_type][1]
        g = generator
        # `backbone.py:127-139`: two k3 convs
        c = in_channels
        for s in range(2):
            self.add_module(f"conv_input{s}", SparseConv(c, base_channels, 27, g))
            self.add_module(f"bn_input{s}", SparseBatchNorm(base_channels))
            c = base_channels
        # `backbone.py:146-173`
        lateral = [c]
        for i, planes in enumerate(encoder_channels):
            self.add_module(f"enc{i}_down", SparseDownConv(c, c, g))
            self.add_module(f"enc{i}_bn", SparseBatchNorm(c))
            self.add_module(f"enc{i}_blocks", _MMResLayer(block_type, c, planes,
                                                          encoder_blocks[i], dtype, g))
            c = planes * exp
            lateral.append(c)
        lateral = lateral[:-1][::-1]
        # `backbone.py:175-206`
        for i, planes in enumerate(decoder_channels):
            self.add_module(f"dec{i}_up", SparseUpConv(c, planes, g))
            self.add_module(f"dec{i}_bn", SparseBatchNorm(planes))
            self.add_module(f"dec{i}_blocks", _MMResLayer(block_type, planes + lateral[i], planes,
                                                          decoder_blocks[i], dtype, g))
            c = planes * exp
        self.out_channels = c

    def forward(self, plan, feats):
        lv, pools = plan.levels, plan.pools
        if len(pools) != self.n_stages:
            raise ValueError("plan depth must match the stage count")
        x = feats.to(self.dtype)
        for s in range(2):
            x = getattr(self, f"conv_input{s}")(x, lv[0].nbr3, lv[0].valid)
            x = torch.relu(getattr(self, f"bn_input{s}")(x, lv[0].valid))
        laterals = [x]
        for i in range(self.n_stages):
            x = getattr(self, f"enc{i}_down")(x, pools[i], lv[i + 1].valid)
            x = torch.relu(getattr(self, f"enc{i}_bn")(x, lv[i + 1].valid))
            x = getattr(self, f"enc{i}_blocks")(x, lv[i + 1].nbr3, lv[i + 1].valid)
            laterals.append(x)
        laterals = laterals[:-1][::-1]
        for i in range(self.n_stages):
            lvl = self.n_stages - 1 - i  # target level (3, 2, 1, 0)
            x = getattr(self, f"dec{i}_up")(x, pools[lvl], lv[lvl].valid)
            x = torch.relu(getattr(self, f"dec{i}_bn")(x, lv[lvl].valid))
            x = torch.cat([x, laterals[i]], dim=1)
            x = getattr(self, f"dec{i}_blocks")(x, lv[lvl].nbr3, lv[lvl].valid)
        return x  # [cap0, decoder_channels[-1] x expansion]


class MultiHeadMinkUnet18(nn.Module):
    """LaserMix-baseline model (`minkunet_lasermix.py:54-181`)."""

    def __init__(self, num_labeled: int, num_unlabeled: int, num_heads: int | None = 1,
                 overcluster_factor: int | None = None, dtype: torch.dtype = torch.float32,
                 base_channels: int = 32, encoder_channels: tuple = (32, 64, 128, 256),
                 decoder_channels: tuple = (256, 128, 96, 96), in_channels: int = 1,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.backbone = MinkUNetBackboneMM(in_channels, base_channels, encoder_channels,
                                           decoder_channels, dtype=dtype, generator=generator)
        c = self.backbone.out_channels
        self.head_lab = Prototypes(c, num_labeled, generator)
        self.head_unlab = (MultiHead(c, num_unlabeled, num_heads, generator=generator)
                           if num_heads is not None else None)
        self.head_unlab_over = (MultiHead(c, num_unlabeled * overcluster_factor, num_heads,
                                          generator=generator)
                                if overcluster_factor is not None else None)

    def forward(self, plan, feats):
        h = self.backbone(plan, feats).float()
        valid = plan.levels[0].valid
        vmask = valid[None, :, None].to(h.dtype)
        out = {"feats": h, "logits_lab": mask_rows(self.head_lab(h), valid)}
        if self.head_unlab is not None:
            out["logits_unlab"] = self.head_unlab(h) * vmask
            out["proj_feats_unlab"] = h
        if self.head_unlab_over is not None:
            out["logits_unlab_over"] = self.head_unlab_over(h) * vmask
            out["proj_feats_unlab_over"] = h
        return out
