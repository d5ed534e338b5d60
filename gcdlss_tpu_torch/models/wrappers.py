"""Model-wrapper zoo: NOPS-style multi-head, fine-tune, SSL, dual and cosine
variants (PyTorch port of `gcdlss_tpu/models/wrappers.py`, reference
`models/multiheadminkunet.py:121-629`, `models/multiheadminkunet_nops.py:80-197`).

  * `MultiHeadMinkUnet`: backbone + labeled prototypes + N unlabeled heads
    (+ over-clustering heads), the NOPS discovery model;
  * `MultiHeadMinkUnetFineTune`: backbone + a linear head over all classes;
  * `MultiHeadSelfSupMinkUnet`: backbone + projection MLP for SSL
    pretraining (SimGCD's normalised features before `final` on request);
  * `DualMinkUnet`: two backbones over one input;
  * `MinkUNetSegCosine`: the cosine-classifier segmentation model.

The JAX package's quirks are kept: `MultiHeadMinkUnet` builds its unlabeled
heads when `num_heads` is truthy and leaves `logits_unlab` unmasked; only it
passes `dtype` to its backbone, the other four build f32 backbones. Module
names are the flax ones (`encoder`, `backbone`, `encoder_a`, `head_lab`, ...).
"""

from __future__ import annotations

import torch
from torch import nn

from .heads import MultiHead, ProjectionHead, Prototypes
from .layers import Linear, mask_rows
from .minkunet import DEFAULT_PLANES, MinkUNetBackbone, MinkUNetSeg


class MultiHeadMinkUnet(nn.Module):
    """NOPS discovery model: prototypes for the labeled classes + multi-head
    (optionally over-clustered) prototypes for the novel ones."""

    def __init__(self, num_labeled: int, num_unlabeled: int, num_heads: int = 1,
                 overcluster_factor: int | None = None, arch: str = "MinkUNet34",
                 planes: tuple = DEFAULT_PLANES, in_channels: int = 1,
                 dtype: torch.dtype = torch.float32,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.encoder = MinkUNetBackbone(arch, planes, in_channels, dtype=dtype,
                                        generator=generator)
        c = self.encoder.out_channels
        self.head_lab = Prototypes(c, num_labeled, generator)
        self.head_unlab = (MultiHead(c, num_unlabeled, num_heads, generator=generator)
                           if num_heads else None)
        self.head_unlab_over = (MultiHead(c, num_unlabeled * overcluster_factor, num_heads,
                                          generator=generator)
                                if overcluster_factor else None)

    def forward(self, plan, feats):
        h = self.encoder(plan, feats).float()
        out = {"feats": h, "logits_lab": mask_rows(self.head_lab(h), plan.levels[0].valid)}
        if self.head_unlab is not None:
            out["logits_unlab"] = self.head_unlab(h)
        if self.head_unlab_over is not None:
            out["logits_unlab_over"] = self.head_unlab_over(h)
        return out


class MultiHeadMinkUnetFineTune(nn.Module):
    def __init__(self, num_labeled: int, num_classes: int, arch: str = "MinkUNet34",
                 planes: tuple = DEFAULT_PLANES, in_channels: int = 1,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.encoder = MinkUNetBackbone(arch, planes, in_channels, generator=generator)
        self.head_lab2 = Linear(self.encoder.out_channels, num_classes, generator=generator)

    def forward(self, plan, feats):
        h = self.encoder(plan, feats)
        return {"feats": h, "logits_lab": mask_rows(self.head_lab2(h), plan.levels[0].valid)}


class MultiHeadSelfSupMinkUnet(nn.Module):
    """SSL wrapper: the `metric_learner` projection MLP and a linear `final`
    head; `simgcd=True` normalises the features' rows before `final`
    (`multiheadminkunet.py:585-590`)."""

    def __init__(self, out_dim: int = 128, simgcd: bool = False, arch: str = "MinkUNet34",
                 planes: tuple = DEFAULT_PLANES, in_channels: int = 1,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.simgcd = simgcd
        self.backbone = MinkUNetBackbone(arch, planes, in_channels, generator=generator)
        c = self.backbone.out_channels
        self.metric_learner = ProjectionHead(c, generator=generator)
        self.final = Linear(c, out_dim, generator=generator)

    def forward(self, plan, feats):
        h = self.backbone(plan, feats)
        hh = h
        if self.simgcd:
            hh = h / torch.linalg.vector_norm(h, dim=-1, keepdim=True).clamp(min=1e-12)
        return {"feats": h, "proj_feats": self.metric_learner(h),
                "logits": mask_rows(self.final(hh), plan.levels[0].valid)}


class DualMinkUnet(nn.Module):
    """Two independent backbones over one input (NOPS `DualMinkUnet`,
    `multiheadminkunet_nops.py:145-197`)."""

    def __init__(self, num_labeled: int, num_unlabeled: int, arch: str = "MinkUNet34",
                 planes: tuple = DEFAULT_PLANES, in_channels: int = 1,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.encoder_a = MinkUNetBackbone(arch, planes, in_channels, generator=generator)
        self.encoder_b = MinkUNetBackbone(arch, planes, in_channels, generator=generator)
        c = self.encoder_a.out_channels
        self.head_lab = Prototypes(c, num_labeled, generator)
        self.head_unlab = Prototypes(c, num_unlabeled, generator)

    def forward(self, plan, feats):
        valid = plan.levels[0].valid
        ha = self.encoder_a(plan, feats)
        hb = self.encoder_b(plan, feats)
        return {"feats_a": ha, "feats_b": hb,
                "logits_lab": mask_rows(self.head_lab(ha), valid),
                "logits_unlab": mask_rows(self.head_unlab(hb), valid)}


class MinkUNetSegCosine(MinkUNetSeg):
    """Cosine-classifier segmentation model (MinkUNetBaseCosine): the JAX
    package's tree is `MinkUNetSeg`'s with a cosine `final`, so it is that
    model with `head="cosine"`, f32."""

    def __init__(self, num_classes: int, arch: str = "MinkUNet34",
                 planes: tuple = DEFAULT_PLANES, in_channels: int = 1,
                 generator: torch.Generator | None = None):
        super().__init__(num_classes, arch, planes, in_channels, generator=generator,
                         head="cosine")
