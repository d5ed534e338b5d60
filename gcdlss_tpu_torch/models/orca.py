"""ORCA-legacy models: a MinkUNet backbone and one prototype or cosine head
(PyTorch port of `gcdlss_tpu/models/orca.py`, reference
`models/minkunet_orca.py`).

  * `MinkUnetToy18` (`minkunet_orca.py:49-84`): MinkUNet18 with the A18
    planes and a linear `Prototypes` head `head_lab` over its features;
  * `MinkUnet34ORCA` (`minkunet_orca.py:87-121`): MinkUNet34 with the C34
    planes and the 10x cosine `NormedLinear` head `linear`.

Both take one (plan, feats) pair, cast the features to f32 before the head,
and zero the logits of invalid rows. The backbone is `encoder`, with the
reference checkpoint's module names inside (`models.minkunet`).
"""

from __future__ import annotations

import torch
from torch import nn

from .heads import Prototypes
from .layers import NormedLinear, mask_rows
from .minkunet import PLANE_VARIANTS, MinkUNetBackbone


class MinkUnetToy18(nn.Module):
    def __init__(self, num_classes: int, arch: str = "MinkUNet18",
                 planes: tuple = PLANE_VARIANTS["A18"], in_channels: int = 1,
                 dtype: torch.dtype = torch.float32,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.encoder = MinkUNetBackbone(arch, planes, in_channels, dtype=dtype,
                                        generator=generator)
        self.head_lab = Prototypes(self.encoder.out_channels, num_classes, generator)

    def forward(self, plan, feats):
        h = self.encoder(plan, feats).float()
        return {"logits": mask_rows(self.head_lab(h), plan.levels[0].valid), "feats": h}


class MinkUnet34ORCA(nn.Module):
    def __init__(self, num_classes: int, arch: str = "MinkUNet34",
                 planes: tuple = PLANE_VARIANTS["C34"], in_channels: int = 1,
                 dtype: torch.dtype = torch.float32,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.encoder = MinkUNetBackbone(arch, planes, in_channels, dtype=dtype,
                                        generator=generator)
        self.linear = NormedLinear(self.encoder.out_channels, num_classes, generator=generator)

    def forward(self, plan, feats):
        h = self.encoder(plan, feats).float()
        return {"logits": mask_rows(self.linear(h), plan.levels[0].valid), "feats": h}
