"""Sparse layers and the MinkUNet family of the PyTorch port, with the library
heads and wrappers (the exports of `gcdlss_tpu/models/__init__.py`)."""

from .backbone_mm import MinkUNetBackboneMM, MultiHeadMinkUnet18
from .heads import CosinePrototypes, EquiangularPrototypes, MultiHead, ProjectionHead, Prototypes
from .layers import NormedLinear, SparseBatchNorm, SparseConv, SparseDownConv, SparseUpConv
from .minkunet import (ARCHS, PLANE_VARIANTS, MinkUNetBackbone, MinkUNetRC, MinkUNetSeg,
                       assemble_dummy_logits, assemble_dummy_logits_mean,
                       assemble_dummy_logits_sum, assemble_novel_logits)
from .orca import MinkUnet34ORCA, MinkUnetToy18

__all__ = [
    "SparseConv",
    "SparseDownConv",
    "SparseUpConv",
    "SparseBatchNorm",
    "NormedLinear",
    "MinkUNetBackbone",
    "MinkUNetSeg",
    "MinkUNetRC",
    "ARCHS",
    "PLANE_VARIANTS",
    "assemble_dummy_logits",
    "assemble_dummy_logits_mean",
    "assemble_dummy_logits_sum",
    "assemble_novel_logits",
    "Prototypes",
    "CosinePrototypes",
    "ProjectionHead",
    "MultiHead",
    "EquiangularPrototypes",
]
