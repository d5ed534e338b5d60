"""The Cylinder3D backbone family on the port's sparse-conv engine (PyTorch
port of `gcdlss_tpu/models/cylinder3d.py`):

  * `SegVFE`: a point-feature MLP and a dynamic-scatter max pool into
    cylindrical voxels, compressed to 16 channels (reference
    `models/encoder.py:23-171`);
  * `Asymm3DSpconv`: asymmetric (1,3,3)/(3,1,3) submanifold residual
    blocks, four `AsymmeDownBlock`s (a strided k=3 conv; the first two pool
    the height too), four `AsymmeUpBlock`s (an inverse k=3 conv and the
    skip) and the `DDCMBlock` context gate (reference
    `models/backbone.py:258-714`);
  * `Cylinder3DHead`: a submanifold logit conv with CE + 3 x Lovasz
    (reference `models/decoder.py:182-326`);
  * `Cylinder3DRC`: the Stage-2 discovery model on this backbone, with
    `MinkUNetRC`'s interface and heads;
  * `MultiHeadCylinder3D`: the supervised trainer's model
    (`train/cylinder.py`).

Every asymmetric kernel reads a column subset of one 27-offset map per
level. `build_cyl_plan` slices each level's five subsets once, contiguous,
as K1 reads its books (`CylLevel.books`); every such subset is
negation-symmetric in offset order, so the column-reversed book is its
adjoint and K2 reads it in place (`reverse=True`). The strided convs run on
the paired down/up books (`ops.asym`) through `fused_conv.pool_conv`: K1
forward, K2 over the partner book backward. On the CPU the same wrappers
take their plain versions. The model is f32: on the card its convs round x
and W to bf16 and keep f32 sums. Parameter names follow the JAX package's
tree (`utils.weights.cylinder_jax_to_state_dict`).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch
from torch import nn

from ..ops.asym import inverse_up_map, offset_subset, pool_coords, strided_down_map
from ..ops.coords import SENTINEL_HI, decode_keys, encode_coords, sorted_unique
from ..ops.fused_conv import pool_conv, subm_conv
from ..ops.lovasz import lovasz_softmax
from ..ops.plan import KERNEL_OFFSETS_3, neighbor_map
from ..ops.scatter import cylindrical_coords, dynamic_scatter
from .layers import Linear, SparseBatchNorm, kaiming_conv_, mask_rows

HEIGHT_POOLING = (True, True, False, False)
FULL = (3, 3, 3)
# the kernel shapes the backbone convolves with, each a column subset of the 27
KERNEL_SHAPES = ((1, 3, 3), (3, 1, 3), (3, 1, 1), (1, 3, 1), (1, 1, 3), FULL)
POINT_FEATS = 3  # point features of the supervised trainer (the JAX state's init input)


def _subset_columns(kernel_shape) -> np.ndarray:
    """The subset's columns; raises unless the subset is negation-symmetric
    in offset order (column K-1-k is offset -k), the adjoint the kernels
    read the book's reverse for."""
    cols = offset_subset(kernel_shape)
    offs = KERNEL_OFFSETS_3[cols]
    if not ((offs + offs[::-1]) == 0).all():
        raise ValueError(f"the offsets of kernel shape {kernel_shape} are not "
                         "negation-symmetric: the reversed book is not their adjoint")
    return cols


class CylLevel(NamedTuple):
    coords: torch.Tensor  # [cap, 4] int32 (b, rho, phi, z) bins
    valid: torch.Tensor  # [cap] bool
    count: torch.Tensor  # int32: unique voxels before the capacity
    nbr27: torch.Tensor  # [cap, 27] int32 rows (-1 absent), offsets z fastest
    books: dict  # kernel shape -> its contiguous column subset of nbr27


class CylEdge(NamedTuple):
    down_map: torch.Tensor  # [Nc, 27] fine rows of the strided k=3 conv
    up_map: torch.Tensor  # [Nf, 27] coarse rows of the inverse k=3 conv


class CylPlan(NamedTuple):
    levels: tuple
    edges: tuple


def level_books(nbr27: torch.Tensor) -> dict:
    """Each kernel shape's column subset of a level's map, sliced once."""
    return {shape: nbr27 if shape == FULL else
            nbr27[:, torch.as_tensor(_subset_columns(shape), device=nbr27.device).long()]
            .contiguous() for shape in KERNEL_SHAPES}


def build_cyl_plan(coords: torch.Tensor, valid: torch.Tensor, caps: tuple,
                   height_pooling=HEIGHT_POOLING) -> CylPlan:
    """The asymmetric backbone's plan: len(caps) levels (the base and the
    pooled ones), each with its 27-offset map (K3 on the card) and subsets,
    and the paired books of each edge. A level keeps at most its cap of
    unique voxels."""
    hi, lo = encode_coords(coords, valid)
    (uh, ul), _, _, count = sorted_unique(hi, lo, caps[0])
    cvalid = uh != SENTINEL_HI
    cur = {"coords": torch.where(cvalid[:, None], decode_keys(uh, ul), 0), "valid": cvalid,
           "keys": (uh, ul), "count": count}
    levels, edges = [], []
    for i in range(len(caps)):
        nbr = neighbor_map(*cur["keys"], 3)
        levels.append(CylLevel(cur["coords"], cur["valid"], cur["count"], nbr, level_books(nbr)))
        if i + 1 == len(caps):
            break
        stride = (2, 2, 2) if height_pooling[i] else (2, 2, 1)
        nxt = pool_coords(cur["coords"], cur["valid"], stride, caps[i + 1])
        edges.append(CylEdge(strided_down_map(nxt["coords"], nxt["valid"], cur["keys"], stride),
                             inverse_up_map(cur["coords"], cur["valid"], nxt["keys"], stride)))
        cur = nxt
    return CylPlan(tuple(levels), tuple(edges))


def cylinder_caps(cap0: int, cyl_cap_ratio: float = 0.5, depth: int = 5) -> tuple:
    """`Cylinder3DRC`'s cylinder-level caps from the UNet's cap0: the base at
    `cyl_cap_ratio` of it, halved per level, multiples of 256."""
    ccap = max(256, int(cap0 * cyl_cap_ratio) // 256 * 256)
    return tuple(max(256, (ccap >> i) // 256 * 256) for i in range(depth))


class AsymSubMConv(nn.Module):
    """Submanifold conv over one kernel shape's column subset of the level map."""

    def __init__(self, in_channels: int, features: int, kernel_shape,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.kernel_shape = tuple(kernel_shape)
        k = len(_subset_columns(self.kernel_shape))
        self.kernel = nn.Parameter(kaiming_conv_(torch.empty(k, in_channels, features),
                                                 generator))

    def forward(self, x, level: CylLevel):
        return mask_rows(subm_conv(x, level.books[self.kernel_shape], self.kernel), level.valid)


class _ConvActBN(nn.Module):
    def __init__(self, in_channels: int, features: int, kernel_shape,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.conv = AsymSubMConv(in_channels, features, kernel_shape, generator)
        self.bn = SparseBatchNorm(features)

    def forward(self, x, level: CylLevel):
        h = self.conv(x, level)
        # where(h >= 0, ...): at h == 0 the gradient is 1, as in the JAX
        # package (torch's leaky_relu gives the slope there), and the VFE's
        # relu leaves exact zeros
        h = torch.where(h >= 0, h, 0.01 * h)
        return self.bn(h, level.valid)


def _pool_kernel(features: int, generator) -> nn.Parameter:
    return nn.Parameter(kaiming_conv_(torch.empty(27, features, features), generator))


class AsymmResBlock(nn.Module):
    def __init__(self, in_channels: int, features: int, generator=None):
        super().__init__()
        self.c0_0 = _ConvActBN(in_channels, features, (1, 3, 3), generator)
        self.c0_1 = _ConvActBN(features, features, (3, 1, 3), generator)
        self.c1_0 = _ConvActBN(in_channels, features, (3, 1, 3), generator)
        self.c1_1 = _ConvActBN(features, features, (1, 3, 3), generator)

    def forward(self, x, level: CylLevel):
        s = self.c0_1(self.c0_0(x, level), level)
        r = self.c1_1(self.c1_0(x, level), level)
        return r + s


class AsymmeDownBlock(nn.Module):
    """Residual asymmetric convs, then the strided k=3 conv onto the next
    level over the paired books (down_map forward, up_map its adjoint)."""

    def __init__(self, in_channels: int, features: int, generator=None):
        super().__init__()
        self.c0_0 = _ConvActBN(in_channels, features, (3, 1, 3), generator)
        self.c0_1 = _ConvActBN(features, features, (1, 3, 3), generator)
        self.c1_0 = _ConvActBN(in_channels, features, (1, 3, 3), generator)
        self.c1_1 = _ConvActBN(features, features, (3, 1, 3), generator)
        self.pool_kernel = _pool_kernel(features, generator)

    def forward(self, x, level: CylLevel, edge: CylEdge, next_valid):
        s = self.c0_1(self.c0_0(x, level), level)
        r = self.c1_1(self.c1_0(x, level), level)
        res = r + s
        pooled = mask_rows(pool_conv(res, edge.down_map, edge.up_map, self.pool_kernel),
                           next_valid)
        return pooled, res


class AsymmeUpBlock(nn.Module):
    """A full k=3 conv on the coarse level, the inverse k=3 conv onto the fine
    level over the paired books (up_map forward, down_map its adjoint), the
    skip, and three asymmetric convs."""

    def __init__(self, in_channels: int, features: int, generator=None):
        super().__init__()
        self.trans = _ConvActBN(in_channels, features, FULL, generator)
        self.up_kernel = _pool_kernel(features, generator)
        self.c1 = _ConvActBN(features, features, (1, 3, 3), generator)
        self.c2 = _ConvActBN(features, features, (3, 1, 3), generator)
        self.c3 = _ConvActBN(features, features, FULL, generator)

    def forward(self, x, coarse: CylLevel, fine: CylLevel, edge: CylEdge, skip):
        h = self.trans(x, coarse)
        up = mask_rows(pool_conv(h, edge.up_map, edge.down_map, self.up_kernel), fine.valid)
        up = up + skip
        return self.c3(self.c2(self.c1(up, fine), fine), fine)


class DDCMBlock(nn.Module):
    """The dimension-decomposition context gate: sigmoid(bn(conv)) along each
    axis, summed, times the input."""

    def __init__(self, features: int, generator=None):
        super().__init__()
        for name, shape in (("c1", (3, 1, 1)), ("c2", (1, 3, 1)), ("c3", (1, 1, 3))):
            self.add_module(name, AsymSubMConv(features, features, shape, generator))
            self.add_module(name + "_bn", SparseBatchNorm(features))

    def forward(self, x, level: CylLevel):
        gate = 0.0
        for name in ("c1", "c2", "c3"):
            h = getattr(self, name)(x, level)
            gate = gate + torch.sigmoid(getattr(self, name + "_bn")(h, level.valid))
        return mask_rows(gate * x, level.valid)


class Asymm3DSpconv(nn.Module):
    """The asymmetric UNet over a `CylPlan`; returns 4 x base_channels
    features at the base level."""

    def __init__(self, in_channels: int = 16, base_channels: int = 32, depth: int = 4,
                 generator: torch.Generator | None = None):
        super().__init__()
        c = base_channels
        self.depth = depth
        self.down_context = AsymmResBlock(in_channels, c, generator)
        ch = c
        for i in range(depth):
            self.add_module(f"down{i}", AsymmeDownBlock(ch, 2 ** (i + 1) * c, generator))
            ch = 2 ** (i + 1) * c
        for i in range(depth - 1, -1, -1):
            self.add_module(f"up{i}", AsymmeUpBlock(ch, 2 ** (i + 1) * c, generator))
            ch = 2 ** (i + 1) * c
        self.ddcm = DDCMBlock(2 * c, generator)
        self.out_channels = 4 * c

    def forward(self, plan: CylPlan, feats):
        lv = plan.levels
        x = self.down_context(feats, lv[0])
        skips = []
        for i in range(self.depth):
            x, skip = getattr(self, f"down{i}")(x, lv[i], plan.edges[i], lv[i + 1].valid)
            skips.append(skip)
        for i in range(self.depth - 1, -1, -1):
            x = getattr(self, f"up{i}")(x, lv[i + 1], lv[i], plan.edges[i], skips[i])
        return torch.cat([self.ddcm(x, lv[0]), x], dim=-1)


class SegVFE(nn.Module):
    """Point MLP and a max pool into cylindrical voxels. The point features
    are the (rho, phi, z) coordinates, the caller's `point_channels` and, with
    `with_voxel_center`, the offset to the voxel's centre."""

    def __init__(self, point_channels: int, feat_channels: tuple = (64, 128, 256, 256),
                 feat_compression: int = 16, with_voxel_center: bool = True,
                 point_cloud_range: tuple = (0.0, -np.pi, -4.0, 50.0, np.pi, 2.0),
                 grid_shape: tuple = (240, 180, 20),
                 generator: torch.Generator | None = None):
        super().__init__()
        self.with_voxel_center = with_voxel_center
        self.grid_shape = tuple(grid_shape)
        # the bin constants in float32, as the JAX package rounds its float64
        # numpy ones (`ops.scatter`)
        lo = np.asarray(point_cloud_range[:3], np.float64)
        vs = (np.asarray(point_cloud_range[3:], np.float64) - lo) / (np.asarray(grid_shape) - 1)
        self.register_buffer("lo", torch.as_tensor(lo, dtype=torch.float32), persistent=False)
        self.register_buffer("vs", torch.as_tensor(vs, dtype=torch.float32), persistent=False)
        self.register_buffer("half_vs", torch.as_tensor(vs / 2, dtype=torch.float32),
                             persistent=False)
        width = 3 + point_channels + (3 if with_voxel_center else 0)
        self.pre_norm = SparseBatchNorm(width)
        self.n = len(feat_channels)
        for i, ch in enumerate(feat_channels):
            self.add_module(f"vfe{i}", Linear(width, ch, generator=generator))
            if i < self.n - 1:
                self.add_module(f"vfe{i}_bn", SparseBatchNorm(ch))
            width = ch
        self.compress = Linear(width, feat_compression, generator=generator)

    def forward(self, points_xyz, point_feats, batch_idx, valid, voxel_cap: int) -> dict:
        cyl = cylindrical_coords(points_xyz)
        coords3 = torch.floor((cyl - self.lo) / self.vs).to(torch.int32)
        grid = torch.as_tensor(self.grid_shape, dtype=torch.int32, device=cyl.device)
        in_range = ((coords3 >= 0) & (coords3 < grid)).all(dim=-1) & valid
        coords = torch.cat([batch_idx[:, None].to(torch.int32), coords3], dim=1)
        feats = torch.cat([cyl, point_feats], dim=-1)
        if self.with_voxel_center:
            center = coords3.float() * self.vs + self.lo + self.half_vs
            feats = torch.cat([feats, cyl - center], dim=-1)
        feats = feats * in_range[:, None]
        h = self.pre_norm(feats, in_range)
        for i in range(self.n):
            h = getattr(self, f"vfe{i}")(h)
            if i < self.n - 1:
                h = torch.relu(getattr(self, f"vfe{i}_bn")(h, in_range))
        vox = dynamic_scatter(h, coords, in_range, voxel_cap, mode="max")
        vfeats = torch.relu(self.compress(vox["feats"]))
        return {"feats": mask_rows(vfeats, vox["valid"]), "coords": vox["coords"],
                "valid": vox["valid"], "inverse": vox["inverse"]}


class Cylinder3DHead(nn.Module):
    """Submanifold k=3 logit conv (K1 on the card); CE + 3 x Lovasz."""

    def __init__(self, in_channels: int, num_classes: int,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.kernel = nn.Parameter(kaiming_conv_(torch.empty(27, in_channels, num_classes),
                                                 generator))
        self.bias = nn.Parameter(torch.zeros(num_classes))

    def forward(self, feats, level: CylLevel):
        return mask_rows(subm_conv(feats, level.nbr27, self.kernel) + self.bias, level.valid)

    @staticmethod
    def loss(logits, labels, valid, lovasz_weight: float = 3.0):
        from ..losses import cross_entropy

        ce = cross_entropy(logits, labels, valid)
        lv = lovasz_softmax(torch.softmax(logits, dim=-1), labels, valid)
        return ce + lovasz_weight * lv, {"ce": ce, "lovasz": lv}


class Cylinder3DRC(nn.Module):
    """The Stage-2 discovery model on Cylinder3D, with `MinkUNetRC`'s
    interface: `forward(plan, feats)` on a UNet plan, the same output keys,
    and the heads `final` (K known), `final2` (NCC) and `final3` (Ku novel)
    inside `encoder`, where the Stage-2 step reads them.

    The UNet plan's level-0 voxel centres (coords x voxel_size) are the
    point cloud `SegVFE` re-voxelizes cylindrically; the backbone's
    features return to the input rows through the VFE's inverse map. The
    cylinder caps come from the UNet's cap0 (`cylinder_caps`). f32 only, as
    in the JAX package."""

    def __init__(self, num_labeled: int, num_novel: int, ncc_heads: int = 3,
                 voxel_size: float = 0.05, base_channels: int = 32,
                 grid_shape: tuple = (240, 180, 20), cyl_cap_ratio: float = 0.5,
                 in_channels: int = 1, generator: torch.Generator | None = None):
        super().__init__()
        self.voxel_size = voxel_size
        self.cyl_cap_ratio = cyl_cap_ratio
        self.vfe = SegVFE(in_channels, grid_shape=grid_shape, generator=generator)
        self.encoder = Asymm3DSpconv(self.vfe.compress.kernel.shape[1], base_channels,
                                     generator=generator)
        c = self.encoder.out_channels
        self.encoder.final = Linear(c, num_labeled, generator=generator)
        self.encoder.final2 = Linear(c, ncc_heads, generator=generator)
        self.encoder.final3 = Linear(c, num_novel, generator=generator)

    def forward(self, plan, feats) -> dict:
        lvl0 = plan.levels[0]
        valid = lvl0.valid
        step = torch.tensor(self.voxel_size, dtype=torch.float32, device=feats.device)
        xyz = lvl0.coords[:, 1:4].float() * step
        caps = cylinder_caps(lvl0.coords.shape[0], self.cyl_cap_ratio)
        vfe = self.vfe(xyz, feats.float(), lvl0.coords[:, 0], valid, caps[0])
        h_cyl = self.encoder(build_cyl_plan(vfe["coords"], vfe["valid"], caps), vfe["feats"])
        # cylinder voxel -> input row (decoder.py:182-326 predict())
        inv = vfe["inverse"]
        ok = (inv >= 0) & (inv < h_cyl.shape[0]) & valid
        h = (h_cyl[torch.where(ok, inv, 0).long()] * ok[:, None]).float()
        enc = self.encoder
        return {
            "feats": h,
            "logits_known": mask_rows(enc.final(h), valid),
            "logits_ncc": mask_rows(enc.final2(h), valid),
            "logits_novel": mask_rows(enc.final3(h), valid),
        }


class MultiHeadCylinder3D(nn.Module):
    """The supervised trainer's model: SegVFE -> Asymm3DSpconv -> a labeled
    head and `num_heads` unlabeled ones (and over-clustering heads), all
    bias-free, at the cylinder voxels."""

    def __init__(self, num_labeled: int, num_unlabeled: int, num_heads: int = 1,
                 overcluster_factor: int | None = None, base_channels: int = 32,
                 grid_shape: tuple = (240, 180, 20),
                 caps: tuple = (65536, 32768, 16384, 8192, 4096),
                 point_channels: int = POINT_FEATS, generator: torch.Generator | None = None):
        super().__init__()
        self.caps = tuple(caps)
        self.num_heads = num_heads
        self.overcluster_factor = overcluster_factor
        self.encoder = SegVFE(point_channels, grid_shape=grid_shape, generator=generator)
        self.backbone = Asymm3DSpconv(self.encoder.compress.kernel.shape[1], base_channels,
                                      generator=generator)
        c = self.backbone.out_channels
        self.head_lab = Linear(c, num_labeled, bias=False, generator=generator)
        for k in range(num_heads):
            self.add_module(f"head_unlab{k}", Linear(c, num_unlabeled, bias=False,
                                                     generator=generator))
        if overcluster_factor:
            for k in range(num_heads):
                self.add_module(f"head_unlab_over{k}", Linear(
                    c, num_unlabeled * overcluster_factor, bias=False, generator=generator))

    def forward(self, points_xyz, point_feats, batch_idx, valid) -> dict:
        vfe = self.encoder(points_xyz, point_feats, batch_idx, valid, self.caps[0])
        plan = build_cyl_plan(vfe["coords"], vfe["valid"], self.caps)
        h = self.backbone(plan, vfe["feats"])
        valid0 = plan.levels[0].valid
        out = {"feats": h, "voxel_valid": valid0, "point_inverse": vfe["inverse"],
               "logits_lab": mask_rows(self.head_lab(h), valid0),
               "logits_unlab": torch.stack([getattr(self, f"head_unlab{k}")(h)
                                            for k in range(self.num_heads)])}
        if self.overcluster_factor:
            out["logits_unlab_over"] = torch.stack([getattr(self, f"head_unlab_over{k}")(h)
                                                    for k in range(self.num_heads)])
        return out

