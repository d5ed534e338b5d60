"""LiON energy-based OOD losses (PyTorch port of `gcdlss_tpu/losses_lion.py`).

Functional rebuilds of the reference's `utils/loss_LiON.py` for
`ExpMergeDiscover_LaserMix_LiON_MeanTeacher`: the Gambler reservation loss
with an energy-score reward, the smoothness and sparsity regularizers and
the (crude-)dynamic energy margin losses, on voxel rows instead of dense
[B, C, X, Y, Z] grids (the smoothness term runs over a plan's k = 3
neighbor map).

Ported as the JAX package has them, including what looks odd: the
in-distribution logits drop column 0 as well as the unknown column, and the
Gambler loss treats targets <= 0 as void, although class 0 is a real class
of the label space (ROADMAP "Known behaviours"). Every term is computed in
f32 whatever the logits' type: the -99999 column and the clamps would give
inf or NaN in bf16.

With a process `group` (`parallel.mesh`), `energy_loss` and `gambler_loss`
(the Stage-2 step's two) give the rank's share of the loss over every
rank's rows: the masked means are over the global counts, the sparsity
term's square root is taken of the sum over the ranks (on rank 0, its
gradient reaching every rank through `all_reduce_sum`), and the branches
are decided on the global counts, so every rank takes the same one.
"""

from __future__ import annotations

import torch

from .parallel.mesh import all_reduce, all_reduce_sum, rank_of

_M_IN = -12.0
_M_OUT = -6.0


def _in_distribution(logits: torch.Tensor, ood_ind: int) -> torch.Tensor:
    return torch.cat([logits[:, 1:ood_ind], logits[:, ood_ind + 1:]], dim=-1)


def energy_of(logits: torch.Tensor, ood_ind: int, temperature: float = 1.0) -> torch.Tensor:
    """E(x) = -T logsumexp(in-distribution logits / T); column 0 and the OOD
    column are left out."""
    x = _in_distribution(logits.float(), ood_ind)
    return -(temperature * torch.logsumexp(x / temperature, dim=-1))


def smooth_reg(energy: torch.Tensor, nbr: torch.Tensor, valid: torch.Tensor,
               lam: float = 3e-6) -> torch.Tensor:
    """Neighbor smoothness on the sparse voxel graph: lam / 3 times the sum
    over the map's edges of (E_i - E_j)^2."""
    e_n = energy[torch.where(nbr >= 0, nbr, 0).long()]
    ok = (nbr >= 0) & valid[:, None]
    return lam * ((energy[:, None] - e_n).square() * ok).sum() / 3.0


def sparsity_reg(values: torch.Tensor, mask: torch.Tensor, lam: float = 5e-4,
                 group=None) -> torch.Tensor:
    m = mask.to(values.dtype)
    total = all_reduce_sum(((values.square()) * m).sum(), group)
    reg = lam * torch.sqrt(total.clamp(min=1e-12))
    # every rank holds the global term: rank 0's share is all of it
    return reg if group is None else reg * (rank_of(group) == 0)


def _masked_mean(x: torch.Tensor, m: torch.Tensor, group=None) -> torch.Tensor:
    mm = m.to(torch.float32)
    s = all_reduce(mm.sum(), group)
    return torch.where(s > 0, (x * mm).sum() / s.clamp(min=1.0), 0.0)


def _any(m: torch.Tensor, group) -> torch.Tensor:
    return all_reduce(m.sum(), group) > 0


def energy_loss(logits, targets, valid, ood_ind: int = 5, nbr=None, group=None):
    """Squared-hinge energy margins: in-distribution rows below m_in, OOD
    rows above m_out. Returns (loss, energy)."""
    energy = energy_of(logits, ood_ind)
    is_out = (targets == ood_ind) & valid
    is_in = (targets != ood_ind) & (targets != 0) & (targets >= 0) & valid
    l_in = _masked_mean(torch.relu(energy - _M_IN).square(), is_in, group)
    l_out = _masked_mean(torch.relu(_M_OUT - energy).square(), is_out, group)
    loss = torch.where(_any(is_out, group),
                       0.5 * (l_in + l_out) + sparsity_reg(energy, is_out, group=group), l_in)
    if nbr is not None:
        loss = loss + smooth_reg(energy, nbr, valid)
    return loss, energy


def crude_dynamic_energy_loss(logits, targets, valid, details_targets, ood_ind: int = 5,
                              m_out_max: float = 0.0, resized_point_label: int = 20,
                              resize_m_out: float = -6.0, nbr=None):
    """Separate energy margins for REAL-resized points and ShapeNet-inserted
    points (`loss_LiON.py:339-383`). Returns (loss, energy)."""
    shapenet_label = resized_point_label + 1
    energy = energy_of(logits, ood_ind)
    is_out = (targets == ood_ind) & valid
    is_in = (targets != ood_ind) & (targets != 0) & (targets >= 0) & valid
    l_in = _masked_mean(torch.relu(energy - _M_IN).square(), is_in)
    resized = (details_targets == resized_point_label) & valid
    spn = (details_targets >= shapenet_label) & valid
    l_resized = _masked_mean(torch.relu(resize_m_out - energy).square(), resized)
    l_spn = _masked_mean(torch.relu(m_out_max - energy).square(), spn)
    cnt = (resized.sum() > 0).to(torch.float32) + (spn.sum() > 0).to(torch.float32)
    l_out = (l_resized + l_spn) / (cnt + 1e-8)
    loss = torch.where(is_out.sum() > 0, 0.5 * (l_out + l_in) + sparsity_reg(energy, is_out),
                       l_in)
    if nbr is not None:
        loss = loss + smooth_reg(energy, nbr, valid)
    return loss, energy


def gambler_loss(logits, targets, valid, unknown_cls_idx: int, reward_default: float,
                 ood_reg: float = 0.1, has_ood: bool = True, group=None) -> torch.Tensor:
    """Reservation (Gambler) loss: the unknown column's probability is an
    abstention channel, scaled down by a squared energy reward
    (`loss_LiON.py:46-181`; the reference's 3D gaussian blur of the reward
    is left out, as in the JAX package). Column 0 is left out throughout."""
    logits = logits.float()
    logits = torch.cat([torch.full_like(logits[:, :1], -99999.0), logits[:, 1:]], dim=-1)
    prob = torch.softmax(logits, dim=-1).clamp(1e-7, 1.0)
    u = unknown_cls_idx
    true_pred = torch.cat([prob[:, :u], prob[:, u + 1:]], dim=-1)
    reward = torch.logsumexp(_in_distribution(logits, u), dim=-1).square()
    reservation = prob[:, u] / reward.clamp(min=reward_default)

    is_ood = (targets == u) & valid
    is_void = (targets <= 0) | ~valid
    # shift the targets past the removed unknown column
    t = torch.where(is_ood | is_void, 0, targets)
    shifted = (t - (t > u).to(t.dtype)).clamp(0, true_pred.shape[1] - 1)
    g_in = true_pred.gather(1, shifted[:, None].long())[:, 0] + reservation
    loss_in = _masked_mean(torch.log(g_in.clamp(min=1e-7)), ~is_ood & ~is_void, group)
    if has_ood:
        boost = torch.log((true_pred + reservation[:, None]).clamp(min=1e-7))
        return -(loss_in + ood_reg * _masked_mean(boost.mean(dim=-1), is_ood, group))
    return -loss_in
