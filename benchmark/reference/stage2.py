"""Plain PyTorch reference of GCDLSS's Stage-2 training step (mean teacher,
voxel LaserMix, NCC candidate mining with k-means and a Hungarian match),
in float32, over the backbone it is given: a reference module by the
contract of `reference/__init__.py` (`forward` and its three heads).

One step, as `ExpMergeDiscover_LaserMix_MeanTeacher_NCCAdaptive` defines it:
  * the combined plan of the labeled scans (batch 0..S-1) and the unlabeled
    ones (S..2S-1);
  * the teacher's forward of the backbone (batch norm in training mode, no
    gradient): its logits [known | max NCC] and their softmax;
  * the LaserMix plan: each level-0 voxel of pair i goes to mixed scan i if
    its centre's pitch band (of num_areas between -25 and 3 degrees, counted
    from the top) is even on the labeled side or odd on the unlabeled one,
    else to mixed scan S + i; labels are the labeled side's, or the
    teacher's argmax where its top probability reaches `pseudo_thr`;
  * candidates: unlabeled voxels whose teacher NCC logit exceeds tau; at
    most `cand_cap` of them, in the order of a multiplicative hash of their
    row; cosine k-means over them and the queue into Ku + alpha clusters
    (initial rows by the smallest uniform draw); the alpha clusters whose
    centroid the known head scores highest are dropped; the rest renumbered
    in order and matched to the novel head's argmax by the best permutation
    (the first in lexicographic order among equals);
  * the loss: CE on labeled voxels, 200 x the MSE of the student's and the
    teacher's probabilities on unlabeled voxels, 0.1 x CE on the mixed scans,
    0.05 x the calibration CE, 0.2 x the threshold hinges, and, where a
    cluster survived, 0.1 x the novel CE of the candidates, 1.0 x the novel
    CE of the labeled voxels and 0.1 x the NCC CE of the candidates;
  * SGD with momentum (weight decay added to the gradient), the EMA of the
    student's parameters into the teacher, and the surviving candidates'
    teacher features pushed into the queue.
"""

from __future__ import annotations

import itertools
import math

import torch

from .sparse import Plan, pack

NUM_AREAS = (3, 4, 5, 6)
HASH = -1640531527


def lr_at(step: int, cfg: dict) -> float:
    """Linear warm-up from `min_lr` over `warmup_epochs`, then a cosine to
    `min_lr` at `epochs`; one value an epoch of `steps_per_epoch` steps."""
    epoch = step // max(cfg["steps_per_epoch"], 1)
    base, low, warm, total = cfg["lr"], cfg["min_lr"], cfg["warmup_epochs"], cfg["epochs"]
    if epoch < warm:
        return low + epoch * (base - low) / max(warm - 1, 1)
    span = max(total - warm, 1)
    return low + 0.5 * (base - low) * (1.0 + math.cos(math.pi * (epoch - warm) / span))


def band_parity(xyz: torch.Tensor, num_areas: torch.Tensor) -> torch.Tensor:
    down, up = -25.0 / 180.0 * math.pi, 3.0 / 180.0 * math.pi
    rho = torch.sqrt(xyz[..., 0] ** 2 + xyz[..., 1] ** 2)
    p = torch.atan2(xyz[..., 2], rho).clamp(down + 1e-5, up - 1e-5)
    step = (up - down) / num_areas.to(torch.float32)
    band = ((up - p) / step).to(torch.int32)
    return torch.minimum(band.clamp(min=0), num_areas.to(torch.int32) - 1) % 2


def ce(logits, labels):
    m = labels >= 0
    logp = torch.log_softmax(logits, dim=-1)
    nll = -logp.gather(1, labels.clamp(min=0)[:, None])[:, 0]
    return (nll * m).sum() / m.sum().clamp(min=1)


def _normalize(x, eps=1e-8):
    return x / torch.linalg.vector_norm(x, dim=-1, keepdim=True).clamp(min=eps)


def kmeans(x, valid, k, scores, iters):
    x = _normalize(x) * valid[:, None]
    init = torch.sort(scores + (~valid) * 1e6, stable=True).indices[:k]
    cents = x[init]
    for _ in range(iters):
        a = (x @ _normalize(cents).T).argmax(dim=-1)
        onehot = torch.nn.functional.one_hot(a, k).to(x.dtype) * valid[:, None]
        sums, counts = onehot.T @ x, onehot.sum(dim=0)[:, None]
        cents = torch.where(counts > 0, sums / counts.clamp(min=1), cents)
    return torch.where(valid, (x @ _normalize(cents).T).argmax(dim=-1), -1), cents


def mine(cand_feats, cand_valid, n_cand: int, qfeats, qvalid, scores, heads: dict,
         cfg: dict) -> dict:
    """The novel assignment of the candidates: cosine k-means over them and
    the queue, the alpha clusters the known head (`heads["final"]`) scores
    highest dropped, the rest renumbered in order and matched to the novel
    head's (`heads["final3"]`) argmax by the best permutation. {"rel": the
    reliable candidates, "n_rel", "has_novel", "mapped": each candidate's
    novel class}."""
    dev, K, Ku, cap = cand_feats.device, cfg["num_known"], cfg["num_novel"], cand_feats.shape[0]
    all_feats = torch.cat([cand_feats, qfeats])
    all_valid = torch.cat([cand_valid, qvalid])
    nclu = Ku + cfg["alpha"]
    assign_all, cents = kmeans(all_feats, all_valid, nclu, scores, cfg["kmeans_iters"])
    cl = cents @ heads["final"][0] + heads["final"][1]
    unreliable = torch.sort(cl.max(-1).values, descending=True, stable=True).indices[:cfg["alpha"]]
    assign = assign_all[:cap]
    rel = cand_valid & ~(assign[:, None] == unreliable[None, :]).any(1)
    n_rel = int(rel.sum())
    has_novel = n_cand > 0 and int(all_valid.sum()) > nclu and n_rel > 0
    present = torch.zeros(nclu, dtype=torch.int64, device=dev)
    present[assign[rel]] = 1
    new_id = torch.cumsum(present, 0) - 1
    rel_labels = new_id[assign.clamp(0, nclu - 1)].clamp(0, Ku - 1)
    preds = (cand_feats @ heads["final3"][0] + heads["final3"][1]).argmax(-1)
    cost = torch.zeros((Ku, Ku), dtype=torch.int64, device=dev)
    cost.index_put_((preds[rel], rel_labels[rel]), torch.ones_like(preds[rel]), accumulate=True)
    perms = torch.tensor(list(itertools.permutations(range(Ku))), device=dev)
    row_of_col = perms[cost[perms, torch.arange(Ku, device=dev)[None, :]].sum(1).argmax()]
    return {"rel": rel, "n_rel": n_rel, "has_novel": has_novel,
            "mapped": row_of_col[rel_labels] + K}


def push(queue: torch.Tensor, counts: torch.Tensor, head: int, cand_feats, rel):
    """The queue with the reliable candidates' features (the first
    `per_slot` of them, in order) written into slot `head`, the rest of the
    slot zero: (features, counts, next head)."""
    queue, counts = queue.clone(), counts.clone()
    kept = cand_feats[rel][:queue.shape[1]]
    queue[head] = 0
    queue[head, :kept.shape[0]] = kept
    counts[head] = kept.shape[0]
    return queue, counts, (head + 1) % queue.shape[0]


class Stage2:
    """The step's state: parameters, batch-norm statistics of the student and
    the teacher, the teacher's parameters, tau, momentum buffers, the queue
    and the generator of the step's draws. `backbone` is the reference module
    whose `forward` makes the three passes."""

    def __init__(self, backbone, cfg: dict, params: dict, stats: dict, seed: int, device,
                 quant=None):
        self.backbone, self.cfg, self.quant, self.device = backbone, cfg, quant, device
        self.params = {k: v.clone().requires_grad_(True) for k, v in params.items()}
        self.tau = torch.tensor(cfg["tau_init"], device=device, requires_grad=True)
        self.teacher = {k: v.clone() for k, v in params.items()}
        self.stats = {k: v.clone() for k, v in stats.items()}
        self.teacher_stats = {k: v.clone() for k, v in stats.items()}
        self.buf = {}
        slots, per, dim = cfg["queue_slots"], cfg["queue_per_slot"], cfg["feat_dim"]
        self.queue = torch.zeros((slots, per, dim), device=device)
        self.queue_counts = torch.zeros(slots, dtype=torch.int64, device=device)
        self.queue_head = 0
        self.generator = torch.Generator(device=device).manual_seed(seed)
        self.step_count = cfg["start_step"]

    def draws(self):
        g = self.generator
        pick = torch.randint(len(NUM_AREAS), (), generator=g, device=self.device)
        n = self.cfg["cand_cap"] + self.cfg["queue_slots"] * self.cfg["queue_per_slot"]
        return torch.tensor(NUM_AREAS, device=self.device)[pick], torch.rand(
            n, generator=g, device=self.device)

    def step(self, sup: dict, unsup: dict, drop_half: bool = False) -> dict:
        """One step on the two sides' collated batches (tensors on the
        device). `drop_half` leaves out the second half of each side's scans
        (a fault the comparison must catch)."""
        cfg, dev, q = self.cfg, self.device, self.quant
        S, K = cfg["scans_per_side"], cfg["num_known"]
        unk = cfg["unknown_label"]
        num_areas, scores = self.draws()

        def rows(side, shift):
            v = side["valid"]
            if drop_half:
                v = v & (side["coords"][:, 0] < S // 2)
            c = side["coords"][v].to(torch.int64)
            c[:, 0] += shift
            return c, side["feats"][v], side["mapped_labels"][v].long()

        cs, fs, ms = rows(sup, 0)
        cu, fu, mu = rows(unsup, S)
        coords0 = torch.cat([cs, cu])
        feats0, mapped0 = torch.cat([fs, fu]), torch.cat([ms, mu])
        n0 = coords0.shape[0]
        is_sup = torch.arange(n0, device=dev) < cs.shape[0]
        plan = Plan(coords0, cfg["caps"])
        if plan.levels[0].n != n0:
            raise ValueError("level 0 over its capacity")

        with torch.no_grad():
            out_t = self.backbone.forward(self.teacher, self.teacher_stats, plan, feats0, cfg, q)
            dummy_t = torch.cat([out_t["known"], out_t["ncc"].max(-1, keepdim=True).values], -1)
            probs_t = torch.softmax(dummy_t, dim=-1)
            maxp_t, argm_t = probs_t.max(dim=-1)

            # the LaserMix plan over the combined level-0 voxels
            center = (coords0[:, 1:4].to(torch.float32) + 0.5) * cfg["voxel_size"]
            par = band_parity(center, num_areas)
            b = coords0[:, 0]
            pair = torch.where(is_sup, b, b - S)
            in1 = torch.where(is_sup, par == 0, par == 1)
            mcoords = torch.cat([torch.where(in1, pair, S + pair)[:, None], coords0[:, 1:]], 1)
            order = torch.argsort(pack(mcoords), stable=True)
            mix_plan = Plan(mcoords[order], cfg["mix_caps"])
            pseudo = torch.where(~is_sup & (maxp_t >= cfg["pseudo_thr"]), argm_t, -1)
            mix_feats0 = feats0[order]
            mix_labels0 = torch.where(is_sup, mapped0, pseudo)[order]

            # NCC candidates in hashed row order, capped
            cand = (dummy_t[:, -1] > self.tau) & ~is_sup
            n_cand = int(cand.sum())
            cap = cfg["cand_cap"]
            h = (torch.arange(n0, device=dev) * HASH) & 0x07FFFFFF
            key = torch.where(cand, h, h + (1 << 27))
            take = min(n_cand, cap)
            crow = torch.argsort(key, stable=True)[:take]
            cand_valid = torch.arange(cap, device=dev) < take
            cand_feats = torch.zeros((cap, out_t["feats"].shape[1]), device=dev)
            cand_feats[:take] = out_t["feats"][crow]
            cand_rows = torch.zeros(cap, dtype=torch.int64, device=dev)
            cand_rows[:take] = crow

            qvalid = (torch.arange(cfg["queue_per_slot"], device=dev)[None, :]
                      < self.queue_counts[:, None]).reshape(-1)
            P = self.params
            heads = {h: (P[f"encoder.{h}.kernel"], P[f"encoder.{h}.bias"])
                     for h in ("final", "final3")}
            m = mine(cand_feats, cand_valid, n_cand, self.queue.reshape(-1, self.queue.shape[-1]),
                     qvalid, scores, heads, cfg)
            rel, n_rel, has_novel, mapped_novel = m["rel"], m["n_rel"], m["has_novel"], m["mapped"]

        # the student's passes and the loss
        out_s = self.backbone.forward(P, self.stats, plan, feats0, cfg, q)
        dummy_s = torch.cat([out_s["known"], out_s["ncc"].max(-1, keepdim=True).values], -1)
        sup_t = torch.where(is_sup, mapped0, -1)
        l_sup = ce(dummy_s, sup_t)
        um = (~is_sup).to(torch.float32)[:, None]
        d2 = (torch.softmax(dummy_s, -1) - probs_t).square()
        l_mse = cfg["mse_coeff"] * (d2 * um).sum() / (um.sum() * d2.shape[1]).clamp(min=1)
        out_m = self.backbone.forward(P, self.stats, mix_plan, mix_feats0, cfg, q)
        dummy_m = torch.cat([out_m["known"], out_m["ncc"].max(-1, keepdim=True).values], -1)
        l_lm = cfg["lasermix_coeff"] * ce(dummy_m, mix_labels0)
        gt = torch.nn.functional.one_hot(sup_t.clamp(0, K), K + 1).bool()
        masked = torch.where(gt, torch.full_like(dummy_s, -1e9), dummy_s)
        cal_t = torch.where((sup_t == unk) | (sup_t < 0), -1, unk)
        l_cal = cfg["calib_coeff"] * ce(masked, cal_t)
        ncc = dummy_s[:, -1]
        known_m, unk_m = (sup_t >= 0) & (sup_t != unk), sup_t == unk

        def mmean(x, m):
            return (x * m).sum() / m.sum().clamp(min=1) if bool(m.any()) else x.sum() * 0

        l_thr = cfg["threshold_loss_weight"] * (mmean(torch.relu(ncc - self.tau), known_m)
                                                + mmean(torch.relu(self.tau - ncc), unk_m))
        f3 = P["encoder.final3.kernel"], P["encoder.final3.bias"]
        f2 = P["encoder.final2.kernel"], P["encoder.final2.bias"]
        stud_cand = dummy_s[cand_rows][:, :-1]
        l_nu = cfg["novel_coeff"] * ce(torch.cat([stud_cand, cand_feats @ f3[0] + f3[1]], -1),
                                       torch.where(rel, mapped_novel, -1))
        l_ns = cfg["sup_novel_coeff"] * ce(
            torch.cat([dummy_s[:, :-1], out_s["feats"] @ f3[0] + f3[1]], -1), sup_t)
        ncc_rel = (cand_feats @ f2[0] + f2[1]).max(-1, keepdim=True).values
        l_ncc = cfg["ncc_coeff"] * ce(torch.cat([stud_cand, ncc_rel], -1),
                                      torch.where(rel, unk, -1))
        gate = 1.0 if has_novel else 0.0
        loss = l_sup + l_mse + l_lm + l_cal + l_thr + gate * (l_nu + l_ns + l_ncc)

        leaves = {**P, "tau": self.tau}
        grads = torch.autograd.grad(loss, list(leaves.values()))
        lr = lr_at(self.step_count, cfg)
        with torch.no_grad():
            for (name, p), g in zip(leaves.items(), grads):
                d = g + cfg["weight_decay"] * p
                buf = self.buf.get(name)
                self.buf[name] = d.clone() if buf is None else buf.mul_(cfg["momentum"]).add_(d)
                p.sub_(lr * self.buf[name])
            m = cfg["ema_momentum"]
            for name, t in self.teacher.items():
                t.mul_(1.0 - m).add_(P[name], alpha=m)
            if has_novel:
                self.queue, self.queue_counts, self.queue_head = push(
                    self.queue, self.queue_counts, self.queue_head, cand_feats, rel)
        self.step_count += 1
        terms = {"loss": loss, "sup_seg": l_sup, "mse": l_mse, "lasermix": l_lm, "calib": l_cal,
                 "thr_loss": l_thr, "novel_unsup": gate * l_nu, "novel_sup": gate * l_ns,
                 "ncc_unsup": gate * l_ncc}
        return {**{k: float(v.detach()) for k, v in terms.items()}, "n_cand": n_cand, "n_rel": n_rel,
                "has_novel": int(has_novel),
                "plan_overflow": plan.overflow() + mix_plan.overflow()}
