"""The numbers that decide `correct` for a Stage-2 training cell.

Each side reports the loss terms of every checked step, the candidate count
of every step, and per leaf (a parameter, or a batch-norm statistic of the
student or the teacher) the norm of: its first gradient as the optimizer
got it (the momentum buffer after step 1: the gradient plus weight decay),
its change after step 1 (statistics) and after the last checked step. A
leaf's gap is |program's norm - reference's norm| over the reference's norm
of that leaf or of the median leaf, whichever is larger.

The numbers:
  * `loss1_gap`: the first step's loss without the three terms the
    clusters decide (novel_unsup, ncc_unsup and the novel gate), relative;
  * `n_cand_gap`: the NCC candidate count, worst step, relative;
  * `stats1_gap`: the batch-norm statistics after step 1 (the teacher's
    pass and the student's two), worst leaf;
  * `stats_gap`: the same after the last checked step, median leaf;
  * `grad_gap`: the first gradient, median leaf;
  * `change_gap`: the parameters' change after the last checked step,
    median leaf of each group (the student's with tau, and the teacher's,
    which the EMA moves by a hundredth as much), the larger of the two.
The mining's own numbers (`mining_gap`, `queue_gap`) come from the entry's
`mining_check`, which runs the reference's mining on the program's inputs.
The worst leaf of the first gradient and of the change, and every step's
whole loss, are reported beside them (`worst_*`, `loss_gap`) and not held:
the clusters' discrete choices decide them (PERF.md, "How `correct` is
decided"). Parameters whose reference gradient is under a thousandth of the
median leaf's move by round-off alone and are left out of the change, with
the teacher's copy of them.
"""

from __future__ import annotations

import statistics

import torch

# the loss terms the k-means clusters and the Hungarian match decide
MINED_TERMS = ("novel_unsup", "ncc_unsup")


def leaf_norms(tensors: dict) -> dict:
    return {k: float(torch.linalg.vector_norm(v.detach().double())) for k, v in tensors.items()}


def deltas(after: dict, before: dict) -> dict:
    return {k: float(torch.linalg.vector_norm(after[k].detach().double()
                                              - before[k].detach().double()))
            for k in before}


def gaps(prog: dict, ref: dict) -> dict:
    floor = statistics.median(ref.values())
    return {k: abs(prog.get(k, 0.0) - r) / max(r, floor) if max(r, floor) > 0
            else abs(prog.get(k, 0.0)) for k, r in ref.items()}


def worst(g: dict) -> tuple:
    leaf = max(g, key=g.get)
    return g[leaf], leaf


def moved(grad_ref: dict) -> set:
    """The parameters whose reference gradient reaches a thousandth of the
    median leaf's."""
    floor = 1e-3 * statistics.median(grad_ref.values())
    return {k for k, v in grad_ref.items() if v >= floor}


def unmined_loss(terms: dict) -> float:
    return terms["loss"] - sum(terms[k] for k in MINED_TERMS)


def numbers(prog: dict, ref: dict) -> dict:
    """The compared numbers of one run. Each side: `terms` [per step: the
    loss and its terms], `n_cand` [per step], `grad` {leaf: norm} after step
    1, `stats1` {leaf: change} after step 1, and `change` {group: {leaf:
    change}} after the last checked step, groups "student" (parameters and
    tau), "teacher" (parameters) and "stats"."""
    p1, r1 = unmined_loss(prog["terms"][0]), unmined_loss(ref["terms"][0])
    keep = moved(ref["grad"])
    g_groups = {grp: gaps(prog["change"][grp],
                          {k: v for k, v in ref["change"][grp].items() if k in keep})
                for grp in ("student", "teacher")}
    g_change = {f"{grp}:{k}": v for grp, g in g_groups.items() for k, v in g.items()}
    g_grad = gaps(prog["grad"], ref["grad"])
    g_stats1 = gaps(prog["stats1"], ref["stats1"])
    g_stats = gaps(prog["change"]["stats"], ref["change"]["stats"])
    out = {
        "loss1_gap": abs(p1 - r1) / abs(r1),
        "n_cand_gap": max(abs(p - r) / max(r, 1) for p, r in zip(prog["n_cand"], ref["n_cand"])),
        "stats1_gap": worst(g_stats1)[0],
        "stats_gap": statistics.median(g_stats.values()),
        "grad_gap": statistics.median(g_grad.values()),
        "change_gap": max(statistics.median(g.values()) for g in g_groups.values()),
    }
    wg, wgl = worst(g_grad)
    wc, wcl = worst(g_change)
    out.update({f"{grp}_change_gap": statistics.median(g.values())
                for grp, g in g_groups.items()})
    out.update({
        "loss_gap": max(abs(p["loss"] - r["loss"]) / abs(r["loss"])
                        for p, r in zip(prog["terms"], ref["terms"])),
        "worst_grad_gap": wg, "worst_grad_leaf": wgl, "worst_change_gap": wc,
        "worst_change_leaf": wcl, "worst_stats1_leaf": worst(g_stats1)[1],
        "left_out": sorted(set(ref["grad"]) - keep)})
    return out
