"""Operations and bytes of the work a step has to do, counted from the plan
and the widths, whatever code does it.

A sparse conv over a book with P present (output, input) pairs and widths
Ci -> Co does 2 P Ci Co operations forward, as many for the input's gradient
(dX) and as many for the kernel's (dW). Its bytes, each read or written
once: forward x, W, the book (int32, one entry per output row and offset)
and the output; dX the cotangent, W, the adjoint book and dX; dW x, the
cotangent, the adjoint book and dW in float32. Activations and kernels count
at `act_bytes` (2: bf16 operands, the kernels' type whatever the caller's).
A dense 1x1 product over N rows does 2 N Ci Co operations each way.
"""

from __future__ import annotations

from . import peaks


def pairs(book: list) -> int:
    return int(sum(int(o.numel()) for o, _ in book))


def conv_work(p: int, k: int, ci: int, co: int, n_out: int, n_in: int, act_bytes: int = 2,
              grad: bool = False, need_dx: bool = True) -> list:
    """[(part, operations, bytes)] of one sparse conv: "fwd", and with
    `grad` "dx" (unless `need_dx` is false) and "dw"."""
    ops = 2 * p * ci * co
    w = k * ci * co * act_bytes
    out = [("fwd", ops, n_in * ci * act_bytes + w + n_out * k * 4 + n_out * co * act_bytes)]
    if grad:
        if need_dx:
            out.append(("dx", ops, n_out * co * act_bytes + w + n_in * k * 4
                        + n_in * ci * act_bytes))
        out.append(("dw", ops, (n_in * ci + n_out * co) * act_bytes + n_in * k * 4
                    + k * ci * co * 4))
    return out


def dense_ops(n: int, ci: int, co: int, grad: bool) -> int:
    return 2 * n * ci * co * (3 if grad else 1)


def minkunet_pass(plan, cfg: dict, grad: bool) -> dict:
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
            "conv_bound_ms": sum(peaks.bound_ms(b, o)[0] for _, o, b in convs),
            "dense_ops": dense}


def stage2_step(plan, mix_plan, cfg: dict) -> dict:
    """The Stage-2 step's model work: the teacher's forward on the combined
    plan, the student's forward and backward on the combined and the mixed
    plans. {"model_ops", "conv_ops", "conv_bound_ms"}. The plans are
    reference `Plan`s."""
    parts = [minkunet_pass(plan, cfg, False), minkunet_pass(plan, cfg, True),
             minkunet_pass(mix_plan, cfg, True)]
    conv_ops = sum(p["conv_ops"] for p in parts)
    return {"model_ops": conv_ops + sum(p["dense_ops"] for p in parts), "conv_ops": conv_ops,
            "conv_bound_ms": sum(p["conv_bound_ms"] for p in parts)}
