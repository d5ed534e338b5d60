"""The model work of a step, summed from its backbone's passes, whatever
code does it. The arithmetic of one conv or product (`conv_work`, `pairs`,
`dense_ops`) is in `reference/work.py`; a backbone counts its own pass with
it (its reference module's `pass_work`).
"""

from __future__ import annotations

from .reference.work import conv_work, dense_ops, pairs  # noqa: F401


def stage2_step(plan, mix_plan, cfg: dict, pass_work) -> dict:
    """The Stage-2 step's model work: the teacher's forward on the combined
    plan, the student's forward and backward on the combined and the mixed
    plans, each counted by `pass_work(plan, cfg, grad)`.
    {"model_ops", "conv_ops", "conv_bound_ms"}. The plans are reference
    `Plan`s."""
    parts = [pass_work(plan, cfg, False), pass_work(plan, cfg, True),
             pass_work(mix_plan, cfg, True)]
    conv_ops = sum(p["conv_ops"] for p in parts)
    return {"model_ops": conv_ops + sum(p["dense_ops"] for p in parts), "conv_ops": conv_ops,
            "conv_bound_ms": sum(p["conv_bound_ms"] for p in parts)}
