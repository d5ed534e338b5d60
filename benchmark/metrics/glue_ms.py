"""Device time per step of the model's glue around its convs: the kernels
launched inside the four backbone passes (`discover/teacher`,
`discover/student_main_fwd`, `discover/student_mix_fwd`, `discover/backward`)
less those launched inside `conv/fwd` and `conv/bwd` (`ops/fused_conv`
`SubmConvFn` / `PoolConvFn`): batch norm, activations, casts, masks, the
heads and the loss terms taken inside the passes, and autograd's own work,
over the window's steps."""

from benchmark import spans


def read(inp):
    tr = inp.get("trace")
    if tr is None or not tr.device or not inp.get("steps") or not tr.spans.get("conv/fwd"):
        return None
    return spans.glue_us(tr) / 1e3 / inp["steps"]
