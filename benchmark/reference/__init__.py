"""Plain PyTorch and NumPy reference of what the benchmark's cells run: it
imports nothing of the program and takes nothing the program made.

A configuration names its backbone's reference by `"reference_model":
"<name>"`, and `backbone(name)` finds it as the module `<name>.py` of this
package, as `"entry"` names the cell's driver `entries/<entry>.py`. The
Stage-2 step (`stage2.Stage2`), the weights (`weights.make`), the work
counts (`counts.stage2_step`) and the controls take the backbone from there.
A backbone's module provides:

  * `spec(cfg)`: name -> (shape, init) of every parameter, the init
    ("normal", std) or ("const", value), and of every batch-norm statistic,
    ("stat", value). The names are those of the program's model's
    `state_dict`, leaf for leaf and shape for shape (a run checks them);
    a statistic's name holds `running_`. The heads the step and the mining
    read by name: `encoder.final` (known classes), `encoder.final2` (NCC
    heads) and `encoder.final3` (novel classes), each a `.kernel`
    [feat_dim, n] and a `.bias` [n].
  * `forward(params, stats, plan, feats0, cfg, quant)`: one pass over a
    `sparse.Plan` of the step's level-0 voxels and their input features
    `feats0`, in float32, differentiable in `params`, batch norm in training
    mode moving `stats` in place, every product's operands rounded by
    `quant` where it is given. Returns, per level-0 row of the plan,
    `known` [n0, num_known], `ncc` [n0, ncc_heads] and `feats` [n0,
    feat_dim], the features the heads read.
  * `pass_work(plan, cfg, grad)`: {"conv_ops", "conv_bound_ms",
    "dense_ops"} of one such pass, forward and with `grad` its backward,
    counted with `work.py` whatever code does the pass.

`minkunet.py` is the first.
"""

from __future__ import annotations

import importlib
from pathlib import Path


def backbone(name: str):
    """The reference backbone module `<name>.py` of this package."""
    if not name.isidentifier():
        raise ValueError(f"reference model {name!r}: not a module name")
    full = f"{__name__}.{name}"
    try:
        return importlib.import_module(full)
    except ModuleNotFoundError as e:
        if e.name != full:
            raise
        raise FileNotFoundError(
            f"reference model {name!r}: no file {Path(__file__).parent / f'{name}.py'}") from None
