"""The lower-precision control at the cell's own size, on the card: the
f32 reference with every product's operands in float8 e4m3 in the
program's place must come out not correct on every seed, and a half batch
too. Run on the card with
`python -m pytest benchmark/tests/test_bench_control.py -m gpu`
(about a minute a seed)."""

import pytest

from benchmark import run
from benchmark.reference import quant

SEEDS = (11, 12, 13)


@pytest.mark.gpu
@pytest.mark.parametrize("kind", ["fp8", "half"])
@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("workload", ["s2.minkunet34.lasermix"])
def test_control_fails_at_the_cell_size(card, workload, seed, kind):
    c = run.cell(run.load_spec(), workload)
    nums = c["entry"].control(c["cfg"], seed, card, quant=quant.CONTROLS.get(kind),
                              drop_half=kind == "half")
    assert any(nums[k] > v for k, v in c["limits"].items() if k in nums), nums
