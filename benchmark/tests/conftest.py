"""Shared fixtures of the benchmark's own tests (run from the repository
root: `python -m pytest benchmark/tests -q`)."""

import pytest
import torch

# each cell cut to a size the CPU runs in seconds: four 3,000-point scans a
# step, small capacities, MinkUNet14 at narrow widths in place of MinkUNet34;
# every other setting is the cell's own
TINY = dict(points_per_scan=3000, downsampling=2000, distinct_scans=4, repeat=20,
            voxel_caps=[8192] * 5, mix_voxel_caps=[8192] * 5, caps=(8192,) * 5,
            mix_caps=(8192,) * 5, sup_voxel_cap=4096, queue_per_slot=64, num_workers=2)
CUTS = {"s2.minkunet34.lasermix": dict(arch="MinkUNet14", blocks=[1] * 8, feat_dim=8,
                                       planes=[8, 8, 16, 16, 16, 16, 8, 8])}


@pytest.fixture(params=sorted(CUTS))
def tiny_cell(request):
    """Each cell as `run.cell` finds it, cut to TINY, on two CPU threads."""
    from benchmark import run

    c = run.cell(run.load_spec(), request.param)
    c["cfg"].update(TINY, **CUTS[request.param])
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield c
    torch.set_num_threads(threads)


@pytest.fixture
def card():
    """The CUDA device, or a skip: decided here, never at import."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)
