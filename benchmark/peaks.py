"""Published peaks of one NVIDIA H100 SXM and the roofline bound of a piece
of work. They live in `reference/work.py`, where a reference backbone's
`pass_work` reaches them; the readers name them here."""

from .reference.work import PEAK_BF16_FLOPS, PEAK_BYTES_PER_S, bound_ms  # noqa: F401
