"""staged_bytes_per_row: the bytes the transfer pipeline hands to the
copies, in and out, a result row (``repro_torch/kernels/transfer.py``),
from the port's ``pim.transfer.h2d_bytes``, ``pim.transfer.d2h_bytes``
and ``pim.exec.rows`` counters."""

from pimbench import program_spans


def read(ctx):
    return program_spans.ratio(
        ("pim.transfer.h2d_bytes", "pim.transfer.d2h_bytes"),
        "pim.exec.rows")
