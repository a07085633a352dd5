"""The table of peaks and the least time a cell's arithmetic can take.

The PIM machine's work is NOR gates on words of 32 rows: the program's
gate count (``cost().nor_gates``, frozen in the cell's file when the cell
was defined, so a change to the program cannot move the yardstick) times
the 32-row words of a call.  A GPU thread does one gate on one word in one
32-bit logical operation, so the operation peak is the card's 32-bit
integer rate; the bytes are each operand and result value read or written
once.  The bound is the larger of the two times, whatever schedule or
layout implements the gates.
"""

from __future__ import annotations

from typing import Optional, Tuple

#: Card name (``torch.cuda.get_device_name()``) -> peaks: 32-bit integer
#: (logical) operations a second, 132 SMs x 64 a clock x 1.98 GHz; HBM bytes
#: a second, NVIDIA's data sheet for the SXM part at its 700 W limit.
PEAKS = {
    "NVIDIA H100 80GB HBM3": {"word_ops_per_s": 132 * 64 * 1.98e9,
                              "bytes_per_s": 3.35e12},
}


def peaks(device_kind: str) -> Optional[dict]:
    return PEAKS.get(device_kind)


def call_work(frozen: dict, rows: int) -> Tuple[int, int]:
    """(word operations, bytes) of one call of ``rows`` rows."""
    words = -(-int(rows) // int(frozen["rows_per_word"]))
    return (int(frozen["nor_gates"]) * words,
            int(frozen["bytes_per_row"]) * int(rows))


def bound_s(frozen: dict, rows: int, device_kind: str
            ) -> Optional[Tuple[float, str]]:
    """(seconds, "operations" or "bytes"): the least time one call's
    arithmetic takes on ``device_kind``; None for a card with no peaks."""
    p = peaks(device_kind)
    if p is None:
        return None
    ops, nbytes = call_work(frozen, rows)
    t_ops, t_bytes = ops / p["word_ops_per_s"], nbytes / p["bytes_per_s"]
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")
