"""widen_share: the share of the traced window the frontend spends
widening the operands to uint64 rows (the bit view and ``astype`` in
``repro_torch/pim_ufunc.py``), from the port's ``frontend.widen`` spans."""

from pimbench import program_spans


def read(ctx):
    return program_spans.span_share(ctx, "frontend.widen")
