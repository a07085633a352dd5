"""validate_share: the share of the traced window the frontend spends
checking the operands (``_check_fp_bits``, the integer width and range
checks in ``repro_torch/pim_ufunc.py``), from the port's
``frontend.validate`` spans."""

from pimbench import program_spans


def read(ctx):
    return program_spans.span_share(ctx, "frontend.validate")
