"""wait_share: the share of the traced window the host spends blocked on
the card, waiting for a copy in before it refills a staging buffer or for
a result's copy out (``repro_torch/kernels/transfer.py``), from the port's
``run.wait`` spans."""

from pimbench import program_spans


def read(ctx):
    return program_spans.span_share(ctx, "run.wait")
