"""join_share: the share of the traced window the streaming loop spends
joining the chunks' results into one array per port
(``run_program_streaming`` in ``repro_torch/kernels/ops.py``), from the
port's ``run.join`` spans."""

from pimbench import program_spans


def read(ctx):
    return program_spans.span_share(ctx, "run.join")
