"""stage_share: the share of the traced window the streaming loop spends
filling the pinned staging buffers with the chunks' values (the cast in
place and the zero pad of the fused branch, ``repro_torch/kernels/ops.py``),
from the port's ``run.stage`` spans."""

from pimbench import program_spans


def read(ctx):
    return program_spans.span_share(ctx, "run.stage")
