"""pack_share: the share of the traced window the io branch spends packing
port bits into the staging buffers on the host (``_pack_port_words``,
``pack_rows`` in ``repro_torch/kernels/ops.py``), from the port's
``run.pack`` spans."""

from pimbench import program_spans


def read(ctx):
    return program_spans.span_share(ctx, "run.pack")
