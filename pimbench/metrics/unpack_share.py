"""unpack_share: the share of the traced window spent bringing results
back to the caller: each chunk's result into host rows (the fused
branch's uint64 widening, the io branch's bit unpacking,
``repro_torch/kernels/ops.py``) and the decoding to the caller's dtype
and shape (``Prepared.run``), from the port's ``run.unpack`` and
``run.finish`` spans."""

from pimbench import program_spans


def read(ctx):
    return program_spans.span_share(ctx, "run.unpack", "run.finish")
