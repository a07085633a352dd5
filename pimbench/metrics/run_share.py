"""run_share: the share of the traced window ``Prepared.run()`` takes.

That is the streaming loop and its host bridges: per-chunk staging or the
io branch's bit packing, finalize, unpack and the join of the chunks
(``repro_torch/kernels/ops.py``), with the copies and kernels it waits
for.  Read from the harness's span around it in every call (host clock)."""


def read(ctx):
    if ctx["window_s"] <= 0:
        return None
    return ctx["spans"]["run"] / ctx["window_s"]
