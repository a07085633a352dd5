"""frontend_share: the share of the traced window the frontend takes.

The frontend is ``pim.prepare(op, x, y)``: broadcasting, validation,
widening, program lookup (``repro_torch/pim_ufunc.py``).  Read from the
harness's span around it in every call, over the window (host clock)."""


def read(ctx):
    if ctx["window_s"] <= 0:
        return None
    return ctx["spans"]["frontend"] / ctx["window_s"]
