"""device_idle: the share of the traced window in which nothing runs on
the card (no kernel, copy or memset), from ``torch.profiler``'s device
trace."""

from pimbench import timeline


def read(ctx):
    tl = ctx["timeline"]
    if tl is None:
        return None
    return 1.0 - timeline.busy_s(tl) / timeline.window_s(tl)
