"""copy_share: the share of the traced window in which a host-to-device or
device-to-host copy runs on the card (``repro_torch/kernels/transfer.py``),
from ``torch.profiler``'s device trace."""

from pimbench import timeline


def read(ctx):
    tl = ctx["timeline"]
    if tl is None or not tl["copies"]:
        return None
    return timeline.total((s, e) for s, e, _ in tl["copies"]) / \
        timeline.window_s(tl)
