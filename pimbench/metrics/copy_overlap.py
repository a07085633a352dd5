"""copy_overlap: the share of host-to-device copy time on the card that
runs while a kernel runs, from ``torch.profiler``'s device trace: how far
the transfer pipeline (``repro_torch/kernels/transfer.py``) hides its
copies in into the kernels."""

from pimbench import timeline


def read(ctx):
    tl = ctx["timeline"]
    if tl is None or not tl["h2d"]:
        return None
    h2d = [(s, e) for s, e, _ in tl["h2d"]]
    return timeline.overlap(h2d, [(s, e) for s, e, _ in tl["kernels"]]) / \
        sum(e - s for s, e in h2d)
