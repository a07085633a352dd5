"""kernel_roofline: the executor kernels' share of their roofline, in %.

The least time the window's calls could take on the card
(``pimbench.roofline.bound_s``: the cell's frozen gate count and bytes at
the card's peaks) over the device time of the kernels that execute the
gates, whose names the cell's file lists (``executor_kernels``), from
``torch.profiler``'s device trace.  Silent where the card has no peaks in
the table or no such kernel ran."""

from pimbench import roofline


def read(ctx):
    tl = ctx["timeline"]
    bound = roofline.bound_s(ctx["frozen"], ctx["rows"], ctx["device_kind"])
    if tl is None or bound is None:
        return None
    names = ctx["frozen"]["executor_kernels"]
    busy = sum(e - s for s, e, n in tl["kernels"]
               if any(k in n for k in names))
    if busy <= 0:
        return None
    return 100.0 * bound[0] * ctx["calls"] / busy
