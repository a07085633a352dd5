"""step_roofline: the whole decode step's share of its roofline, in %.

The least time the untraced steps of a traced run could take on the card,
the larger of their frozen FLOPs at the dense bfloat16 peak and their
frozen bytes at the HBM peak (``pimbench.lm_work``), over their time on the
host's clock.  The steps are those of ``mfu``: positions [512, 528) of the
window's first call, timed without the profiler.  Silent where the card
has no peaks in the table or no step was timed."""

from pimbench import lm_work


def read(ctx):
    steps, seconds = ctx.get("timed_steps"), ctx.get("timed_s")
    peak = lm_work.peaks(ctx["device_kind"])
    if not steps or not seconds or peak is None:
        return None
    flops, nbytes = lm_work.span_work(ctx["frozen"], steps)
    bound = max(flops / peak["flops_per_s"], nbytes / peak["bytes_per_s"])
    return 100.0 * bound / seconds
