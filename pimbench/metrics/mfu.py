"""mfu: the whole decode step's share of the card's dense bfloat16 peak, in
%.

The frozen FLOPs of the untraced steps of a traced run
(``pimbench.lm_work.span_work`` over their positions, from the cell's file,
frozen when the cell was defined) over their time on the host's clock, at
the card's peak (``lm_work.PEAKS``).  Those steps are the decode steps at
positions [512, 528) of the window's first call, the card synchronised at
both ends (``pimbench.lm.StepSpan``; the traffic's ``trace_positions``),
timed without the profiler, whose own cost on each launch would slow them
two- to five-fold.  Silent where the card has no peak in the table or no
step was timed."""

from pimbench import lm_work


def read(ctx):
    steps, seconds = ctx.get("timed_steps"), ctx.get("timed_s")
    peak = lm_work.peaks(ctx["device_kind"])
    if not steps or not seconds or peak is None:
        return None
    flops, _ = lm_work.span_work(ctx["frozen"], steps)
    return 100.0 * flops / (seconds * peak["flops_per_s"])
