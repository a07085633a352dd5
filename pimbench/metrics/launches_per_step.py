"""launches_per_step: the device operations (kernels, copies and memsets)
of the traced span over its decode steps, from ``torch.profiler``'s device
trace.  The span is the decode steps at positions [528, 544) of the
window's first call (``pimbench.lm.StepSpan``; the traffic's
``trace_positions``).  Silent where no step was traced."""


def read(ctx):
    tl, steps = ctx.get("timeline"), ctx.get("steps")
    if tl is None or not steps:
        return None
    return len(tl["device"]) / len(steps)
