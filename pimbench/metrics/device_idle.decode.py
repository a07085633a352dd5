"""device_idle.decode: ``device_idle`` of a decode cell, a metric of its own
because it moves ``tokens_per_s``: the share of the traced span in which
nothing runs on the card, from ``torch.profiler``'s device trace.  The
span is the decode steps at positions [528, 544) of the window's first
call (``pimbench.lm.StepSpan``), under the profiler, whose own cost on
each launch slows the host and so reads more idle time than an untraced
step has."""

from pimbench import cells

read = cells.metric_reader("device_idle")
