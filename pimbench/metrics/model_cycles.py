"""model_cycles: the PIM cycles the analytical cost model gives one
dispatch of the cell's program (``telemetry.COST_MODEL.schedule_cost`` of
the resolved schedule), from the port's ``pim.model.cycles`` and
``pim.exec.dispatches`` counters.  A simulated statistic: a change that
only speeds up the emulation leaves it as it is."""

from pimbench import program_spans


def read(ctx):
    return program_spans.ratio(("pim.model.cycles",), "pim.exec.dispatches")
