"""Telemetry, the fault-model types the execution plan refers to, the
serving loop's liveness primitives, and the PIM batched serving runtime
(queue -> planner -> coalescer -> splitter; DESIGN.md §10).
``pim_batch`` is imported lazily, so that the plan's imports of this
package do not pull in the kernels."""

_PIM_BATCH = ("BatchQueue", "BatchRuntime", "Group", "PinnedSchedules",
              "RequestResult", "Stats", "classify_error", "coalesce",
              "group_key", "plan_groups")

__all__ = list(_PIM_BATCH) + ["pim_batch"]


def __getattr__(name):
    if name == "pim_batch" or name in _PIM_BATCH:
        import importlib
        mod = importlib.import_module(".pim_batch", __name__)
        return mod if name == "pim_batch" else getattr(mod, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
