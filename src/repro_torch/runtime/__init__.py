"""Telemetry, the fault-model types the execution plan refers to, the
serving loop's liveness primitives, the PIM batched serving runtime
(queue -> planner -> coalescer -> splitter; DESIGN.md §10), the
persistent artifact cache and the autotuner (DESIGN.md §16).
``pim_batch``, ``artifact_cache`` and ``tune`` are imported lazily, so
that the plan's imports of this package do not pull in the kernels."""

_PIM_BATCH = ("BatchQueue", "BatchRuntime", "Group", "PinnedSchedules",
              "RequestResult", "Stats", "classify_error", "coalesce",
              "group_key", "plan_groups")

_MODULES = ("pim_batch", "artifact_cache", "tune")

__all__ = list(_PIM_BATCH) + list(_MODULES)


def __getattr__(name):
    if name in _MODULES or name in _PIM_BATCH:
        import importlib
        mod = importlib.import_module(
            f".{name if name in _MODULES else 'pim_batch'}", __name__)
        return mod if name in _MODULES else getattr(mod, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
