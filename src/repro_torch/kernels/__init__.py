"""Slot-schedule executors: plan, CUDA kernel wrappers, plain versions
and the dispatch pipeline."""
