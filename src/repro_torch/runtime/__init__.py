"""Telemetry and the fault-model types the execution plan refers to."""
