"""The benchmark of ``repro_torch``: one cell a run, found by name.

``python3 pimbench/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` from the root of a checkout; see ``README.md``.
"""
