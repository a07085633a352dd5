"""The port's PIM examples print the reference's lines.

Each script of ``examples_torch/`` runs with ``--device cpu`` (the plain
versions of the kernels) beside the same-named script of ``examples/``
(``JAX_PLATFORMS=cpu``), both in subprocesses at once; ``pim_streaming``
takes ``--small`` in both.  Both exit 0 and print the same lines, but for
the wall-time figures (ms, rows/s, products/s, the ``exec_us``
percentiles, the speedup factor), which are masked.  Everything else --
bit-exactness flags, cycle counts, modeled cycles and energy, program and
request counts, error ratios -- must be identical.
"""

import os
import re
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent

EXAMPLES = [("quickstart.py", []), ("pim_linear_inference.py", []),
            ("pim_gemv.py", []), ("pim_serving.py", []),
            ("pim_streaming.py", ["--small"])]

#: The wall-time figures of the examples' lines, the only numbers in which
#: the port may differ from the reference.
WALL = [re.compile(p) for p in (
    r" *[\d,]+\.?\d* ms\b",
    r" *[\d,]+\.?\d* (M )?rows/s",
    r" *[\d,]+ products/s",
    r"p50=\d+ p99=\d+",
    r"\(\d+\.\dx\)$",
)]


def mask(text: str) -> list:
    lines = []
    for line in text.splitlines():
        for p in WALL:
            line = p.sub("<wall>", line)
        lines.append(line)
    return lines


def test_mask_keeps_what_is_modeled():
    """Only wall-time figures are masked: the modeled latency in us, the
    GPU roofline factor and the counts stay."""
    line = ("int32 add                 :    706 cycles =    7.06 us, "
            "   9505.5 GOPS over 64 Mi rows ( 254.6x the GPU roofline)")
    assert mask(line) == [line]
    assert mask("batched:     4.1 ms =  5,957,843 rows/s (7.8x)") == \
        ["batched:<wall> =<wall> <wall>"]
    assert mask("exec_us  p50=2896 p99=3212427 (n=2)") == \
        ["exec_us  <wall> (n=2)"]


def _start(script: Path, args: list) -> subprocess.Popen:
    env = {**os.environ, "JAX_PLATFORMS": "cpu",
           "PYTHONPATH": str(ROOT / "src")}
    return subprocess.Popen([sys.executable, str(script)] + args, cwd=ROOT,
                            env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)


@pytest.mark.parametrize("script,args", EXAMPLES,
                         ids=[s for s, _ in EXAMPLES])
def test_example_prints_the_reference_lines(script, args):
    ref = _start(ROOT / "examples" / script, args)
    port = _start(ROOT / "examples_torch" / script, ["--device", "cpu"] + args)
    ref_out, ref_err = ref.communicate(timeout=600)
    out, err = port.communicate(timeout=600)
    assert ref.returncode == 0, ref_err
    assert port.returncode == 0, err
    assert ref_out.strip()
    assert mask(out) == mask(ref_out)
