"""``chip_smoke.py``'s host-side helpers, on the CPU (the script itself
needs a GPU)."""

import importlib.util
import json
import subprocess
import sys
import time
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent


@pytest.fixture(scope="module")
def smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


_CHILD = ("import json\n"
          "for i in range(200):\n"
          "    print(json.dumps({'i': i, 'pad': 'x' * 50}), flush=True)\n")


def test_a_replicas_stdout_keeps_every_line(smoke):
    """A replica that has written many lines before the reader wakes: the
    first line and the rest together are every line, each whole (a
    buffered ``readline`` before ``communicate`` lost lines and cut one
    in two, and the warm-start phase failed on it)."""
    proc = subprocess.Popen([sys.executable, "-c", _CHILD],
                            stdout=subprocess.PIPE, bufsize=0)
    time.sleep(0.5)                      # the reader wakes late
    first, t_first, rest = smoke.first_line_then_rest(proc, 60)
    lines = (first + rest).splitlines()
    assert [json.loads(l)["i"] for l in lines] == list(range(200))
    assert t_first <= time.perf_counter()


def test_a_buffered_pipe_is_refused(smoke):
    proc = subprocess.Popen([sys.executable, "-c", _CHILD],
                            stdout=subprocess.PIPE, text=True)
    try:
        with pytest.raises(ValueError, match="bufsize=0"):
            smoke.first_line_then_rest(proc, 60)
    finally:
        proc.communicate(timeout=60)
