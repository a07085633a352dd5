"""The port's device contract on a host with no CUDA device.

Every entry point of the port defaults to the card.  With none, each must
raise the port's own ``RuntimeError`` ("no CUDA device for
device='cuda'; pass device='cpu', backend='ref' ...", from
``kernels.transfer.checked_device``) -- not torch's ``AssertionError`` of a
CPU-only build, its NCCL error, or its process-group ``ValueError`` --
and must leave no process group up.  ``torch.cuda.is_available`` is
patched to ``False``, so the tests mean the same on a host with a card.
Then ``elastic.mesh_for`` with no group up (one rank: a one-rank group,
as the reference builds its mesh over ``jax.devices()``; more: the
port's own error) and ``make_production_mesh`` with none.
"""

import os
import runpy
import sys
from pathlib import Path
from unittest import mock

import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro_torch import pim_ufunc as pim
from repro_torch.core import pim_numerics as PN
from repro_torch.launch import mesh as MS
from repro_torch.launch import sharding as SH
from repro_torch.runtime import elastic

ROOT = Path(__file__).resolve().parent.parent
NO_CARD = "no CUDA device"

_INTS = np.arange(64, dtype=np.uint8)
_FLOATS = np.linspace(-2.0, 2.0, 64).astype(np.float16)


def _launch_mesh():
    with SH.launch_mesh():
        pass


def _launch_mesh_under_torchrun():
    """``launch_mesh`` as a rank of a two-rank torchrun job: it must
    raise before ``init_process_group`` waits for the other rank."""
    with mock.patch.dict(os.environ, {"WORLD_SIZE": "2", "RANK": "0",
                                      "LOCAL_RANK": "0"}):
        _launch_mesh()


#: Each entry point called as a user would, with no ``device=``.
ENTRY_POINTS = {
    "reduce_sum-int-fused": lambda: pim.reduce_sum(_INTS),
    "reduce_sum-int-unfused": lambda: pim.reduce_sum(_INTS, fused=False),
    "reduce_sum-fp-fused": lambda: pim.reduce_sum(_FLOATS),
    "reduce_sum-fp-unfused": lambda: pim.reduce_sum(_FLOATS, fused=False),
    "dot": lambda: pim.dot(_INTS, _INTS),
    "gemv": lambda: pim.gemv(_INTS.reshape(8, 8), _INTS[:8]),
    "pim_linear_i8": lambda: PN.pim_linear_i8(
        PN.PIMVectorUnit(), np.ones((2, 8), np.int8),
        np.ones((8, 3), np.int8)),
    "PIMVectorUnit.add": lambda: PN.PIMVectorUnit().add(_INTS, _INTS),
    "make_mesh": lambda: MS.make_mesh((1, 1), ("data", "model")),
    "make_smoke_mesh": MS.make_smoke_mesh,
    "launch_mesh": _launch_mesh,
    "launch_mesh-torchrun": _launch_mesh_under_torchrun,
    "mesh_for": lambda: elastic.mesh_for(1, [1]),
}

EXAMPLES = ("quickstart.py", "pim_linear_inference.py", "pim_gemv.py",
            "pim_serving.py", "pim_streaming.py", "train_lm.py")


@pytest.fixture
def no_card(monkeypatch):
    """No CUDA device, no process group before; none left after."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert not dist.is_initialized()
    yield
    assert not dist.is_initialized()


@pytest.mark.parametrize("entry", list(ENTRY_POINTS))
def test_entry_point_raises_the_ports_error(entry, no_card):
    with pytest.raises(RuntimeError, match=NO_CARD):
        ENTRY_POINTS[entry]()


@pytest.mark.parametrize("script", EXAMPLES)
def test_example_raises_the_ports_error(script, no_card, monkeypatch):
    path = ROOT / "examples_torch" / script
    monkeypatch.setattr(sys, "argv", [str(path)])
    with pytest.raises(RuntimeError, match=NO_CARD):
        runpy.run_path(str(path), run_name="__main__")


def test_mesh_for_with_no_group_takes_the_references_shape():
    """One rank with no group up: a one-rank group on the CPU, the mesh
    of the reference's shape and axis names; the group is the test's to
    destroy."""
    from repro.runtime import elastic as ref_elastic
    assert not dist.is_initialized()
    try:
        mesh = elastic.mesh_for(1, [8], device="cpu")
        assert dist.get_world_size() == 1
        assert tuple(mesh.mesh_dim_names) == ("data", "model")
        assert mesh.device_type == "cpu"
        want = ref_elastic.mesh_for(1, [8])
        assert tuple(mesh.shape) == want.devices.shape
        assert tuple(mesh.mesh_dim_names) == tuple(want.axis_names)
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


@pytest.mark.parametrize("make,ranks", [
    (lambda: elastic.mesh_for(4, [1], device="cpu"), 4),
    (lambda: MS.make_production_mesh(), 256),
    (lambda: MS.make_production_mesh(multi_pod=True), 512)],
    ids=["mesh_for-4", "production", "production-multi_pod"])
def test_a_wider_mesh_with_no_group_raises_the_ports_error(make, ranks):
    assert not dist.is_initialized()
    with pytest.raises(RuntimeError, match=f"a {ranks}-device mesh needs "
                       f"a process group of {ranks} ranks; none is up"):
        make()
    assert not dist.is_initialized()
