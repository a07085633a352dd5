"""Host <-> device transfers of the levelized executors.

On a CUDA device every dispatch moves its operands through pinned host
memory on streams of their own, so that the host fills chunk k+1 and its
host-to-device copy runs while chunk k's kernel runs:

* three streams a device (:func:`streams`): ``h2d`` copies operands in,
  ``compute`` runs the kernels (their wrappers launch on the current
  stream, so a launch runs under ``torch.cuda.stream(compute)``), ``d2h``
  copies results out.  The copies have streams of their own because one
  copy stream would queue chunk k+1's operands behind chunk k's results,
  which wait for chunk k's kernel;
* two pinned staging buffers each way per (device, shard)
  (:class:`Lane`), sized to the largest chunk seen and used in turn.  The
  host writes an input buffer only after the copy that last read it has
  completed (its event); an output buffer is reused only after the
  ``finalize`` that read it has run, and a dispatch that finds both busy
  takes a buffer of its own.  A download may carry small tensors beside
  its result (a verified dispatch's check fold), copied into the same
  buffer behind it;
* a tensor made on one stream and read on another is recorded on the
  reader (``Tensor.record_stream``), so the caching allocator does not
  hand its memory out before the reader is done.

``finalize`` waits on its own copy's event, never on the device.  On the
CPU the same calls take plain tensors and no streams.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Callable, Dict, Iterable, List, Optional

import numpy as np
import torch


@dataclasses.dataclass
class Streams:
    """The copy and compute streams of one CUDA device."""
    h2d: "torch.cuda.Stream"
    compute: "torch.cuda.Stream"
    d2h: "torch.cuda.Stream"


_streams: Dict[str, Streams] = {}


def checked_device(device) -> str:
    """``device`` as a string; raises when it names a CUDA device and
    there is none (the port never drops to the CPU)."""
    if torch.device(device).type == "cuda" and \
            not torch.cuda.is_available():
        raise RuntimeError(
            f"no CUDA device for device={device!r}; pass "
            "device='cpu', backend='ref' to run the plain version on "
            "the CPU")
    return str(torch.device(device))


def device_name(device) -> str:
    """``device`` as a name with its index ("cuda" is the current CUDA
    device), so that one device has one set of streams and lanes; raises
    as :func:`checked_device` does."""
    dev = torch.device(checked_device(device))
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return str(dev)


def streams(device) -> Streams:
    """The streams of a CUDA ``device``, made at first use."""
    key = device_name(device)
    s = _streams.get(key)
    if s is None:
        dev = torch.device(key)
        s = _streams[key] = Streams(*(torch.cuda.Stream(dev)
                                      for _ in range(3)))
    return s


def _is_cuda(device) -> bool:
    return torch.device(device).type == "cuda"


@contextlib.contextmanager
def computing(devices: Iterable):
    """Make each CUDA device's compute stream its current stream: the
    kernels launched, and the tensors made, inside run there."""
    with contextlib.ExitStack() as stack:
        for d in dict.fromkeys(device_name(d) for d in devices):
            if _is_cuda(d):
                stack.enter_context(torch.cuda.stream(streams(d).compute))
        yield


@dataclasses.dataclass
class _Slot:
    buf: Optional[torch.Tensor] = None        # pinned int32, flat
    event: Optional["torch.cuda.Event"] = None
    busy: bool = False


@dataclasses.dataclass
class Staged:
    """A host buffer to fill: ``array`` (uint32) and ``tensor`` (int32)
    are two views of the same memory."""
    array: np.ndarray
    tensor: torch.Tensor
    slot: Optional[_Slot] = None


class Download:
    """A result on its way to the host, with the tensors downloaded beside
    it.  :meth:`result` waits for them and hands their host copies, in
    order, to a function that must copy what it keeps: the memory is a
    staging buffer that a later dispatch reuses."""

    def __init__(self, hosts: List[torch.Tensor], event=None, slot=None):
        self._hosts, self._event, self._slot = hosts, event, slot

    def result(self, consume: Callable[..., object]):
        if self._event is not None:
            self._event.synchronize()
        try:
            return consume(*(h.numpy().view(np.uint32)
                             for h in self._hosts))
        finally:
            if self._slot is not None:
                self._slot.busy = False
            self._hosts = self._slot = None


def _pinned(n: int) -> torch.Tensor:
    return torch.empty(max(n, 1), dtype=torch.int32, pin_memory=True)


class Lane:
    """The staging buffers of one shard on one device (see the module
    docstring).  On the CPU it stages into fresh arrays and copies
    nothing."""

    def __init__(self, device):
        self.device = torch.device(device)
        self.cuda = self.device.type == "cuda"
        self._ins: List[_Slot] = [_Slot(), _Slot()]
        self._outs: List[_Slot] = [_Slot(), _Slot()]
        self._turn_in = self._turn_out = 0

    def stage(self, shape: tuple) -> Staged:
        """A host buffer of ``shape`` 32-bit words to fill before
        :meth:`upload`."""
        n = int(np.prod(shape, dtype=np.int64))
        if not self.cuda:
            a = np.empty(shape, np.uint32)
            return Staged(a, torch.from_numpy(a.view(np.int32)))
        slot = self._ins[self._turn_in]
        self._turn_in ^= 1
        if slot.event is not None:
            slot.event.synchronize()     # the copy that last read it is done
            slot.event = None
        if slot.buf is None or slot.buf.numel() < n:
            slot.buf = _pinned(n)
        t = slot.buf[:n].view(shape)
        return Staged(t.numpy().view(np.uint32), t, slot)

    def upload(self, staged: Staged) -> torch.Tensor:
        """``staged`` on the device, copied on the ``h2d`` stream; the
        compute stream waits for the copy."""
        if not self.cuda:
            return staged.tensor
        s = streams(self.device)
        with torch.cuda.stream(s.h2d):
            x = torch.empty(staged.tensor.shape, dtype=torch.int32,
                            device=self.device)
            x.copy_(staged.tensor, non_blocking=True)
        event = torch.cuda.Event()
        event.record(s.h2d)
        staged.slot.event = event
        s.compute.wait_event(event)
        x.record_stream(s.compute)
        return x

    def download(self, t: torch.Tensor, *beside: torch.Tensor) -> Download:
        """Copy ``t`` and the tensors ``beside`` it (int32, made on this
        device's compute stream) to one pinned buffer on the ``d2h``
        stream."""
        ts = (t,) + beside
        if not self.cuda:
            return Download(list(ts))
        s = streams(self.device)
        n = sum(x.numel() for x in ts)
        for i in (self._turn_out, self._turn_out ^ 1):
            if not self._outs[i].busy:
                slot, self._turn_out = self._outs[i], i ^ 1
                break
        else:
            slot = _Slot()          # both held by unfinished dispatches
        if slot.buf is None or slot.buf.numel() < n:
            slot.buf = _pinned(n)
        slot.busy = True
        s.d2h.wait_stream(s.compute)
        hosts, at = [], 0
        with torch.cuda.stream(s.d2h):
            for x in ts:
                host = slot.buf[at:at + x.numel()].view(x.shape)
                host.copy_(x, non_blocking=True)
                x.record_stream(s.d2h)
                hosts.append(host)
                at += x.numel()
        event = torch.cuda.Event()
        event.record(s.d2h)
        return Download(hosts, event, slot)


_lanes: Dict[tuple, Lane] = {}


def lane(device, shard: int = 0) -> Lane:
    """The :class:`Lane` of shard ``shard`` on ``device``."""
    key = (device_name(device), int(shard))
    ln = _lanes.get(key)
    if ln is None:
        ln = _lanes[key] = Lane(key[0])
    return ln
