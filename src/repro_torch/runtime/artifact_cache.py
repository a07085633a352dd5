"""Persistent compiled-artifact cache: the on-disk tier below the
compiled-program LRU, on PyTorch and the CUDA port.

The counterpart of ``repro.runtime.artifact_cache``.  Every process
cold-starts with an empty in-memory LRU, so a serving fleet of N replicas
pays N x levelize + pack + nvcc for the same hot programs.  This module
persists the three expensive artifacts to disk:

* **Levelized schedules** -- the ``levelize()`` output serialized as an
  explicit header + arrays format, keyed on the cache identity
  ``(content_key(program), plan.compile_key, alloc)``.  Path and bytes are
  the reference's for the same program, so one directory could serve both
  packages' schedule tiers.
* **Packed streams** -- the records B1, B3 and B4 read
  (``pim_exec.pack_slots``/``pack_levels``/``pack_gates``), keyed on the
  same identity plus the stream's record format
  (``pim_exec.packed_format``: the tile and window sizes and the hash of
  ``csrc/ring.cuh``), so a change to the layout the kernels read is a miss.
* **Binaries** -- the shared libraries ``nvcc`` builds: the fixed kernels'
  and every generated static-slice kernel's (B2), keyed on the library's
  content-addressed name (source, headers and flags:
  ``pim_exec._build_key``) plus the toolchain it was built by
  (``pim_exec.toolchain``: the ``nvcc`` release, torch's CUDA version and
  the card's compute capability).  A B2 entry also records what
  ``ops._Compiled.get_static`` keys on, so :meth:`ArtifactCache.warm` can
  regenerate its source and check it before trusting the library.  This
  tier takes the place of the reference's XLA executables (AOT), which
  have no counterpart on a GPU.

Robustness contract (the reference's; ``tests/test_torch_artifact_cache.py``
pins it):

* **Atomic writes** -- artifacts are written to a same-directory temp file
  (fsync'd) and ``os.replace``'d into place, so concurrent writers on one
  cache directory can interleave freely and a reader never observes a torn
  file.
* **Integrity checksums** -- every file ends in a blake2b digest over its
  header + payload; corruption (or a bad magic, a truncated file) makes
  the load a miss that counts ``disk_errors``, and the bad file is
  unlinked.  A library is checked before it reaches ``dlopen``.
* **Versioned format** -- the magic carries the format version; a
  mismatch of format, device target or toolchain is a plain miss, never
  an error.
* **Size cap with LRU eviction** -- after each write the cache evicts
  oldest-``mtime`` files until under ``max_bytes`` (loads refresh mtime).

Counters land on the shared ``pim.cache.*`` telemetry group:
``disk_hits`` / ``disk_misses`` / ``disk_writes`` / ``disk_errors`` /
``disk_evictions``.
"""

from __future__ import annotations

import dataclasses
import hashlib
import io
import json
import os
import tempfile
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ..core.gates import LevelSchedule
from . import telemetry

#: Format version: bump on any change to the header schema or payload
#: layout.  Baked into the magic so a version mismatch is detected before
#: any parsing happens.
FORMAT_VERSION = 1
_MAGIC = b"PIMART%02d" % FORMAT_VERSION        # 8 bytes
_DIGEST = 16                                   # blake2b digest size (bytes)
_SUFFIX = ".pim"

#: Default on-disk size cap (bytes).  Schedules and packed streams are
#: tens to hundreds of KB, a kernel library about a MB.
DEFAULT_MAX_BYTES = 256 << 20

#: Shared counter group with the in-memory compiled-program LRU
#: (``kernels.ops._CACHE``): one ``pim.cache`` namespace for all tiers.
_CACHE = telemetry.REGISTRY.group("pim.cache")

#: Basename of the autotuner's persisted winners, stored beside the
#: artifacts (``runtime.tune`` reads and writes it; serving installs it).
TUNED_BASENAME = "tuned.json"


def _compile_key_of(plan) -> Tuple[int, ...]:
    """The plan's compile identity as a plain int tuple (accepts an
    ExecPlan or an already-extracted tuple)."""
    ck = getattr(plan, "compile_key", plan)
    return tuple(int(v) for v in ck)


def device_target() -> str:
    """The target tuned defaults are valid for: on a CUDA machine the
    first card's name and compute capability, else the CPU, each with
    torch's version and the CUDA version it was built for."""
    tail = f"torch-{torch.__version__}:cuda-{torch.version.cuda}"
    if torch.cuda.is_available():
        major, minor = torch.cuda.get_device_capability(0)
        return (f"cuda:{torch.cuda.get_device_name(0)}:sm_{major}{minor}:"
                f"{tail}")
    return f"cpu:{tail}"


# --------------------------------------------------------------------------
# container format: MAGIC | u32 header_len | header JSON | payload | digest
# --------------------------------------------------------------------------

def _frame(header: dict, payload: bytes) -> bytes:
    hb = json.dumps(header, sort_keys=True).encode()
    buf = io.BytesIO()
    buf.write(_MAGIC)
    buf.write(len(hb).to_bytes(4, "little"))
    buf.write(hb)
    buf.write(payload)
    buf.write(hashlib.blake2b(hb + payload, digest_size=_DIGEST).digest())
    return buf.getvalue()


def _unframe(blob: bytes) -> Optional[Tuple[dict, bytes]]:
    """Parse one artifact file; None on any mismatch (magic, length,
    checksum, JSON) -- the caller treats that as corruption/version skew
    and recomputes."""
    if len(blob) < len(_MAGIC) + 4 + _DIGEST or \
            not blob.startswith(_MAGIC):
        return None
    hlen = int.from_bytes(blob[8:12], "little")
    body_end = len(blob) - _DIGEST
    if 12 + hlen > body_end:
        return None
    hb = blob[12:12 + hlen]
    payload = blob[12 + hlen:body_end]
    if hashlib.blake2b(hb + payload, digest_size=_DIGEST).digest() \
            != blob[body_end:]:
        return None
    try:
        header = json.loads(hb.decode())
    except (UnicodeDecodeError, json.JSONDecodeError):
        return None
    return header, payload


# --------------------------------------------------------------------------
# LevelSchedule <-> bytes
# --------------------------------------------------------------------------

_SCHED_ARRAYS = ("a", "b", "out", "level_width")


def _sched_to_parts(sched: LevelSchedule) -> Tuple[dict, bytes]:
    meta = {
        "n_cells": int(sched.n_cells),
        "sink": int(sched.sink),
        "one_cell": None if sched.one_cell is None else int(sched.one_cell),
        "ports": {k: [int(c) for c in v] for k, v in sched.ports.items()},
        "in_cells": {k: [int(c) for c in v]
                     for k, v in sched.in_cells.items()},
        "in_ports": sorted(sched.in_ports),
        "out_ports": sorted(sched.out_ports),
        "n_gates": int(sched.n_gates),
        "source_gates": int(sched.source_gates),
        "source_cells": int(sched.source_cells),
        "alloc": sched.alloc,
        "slot_width": None if sched.slot_width is None
        else int(sched.slot_width),
        "copy_gates": int(sched.copy_gates),
    }
    specs, chunks = [], []
    for name in _SCHED_ARRAYS:
        arr = np.ascontiguousarray(getattr(sched, name))
        specs.append([name, arr.dtype.str, list(arr.shape)])
        chunks.append(arr.tobytes())
    return {"meta": meta, "arrays": specs}, b"".join(chunks)


def _sched_from_parts(header: dict, payload: bytes
                      ) -> Optional[LevelSchedule]:
    try:
        meta = header["meta"]
        arrays = {}
        off = 0
        for name, dtype, shape in header["arrays"]:
            n = int(np.prod(shape, dtype=np.int64)) * np.dtype(dtype).itemsize
            arrays[name] = np.frombuffer(
                payload[off:off + n], dtype=dtype).reshape(shape).copy()
            off += n
        if off != len(payload) or set(arrays) != set(_SCHED_ARRAYS):
            return None
        sched = LevelSchedule(
            n_cells=int(meta["n_cells"]), sink=int(meta["sink"]),
            one_cell=None if meta["one_cell"] is None
            else int(meta["one_cell"]),
            ports={k: [int(c) for c in v]
                   for k, v in meta["ports"].items()},
            in_cells={k: [int(c) for c in v]
                      for k, v in meta["in_cells"].items()},
            in_ports=frozenset(meta["in_ports"]),
            out_ports=frozenset(meta["out_ports"]),
            a=arrays["a"], b=arrays["b"], out=arrays["out"],
            level_width=arrays["level_width"],
            n_gates=int(meta["n_gates"]),
            source_gates=int(meta["source_gates"]),
            source_cells=int(meta["source_cells"]),
            alloc=meta["alloc"],
            slot_width=None if meta["slot_width"] is None
            else int(meta["slot_width"]),
            copy_gates=int(meta["copy_gates"]))
        if sched.a.shape != sched.b.shape or \
                sched.a.shape != sched.out.shape or \
                sched.level_width.shape != (sched.a.shape[0],):
            return None
        return sched
    except (KeyError, TypeError, ValueError):
        return None


# --------------------------------------------------------------------------
# Packed <-> bytes
# --------------------------------------------------------------------------

def _packed_from_parts(header: dict, payload: bytes):
    """The ``pim_exec.Packed`` a packed entry holds (tiles on the CPU);
    None when the header and payload disagree or the record format is
    not this build's."""
    from ..kernels import pim_exec
    try:
        if header["format"] != pim_exec.packed_format():
            return None
        n_tiles = int(header["n_tiles"])
        words = 2 * pim_exec.TILE_RECORDS
        if len(payload) != n_tiles * words * 4:
            return None
        tiles = np.frombuffer(payload, "<i4").astype(np.int32).reshape(
            n_tiles, words)
        return pim_exec.Packed(torch.from_numpy(tiles),
                               int(header["n_windows"]),
                               int(header["n_gates"]), int(header["width"]))
    except (KeyError, TypeError, ValueError):
        return None


# --------------------------------------------------------------------------
# provenance: how to rebuild a program from a cache entry alone (warm())
# --------------------------------------------------------------------------

def _prov_to_json(tag) -> Optional[list]:
    """Provenance tuples nest plain scalars/tuples; JSON round-trips them
    as nested lists (re-tupled on the way back)."""
    if tag is None:
        return None

    def enc(v):
        return [enc(x) for x in v] if isinstance(v, (tuple, list)) else v
    return enc(tag)


def _prov_from_json(v):
    if isinstance(v, list):
        return tuple(_prov_from_json(x) for x in v)
    return v


def _program_from_provenance(prov):
    """Rebuild (via the memoized builders) the Program a provenance tag
    names; None when the tag is unknown or the build fails."""
    try:
        from ..core import pim_numerics
        if prov and prov[0] == "program_for":
            return pim_numerics.program_for(prov[1], prov[2], prov[3])
        if prov and prov[0] == "fused_program_for":
            return pim_numerics.fused_program_for(prov[1], prov[2], prov[3])
    except Exception:           # noqa: BLE001 -- an unknown tag is a skip
        return None
    return None


# --------------------------------------------------------------------------
# the cache
# --------------------------------------------------------------------------

class ArtifactCache:
    """On-disk, versioned, atomic-write cache of compiled PIM artifacts.

    One instance manages one directory (created on demand).  Installed
    process-wide via ``kernels.ops.set_artifact_cache``; the compiled-
    program machinery then consults it on every in-memory miss and writes
    through on every fresh levelize, packing and ``nvcc`` build.  See the
    module docstring for the format and robustness contract.
    """

    def __init__(self, root, *, max_bytes: int = DEFAULT_MAX_BYTES):
        self.root = os.fspath(root)
        self.max_bytes = int(max_bytes)
        os.makedirs(self.root, exist_ok=True)

    # ------------------------------------------------------------- keys

    def _path(self, kind: str, *material) -> str:
        digest = hashlib.blake2b(
            repr((FORMAT_VERSION, kind) + material).encode(),
            digest_size=_DIGEST).hexdigest()
        return os.path.join(self.root, f"{kind}-{digest}{_SUFFIX}")

    def sched_path(self, content: bytes, plan, alloc: str) -> str:
        return self._path("sched", content.hex(), _compile_key_of(plan),
                          alloc)

    def packed_path(self, content: bytes, plan, alloc: str,
                    fmt: str) -> str:
        return self._path("packed", content.hex(), _compile_key_of(plan),
                          alloc, fmt)

    def bin_path(self, name: str, chain: tuple) -> str:
        return self._path("bin", name, tuple(chain))

    # ------------------------------------------------------------- io

    def _read(self, path: str) -> Optional[Tuple[dict, bytes]]:
        """Read + verify one artifact file.  Missing file -> plain miss
        (None, no counter); unreadable/corrupt -> ``disk_errors`` and the
        bad file is unlinked so it cannot poison future loads."""
        try:
            with open(path, "rb") as f:
                blob = f.read()
        except FileNotFoundError:
            return None
        except OSError:
            _CACHE.add("disk_errors")
            return None
        parsed = _unframe(blob)
        if parsed is None:
            _CACHE.add("disk_errors")
            try:
                os.unlink(path)
            except OSError:
                pass
            return None
        try:                        # refresh mtime: eviction is LRU-by-use
            os.utime(path)
        except OSError:
            pass
        return parsed

    def _write(self, path: str, header: dict, payload: bytes) -> None:
        """Atomic publish: temp file in the same directory, fsync, then
        ``os.replace`` -- a reader sees the old file, no file, or the
        complete new file, never a torn write."""
        blob = _frame(header, payload)
        fd, tmp = tempfile.mkstemp(dir=self.root, suffix=".tmp")
        try:
            with os.fdopen(fd, "wb") as f:
                f.write(blob)
                f.flush()
                os.fsync(f.fileno())
            os.replace(tmp, path)
        except OSError:
            _CACHE.add("disk_errors")
            try:
                os.unlink(tmp)
            except OSError:
                pass
            return
        _CACHE.add("disk_writes")
        self._evict()

    def _load(self, path: str, decode):
        """``decode(header, payload)`` of the entry at ``path``, counted:
        a missing file or a ``decode`` of None (skew) is a miss, a header
        or payload ``decode`` raises ``ValueError`` on is an error too."""
        parsed = self._read(path)
        if parsed is None:
            _CACHE.add("disk_misses")
            return None
        try:
            out = decode(*parsed)
        except ValueError:
            _CACHE.add("disk_errors")
            out = None
        _CACHE.add("disk_misses" if out is None else "disk_hits")
        return out

    # ------------------------------------------------------------- sched

    def load_schedule(self, content: bytes, plan, alloc: str
                      ) -> Optional[LevelSchedule]:
        """The disk tier's schedule lookup; None on miss or corruption
        (the caller then levelizes and stores)."""
        def decode(header, payload):
            sched = _sched_from_parts(header, payload)
            if sched is None:
                raise ValueError("schedule entry does not parse")
            return sched
        return self._load(self.sched_path(content, plan, alloc), decode)

    def store_schedule(self, content: bytes, plan, alloc: str,
                       sched: LevelSchedule, provenance=None) -> None:
        header, payload = _sched_to_parts(sched)
        header.update(kind="sched", content=content.hex(),
                      compile_key=list(_compile_key_of(plan)), alloc=alloc,
                      provenance=_prov_to_json(provenance))
        self._write(self.sched_path(content, plan, alloc), header, payload)

    # ------------------------------------------------------------- packed

    def load_packed(self, content: bytes, plan, alloc: str):
        """The packed stream of ``alloc`` ("slots", "dense", or "gates"
        for B4's, under the compile key ``()``) as a ``pim_exec.Packed``
        on the CPU; None on a miss, corruption or another record
        format."""
        from ..kernels import pim_exec

        def decode(header, payload):
            p = _packed_from_parts(header, payload)
            if p is None and header.get("format") == \
                    pim_exec.packed_format():
                raise ValueError("packed entry does not parse")
            return p
        return self._load(self.packed_path(
            content, plan, alloc, pim_exec.packed_format()), decode)

    def store_packed(self, content: bytes, plan, alloc: str, packed,
                     provenance=None) -> None:
        from ..kernels import pim_exec
        fmt = pim_exec.packed_format()
        tiles = packed.tiles.cpu().numpy().astype("<i4")
        header = {"kind": "packed", "content": content.hex(),
                  "compile_key": list(_compile_key_of(plan)),
                  "alloc": alloc, "format": fmt,
                  "n_tiles": int(tiles.shape[0]),
                  "n_windows": int(packed.n_windows),
                  "n_gates": int(packed.n_gates),
                  "width": int(packed.width),
                  "provenance": _prov_to_json(provenance)}
        self._write(self.packed_path(content, plan, alloc, fmt), header,
                    tiles.tobytes())

    # ------------------------------------------------------------- bin

    def load_binary(self, name: str, chain: tuple) -> Optional[bytes]:
        """The bytes of the library ``name`` (its file name in the build
        directory) built by the toolchain ``chain``; None on a miss,
        corruption or another toolchain.  The digest is checked here,
        before the bytes reach a file ``dlopen`` may read."""
        def decode(header, payload):
            if header.get("so") != name or \
                    header.get("toolchain") != list(chain):
                return None             # skew: a plain miss
            return payload
        return self._load(self.bin_path(name, chain), decode)

    def store_binary(self, name: str, chain: tuple, data: bytes,
                     tag: Optional[dict] = None) -> None:
        """Persist the library ``name`` built by ``chain``.  ``tag`` says
        what built it: ``{"kind": "fixed", "name": ...}`` for a fixed
        kernel, or a B2 kernel's ``StaticKernel.tag``."""
        header = {"kind": "bin", "so": name, "toolchain": list(chain),
                  "tag": tag}
        self._write(self.bin_path(name, chain), header, data)

    # ------------------------------------------------------------- upkeep

    def _files(self) -> List[os.DirEntry]:
        try:
            with os.scandir(self.root) as it:
                return [e for e in it
                        if e.is_file() and e.name.endswith(_SUFFIX)]
        except OSError:
            return []

    def total_bytes(self) -> int:
        total = 0
        for e in self._files():
            try:
                total += e.stat().st_size
            except OSError:
                pass
        return total

    def tier_bytes(self) -> Dict[str, int]:
        """Bytes on disk per tier ("sched", "packed", "bin")."""
        out: Dict[str, int] = {}
        for e in self._files():
            kind = e.name.split("-", 1)[0]
            try:
                out[kind] = out.get(kind, 0) + e.stat().st_size
            except OSError:
                pass
        return out

    def _evict(self) -> None:
        """Oldest-mtime-first eviction until under ``max_bytes``.  Races
        with concurrent writers are benign: a vanished file is skipped,
        and an evicted-then-needed artifact is simply recomputed."""
        entries = []
        total = 0
        for e in self._files():
            try:
                st = e.stat()
            except OSError:
                continue
            entries.append((st.st_mtime, st.st_size, e.path))
            total += st.st_size
        if total <= self.max_bytes:
            return
        for _, size, path in sorted(entries):
            if total <= self.max_bytes:
                break
            try:
                os.unlink(path)
            except OSError:
                continue
            total -= size
            _CACHE.add("disk_evictions")

    def entries(self) -> List[dict]:
        """Parsed headers of every valid artifact on disk (diagnostics and
        the warm scan)."""
        out = []
        for e in self._files():
            parsed = self._read(e.path)
            if parsed is not None:
                out.append(parsed[0])
        return out

    def clear(self) -> int:
        n = 0
        for e in self._files():
            try:
                os.unlink(e.path)
                n += 1
            except OSError:
                pass
        return n

    # ------------------------------------------------------------- warm

    def warm(self) -> Dict[str, int]:
        """Preload every provenance-bearing artifact into the in-memory
        compiled cache on the ufunc configuration's device
        (``pim_ufunc.config.device``: the card unless the caller asks for
        the CPU): rebuild
        each program from its recorded build triple, verify its content
        hash against the stored key (a mismatch is skipped, never
        trusted), install the disk schedule and its device operands, its
        packed streams, and -- for this toolchain -- the fixed kernels'
        libraries and its B2 libraries, each regenerated from the
        schedule and checked against the stored name before its bytes
        are written to the build directory.  Returns counts:
        ``{"schedules", "streams", "executables", "skipped"}``
        (``executables``: libraries installed).

        This is the replica warm-start path: after ``warm()`` the first
        request for a cached program pays no levelize, no packing and no
        nvcc.  An entry it cannot install is left for that request to
        build."""
        from .. import pim_ufunc
        from ..kernels import ops as kops
        from ..kernels import pim_exec
        from ..kernels.plan import BACKENDS, ExecPlan

        device = kops._checked_device(pim_ufunc.config.device)
        counts = {"schedules": 0, "streams": 0, "executables": 0,
                  "skipped": 0}
        later = []
        comp_of: Dict[tuple, tuple] = {}    # (content, ck) -> (prog, plan)
        for e in self._files():
            parsed = self._read(e.path)
            if parsed is None:
                continue
            header, payload = parsed
            kind = header.get("kind")
            if kind in ("packed", "bin"):
                later.append(parsed)
                continue
            if kind != "sched":
                continue
            prov = _prov_from_json(header.get("provenance"))
            prog = None if prov is None else _program_from_provenance(prov)
            sched = _sched_from_parts(header, payload)
            if prog is None or sched is None or \
                    kops.content_key(prog).hex() != header.get("content"):
                counts["skipped"] += 1
                continue
            ck = tuple(int(v) for v in header["compile_key"])
            plan = ExecPlan(backend=dataclasses.replace(
                BACKENDS["ref"], slot_width=ck[0], level_max_width=ck[1],
                seg_levels=ck[2]), device=device)
            comp = kops.compiled(prog, plan)
            try:
                comp.install_schedule(prog, header["alloc"], sched)
            except ValueError:
                _CACHE.add("disk_errors")
                counts["skipped"] += 1
                continue
            comp.get_sched_dev(prog, plan, header["alloc"], device)
            comp_of[(header["content"], ck)] = (prog, plan)
            counts["schedules"] += 1
            _CACHE.add("disk_hits")
        chain = pim_exec.toolchain() if any(
            h.get("kind") == "bin" for h, _ in later) else None
        for header, payload in later:
            if self._install(header, payload, comp_of, device, chain):
                counts["streams" if header["kind"] == "packed"
                       else "executables"] += 1
                _CACHE.add("disk_hits")
            else:
                counts["skipped"] += 1
        return counts

    @staticmethod
    def _install(header: dict, payload: bytes, comp_of: dict, device: str,
                 chain) -> bool:
        """Install one packed or binary entry for :meth:`warm`; False when
        it belongs to no warmed program, to another record format or
        toolchain, or its regenerated source disagrees."""
        from ..kernels import ops as kops
        from ..kernels import pim_exec
        from ..kernels.plan import LAYOUTS
        if header["kind"] == "packed":
            key = (header.get("content"),
                   tuple(int(v) for v in header.get("compile_key", ())))
            p = _packed_from_parts(header, payload)
            if key not in comp_of or p is None:
                return False
            prog, plan = comp_of[key]
            return kops.compiled(prog, plan).install_packed(
                prog, plan, header["alloc"], p, device)
        if header.get("toolchain") != list(chain):
            return False
        tag = header.get("tag") or {}
        if tag.get("kind") == "fixed":
            name = tag.get("name")
            if name not in pim_exec.SOURCES or \
                    pim_exec._so_path(name).name != header.get("so"):
                return False
            pim_exec.publish(payload, pim_exec._so_path(name))
            return True
        if tag.get("kind") != "static":
            return False
        key = (tag.get("content"),
               tuple(int(v) for v in tag.get("compile_key", ())))
        if key not in comp_of:
            return False
        prog, plan = comp_of[key]
        plan = dataclasses.replace(
            plan, layout=LAYOUTS["rows64" if tag["planes"] == 2
                                 else "rows32"],
            backend=dataclasses.replace(
                plan.backend, words_per_cta=tag["words_per_cta"]))
        return kops.compiled(prog, plan).install_static(
            prog, plan, tuple(tag["in_names"]), tuple(tag["in_widths"]),
            tuple(tag["out_widths"]), header["so"], payload)

    def tuned_path(self) -> str:
        """Where the autotuner's winners live for this cache directory."""
        return os.path.join(self.root, TUNED_BASENAME)
