"""Deterministic fault models for the PIM substrate (DESIGN.md §12).

AritPIM's case study targets memristive crossbars, where stuck-at cells,
transient disturb flips and worn-out rows are first-class hardware
realities.  This module is the *model* half of the fault-tolerance layer:
a frozen, seeded :class:`FaultModel` that maps physical coordinates (rows,
packed word columns) to persistent faults, and samples per-level transient
flips -- all counter-based (splitmix64 over absolute coordinates), so any
span can be queried in any order, any number of times, with identical
answers and zero mutable state.  The *mechanism* half (check words, chunk
retry, row remapping) lives in ``kernels.ops``; the knobs that govern it
are :class:`VerifyPolicy` here.

Fault semantics, chosen to be layout-polymorphic (identical observable
effect under rows32 and rows64, fused-value and packed-word output paths):

* **dead row** -- an endurance-failed physical row: every cell of that row
  reads 0.  Persistent: the same absolute row is dead forever.
* **stuck word column** -- one aligned 32-row group (absolute uint32 word
  column ``j`` covers physical rows ``32j .. 32j+31``) whose readback is
  stuck all-0 or all-1 across every cell.  Models a failed sense-amp /
  driver stripe.  Persistent.
* **transient flip** -- per executed level, with probability ``p_flip``,
  one random output-cell bit of the chunk flips.  Re-sampled per attempt
  (``attempt`` feeds the hash), so a retry re-rolls the dice -- the
  defining property of a transient.

Persistent faults are discoverable *before* execution (the simulated BIST
scan :meth:`FaultModel.span_bad` -- how the remapper steers chunks onto
clean spare rows); transients are only observable *after*, which is what
the check-word + spot-check machinery in ``kernels.ops`` is for.

This module imports only ``runtime.telemetry`` (itself stdlib +
``core.device_model`` only) from the package: ``kernels.plan`` hangs a
FaultModel off every ExecPlan, so anything heavier imported here would
cycle.
"""

from __future__ import annotations

import collections
import dataclasses
import threading
from typing import Dict, Optional, Tuple

import numpy as np

from . import telemetry

__all__ = ["FaultModel", "VerifyPolicy", "FaultError", "DeadlineExceeded",
           "word_coords", "Scrubber", "record_wear", "note_quarantine",
           "quarantined_spans", "release_span", "wear_snapshot",
           "drain_media_health"]


class FaultError(RuntimeError):
    """Verified execution exhausted its retry/remap budget (or no clean
    physical span exists): the result could not be produced bit-exactly.

    ``context`` carries the structured failure coordinates the serving
    error taxonomy surfaces to operators (``classify_error`` folds it into
    the response's error payload): the failing program's content-key
    prefix, the chunk/stage that died, how many attempts were burned and
    where the remapper last placed it.  Only non-None fields are kept, and
    a bare ``FaultError("msg")`` stays valid (``context == {}``)."""

    def __init__(self, message: str = "", **context):
        super().__init__(message)
        self.context = {k: v for k, v in context.items() if v is not None}


class DeadlineExceeded(RuntimeError):
    """A per-request deadline expired before (or between) chunks."""


# ------------------------------------------------------------ hashing
#
# Counter-based randomness: splitmix64 over absolute coordinates.  numpy
# uint64 arithmetic wraps silently (unlike Python ints), which is exactly
# the mod-2^64 semantics splitmix wants.

_GOLD = np.uint64(0x9E3779B97F4A7C15)
_MIX1 = np.uint64(0xBF58476D1CE4E5B9)
_MIX2 = np.uint64(0x94D049BB133111EB)
_MASK64 = (1 << 64) - 1


def _mix64(x: np.ndarray) -> np.ndarray:
    x = np.asarray(x, np.uint64)
    with np.errstate(over="ignore"):        # mod-2^64 wrap is the point
        x = (x ^ (x >> np.uint64(30))) * _MIX1
        x = (x ^ (x >> np.uint64(27))) * _MIX2
    return x ^ (x >> np.uint64(31))


def _h(key: int, idx) -> np.ndarray:
    """Uniform uint64 hash of each element of ``idx`` under ``key``."""
    idx = np.asarray(idx, np.uint64)
    with np.errstate(over="ignore"):
        seeded = idx * _GOLD + np.uint64(key & _MASK64)
    return _mix64(_mix64(seeded) ^ _GOLD)


def _u01(h: np.ndarray) -> np.ndarray:
    """Map uint64 hashes to uniform floats in [0, 1)."""
    return (h >> np.uint64(11)).astype(np.float64) * (2.0 ** -53)


# Domain-separation tags for the per-fault-kind hash streams.
_T_DEAD, _T_STUCK, _T_STUCKV, _T_FLIP, _T_FLIPPOS = 1, 2, 3, 4, 5


def word_coords(rows, planes: int) -> tuple:
    """Map chunk-relative row indices to packed-state coordinates
    ``(plane, word, bit)`` for a ``planes``-layout state: rows32 puts row
    ``r`` at bit ``r % 32`` of word ``r // 32`` (plane always 0); rows64
    puts it at plane ``(r % 64) // 32`` of word ``r // 64`` -- the
    little-endian uint32 halves of one 64-row word.  The single source of
    truth for fault-injection coordinates (``kernels.slots`` re-exports it
    next to its band helpers)."""
    r = np.asarray(rows, np.int64)
    rpw = 32 * planes
    return (r % rpw) // 32, r // rpw, r % 32


@dataclasses.dataclass(frozen=True)
class FaultModel:
    """Seeded, deterministic fault map for the simulated PIM substrate.

    Probabilistic fields sample faults by hashed absolute coordinate;
    ``force_*`` fields plant specific faults for tests:

    * ``force_dead_rows`` -- absolute physical row indices.
    * ``force_stuck`` -- ``(word_col, bit_value)`` pairs: absolute uint32
      word column stuck at all-0 (``0``) or all-1 (``1``).
    * ``force_flips`` -- ``(out_cell, row)`` pairs injected only on a
      chunk's *first* attempt (transients re-roll on retry; a forced flip
      that persisted would be a stuck fault, not a transient).

    ``spare_base`` is the first physical row of the spare region the
    remapper allocates from; keep it far above any real traffic.  All
    fields are hashable scalars/tuples so the model can live on a frozen
    ``ExecPlan`` and inside ``plan.key``.
    """
    seed: int = 0
    p_flip: float = 0.0          # per level, per chunk attempt
    p_stuck: float = 0.0         # per aligned 32-row word column
    p_dead_row: float = 0.0      # per physical row
    spare_base: int = 1 << 34
    force_flips: Tuple = ()
    force_dead_rows: Tuple = ()
    force_stuck: Tuple = ()

    def __post_init__(self):
        for name in ("p_flip", "p_stuck", "p_dead_row"):
            p = getattr(self, name)
            if not 0.0 <= p <= 1.0:
                raise ValueError(f"{name} must be in [0, 1], got {p}")
        if self.spare_base % 64:
            raise ValueError("spare_base must be 64-row aligned "
                             f"(got {self.spare_base})")
        for attr in ("force_flips", "force_dead_rows", "force_stuck"):
            object.__setattr__(self, attr,
                               tuple(tuple(v) if isinstance(v, (list, tuple))
                                     else int(v)
                                     for v in getattr(self, attr)))

    def _key(self, tag: int) -> int:
        return (int(self.seed) * 0x100000001B3 + tag) & _MASK64

    # ------------------------------------------------- persistent faults

    def dead_rows(self, lo: int, hi: int) -> np.ndarray:
        """Absolute dead physical rows in ``[lo, hi)``, sorted."""
        parts = [np.asarray([r for r in self.force_dead_rows
                             if lo <= r < hi], np.int64)]
        if self.p_dead_row > 0.0 and hi > lo:
            rows = np.arange(lo, hi, dtype=np.int64)
            parts.append(rows[_u01(_h(self._key(_T_DEAD), rows))
                              < self.p_dead_row])
        return np.unique(np.concatenate(parts)) if len(parts) > 1 or \
            parts[0].size else parts[0]

    def stuck_cols(self, wlo: int, whi: int
                   ) -> Tuple[np.ndarray, np.ndarray]:
        """Stuck word columns in absolute uint32-word range ``[wlo, whi)``:
        ``(word indices int64[], fill words uint32[])`` where each fill is
        0x00000000 (stuck-at-0) or 0xFFFFFFFF (stuck-at-1).  Forced
        entries override sampled ones on the same column."""
        stuck = {}
        if self.p_stuck > 0.0 and whi > wlo:
            words = np.arange(wlo, whi, dtype=np.int64)
            sel = _u01(_h(self._key(_T_STUCK), words)) < self.p_stuck
            words = words[sel]
            ones = (_h(self._key(_T_STUCKV), words)
                    & np.uint64(1)).astype(bool)
            for w, o in zip(words, ones):
                stuck[int(w)] = np.uint32(0xFFFFFFFF) if o else np.uint32(0)
        for w, v in self.force_stuck:
            if wlo <= w < whi:
                stuck[int(w)] = np.uint32(0xFFFFFFFF) if v else np.uint32(0)
        if not stuck:
            return np.zeros(0, np.int64), np.zeros(0, np.uint32)
        ws = np.asarray(sorted(stuck), np.int64)
        return ws, np.asarray([stuck[int(w)] for w in ws], np.uint32)

    def span_bad(self, row_base: int, n_rows: int) -> bool:
        """Simulated BIST media scan: does the physical span
        ``[row_base, row_base + n_rows)`` contain any persistent fault
        (dead row or stuck word column)?  This is the pre-placement check
        the remapper uses to steer chunks onto clean spare spans -- it
        reads the *model*, standing in for a write/readback march test."""
        if self.dead_rows(row_base, row_base + n_rows).size:
            return True
        w, _ = self.stuck_cols(row_base // 32, (row_base + n_rows + 31) // 32)
        return bool(w.size)

    # ------------------------------------------------- transient faults

    def sample_flips(self, salt: int, attempt: int, n_levels: int,
                     k_out: int, n_rows: int
                     ) -> Tuple[np.ndarray, np.ndarray]:
        """Transient output-bit flips for one chunk attempt: arrays
        ``(cells, rows)`` -- flipped output-cell index (of the ``k_out``
        stacked output cells) and chunk-relative row.  Each of the chunk's
        ``n_levels`` executed levels flips one uniformly random output bit
        with probability ``p_flip``; ``salt`` carries the chunk identity
        and ``attempt`` re-rolls on retry.  Forced flips apply on attempt
        0 only."""
        cells = [np.asarray([t for t, r in self.force_flips
                             if 0 <= t < k_out and 0 <= r < n_rows],
                            np.int64)] if attempt == 0 else []
        rows = [np.asarray([r for t, r in self.force_flips
                            if 0 <= t < k_out and 0 <= r < n_rows],
                           np.int64)] if attempt == 0 else []
        if self.p_flip > 0.0 and n_levels > 0 and k_out > 0 and n_rows > 0:
            key = int(_mix64(np.uint64(
                (self._key(_T_FLIP) ^ (salt & _MASK64)
                 ^ (attempt * 0x9E3779B97F4A7C15)) & _MASK64)))
            lv = np.arange(n_levels, dtype=np.int64)
            hit = lv[_u01(_h(key, lv)) < self.p_flip]
            if hit.size:
                pos = _h((key + _T_FLIPPOS) & _MASK64, hit)
                cells.append((pos % np.uint64(k_out)).astype(np.int64))
                rows.append(((pos >> np.uint64(20))
                             % np.uint64(n_rows)).astype(np.int64))
        if not cells:
            return np.zeros(0, np.int64), np.zeros(0, np.int64)
        return np.concatenate(cells), np.concatenate(rows)

    # ------------------------------------------------- injection appliers
    #
    # Both output representations of the levelized dispatcher get a
    # fault-applier with identical observable semantics, so detection and
    # recovery are representation-agnostic:
    #   * packed word blocks (the padded-io path): (k, W) rows32 or
    #     (planes, k, W) rows64, cell axis -2;
    #   * fused per-port row values (the fused fast path): (P, R) uint32.

    def inject_packed(self, sub: np.ndarray, *, row_base: int, salt: int,
                      attempt: int, n_levels: int
                      ) -> Tuple[np.ndarray, int]:
        """Apply this model's faults to a packed output block covering
        physical rows ``[row_base, row_base + span)``; returns
        ``(corrupted copy, number of faults applied)``."""
        sub = np.array(sub, copy=True)
        if sub.ndim == 2:
            planes, (k, n_words) = 1, sub.shape
        else:
            planes, k, n_words = sub.shape
        span = n_words * 32 * planes
        n = 0
        dead = self.dead_rows(row_base, row_base + span)
        if dead.size:
            pl, w, b = word_coords(dead - row_base, planes)
            clear = np.zeros((planes, n_words), np.uint32)
            np.bitwise_or.at(clear, (pl, w),
                             np.uint32(1) << b.astype(np.uint32))
            sub &= ~clear[0][None, :] if sub.ndim == 2 \
                else ~clear[:, None, :]
            n += int(dead.size)
        wcols, fills = self.stuck_cols(row_base // 32,
                                       (row_base + span) // 32)
        if wcols.size:
            pl, w, _ = word_coords(wcols * 32 - row_base, planes)
            if sub.ndim == 2:
                sub[:, w] = fills[None, :]
            else:
                sub[pl, :, w] = fills[:, None]
            n += int(wcols.size)
        cells, rows = self.sample_flips(salt, attempt, n_levels, k, span)
        if cells.size:
            pl, w, b = word_coords(rows, planes)
            bit = np.uint32(1) << b.astype(np.uint32)
            if sub.ndim == 2:
                np.bitwise_xor.at(sub, (cells, w), bit)
            else:
                np.bitwise_xor.at(sub, (pl, cells, w), bit)
            n += int(cells.size)
        return sub, n

    def inject_values(self, vals: np.ndarray, out_widths, *, row_base: int,
                      salt: int, attempt: int, n_levels: int
                      ) -> Tuple[np.ndarray, int]:
        """Apply this model's faults to fused per-port row values
        ``uint32[n_ports, span]`` (port ``p``'s row ``r`` is the packed
        value of its ``out_widths[p]`` cells); same observable semantics
        as :meth:`inject_packed` on the corresponding packed block."""
        vals = np.array(vals, copy=True)
        n_ports, span = vals.shape
        masks = np.asarray([(np.uint32(1) << np.uint32(w)) - np.uint32(1)
                            if w < 32 else np.uint32(0xFFFFFFFF)
                            for w in out_widths], np.uint32)
        n = 0
        dead = self.dead_rows(row_base, row_base + span)
        if dead.size:
            vals[:, dead - row_base] = 0
            n += int(dead.size)
        wcols, fills = self.stuck_cols(row_base // 32,
                                       (row_base + span) // 32)
        if wcols.size:
            starts = wcols * 32 - row_base
            idx = (starts[:, None] + np.arange(32)).ravel()
            fill_rows = np.repeat(fills != 0, 32)
            vals[:, idx[~fill_rows]] = 0
            if fill_rows.any():
                vals[:, idx[fill_rows]] = masks[:, None]
            n += int(wcols.size)
        k_out = int(sum(out_widths))
        cells, rows = self.sample_flips(salt, attempt, n_levels, k_out, span)
        if cells.size:
            bounds = np.cumsum(np.asarray(out_widths, np.int64))
            port = np.searchsorted(bounds, cells, side="right")
            bit = cells - (bounds[port] - np.asarray(out_widths,
                                                     np.int64)[port])
            np.bitwise_xor.at(vals, (port, rows),
                              np.uint32(1) << bit.astype(np.uint32))
            n += int(cells.size)
        return vals, n


@dataclasses.dataclass(frozen=True)
class VerifyPolicy:
    """Knobs of verified execution's detect -> retry -> remap machinery
    (the state machine itself lives in ``kernels.ops``; DESIGN.md §12).

    * ``max_retries`` -- chunk re-executions before giving up with
      :class:`FaultError`.
    * ``remap_after`` -- failed attempts at one physical placement before
      the chunk is re-homed onto a fresh spare span (attempts below this
      assume a transient and just re-run in place).
    * ``backoff_s`` -- base of the exponential inter-retry backoff
      (``backoff_s * 2**(attempt-1)``, capped at 50 ms).
    * ``spot_rows`` / ``spot_interval_rows`` -- numpy-oracle spot checks:
      every ``spot_interval_rows`` verified rows, ``spot_rows`` sampled
      rows of the next chunk are recomputed on the cycle-accurate oracle
      and compared bit-exactly.  Amortized per *row*, not per chunk, so
      small hot arrays don't oracle-check every call; 0 interval checks
      every chunk (tests), ``spot_rows=0`` disables.
    * ``scan_limit`` -- spare spans the media scan may reject while
      placing one chunk before :class:`FaultError`.
    """
    max_retries: int = 4
    remap_after: int = 2
    backoff_s: float = 5e-4
    spot_rows: int = 2
    spot_interval_rows: int = 1 << 20
    scan_limit: int = 16

    def __post_init__(self):
        if self.max_retries < 0 or self.remap_after < 1 \
                or self.scan_limit < 1:
            raise ValueError("max_retries >= 0, remap_after >= 1 and "
                             "scan_limit >= 1 required")


# --------------------------------------------------------------------------
# media lifecycle: wear counters + quarantined-span scrubbing
# --------------------------------------------------------------------------
#
# Verified execution (kernels.ops) reports two media events here: every
# dispatch attempt *writes* a physical span (wear -- memristive endurance
# is finite, so operators need per-span write counts), and every remap
# *abandons* a physical span (quarantine -- the span either holds a real
# persistent fault or merely looked marginal during a transient storm).
# The :class:`Scrubber` is the background half: it periodically re-scans
# quarantined spans with the same simulated BIST used for placement,
# reclaiming the ones that scan clean and keeping genuinely bad media out
# of circulation.  Everything is module-level (one physical substrate per
# process, like ops.HEALTH) and lock-guarded, because the scrubber thread
# runs concurrently with the serving executor.

_MEDIA_LOCK = threading.Lock()

#: Per physical span (keyed by base row): verified dispatch attempts that
#: wrote it.  The endurance ledger -- memristive cells wear out, and a
#: span that absorbs orders of magnitude more writes than its peers is the
#: next dead row.
WEAR: "collections.Counter" = collections.Counter()

#: Spans the remapper abandoned, base row -> span rows; the scrubber's
#: work queue.
_QUARANTINE: Dict[int, int] = {}

#: Cumulative scrub/wear health counters (scrub_passes, spans_scrubbed,
#: spans_reclaimed, spans_still_bad, quarantined_spans, wear_writes) --
#: a Counter-shaped view over the global telemetry registry's
#: ``pim.media.*`` names, guarded by the registry's lock (``_MEDIA_LOCK``
#: keeps guarding the WEAR/_QUARANTINE structures above);
#: :func:`drain_media_health` snapshots-and-resets (the serving stats
#: absorb them next to ops.drain_health()).
MEDIA: "telemetry.CounterGroup" = telemetry.REGISTRY.group("pim.media")


def record_wear(row_base: int, n_rows: int, attempts: int = 1) -> None:
    """Count ``attempts`` write cycles against the span at ``row_base``."""
    with _MEDIA_LOCK:
        WEAR[int(row_base)] += int(attempts)
    MEDIA.add("wear_writes", int(attempts))


def note_quarantine(row_base: int, n_rows: int) -> None:
    """Hand an abandoned span to the scrubber's work queue."""
    with _MEDIA_LOCK:
        prev = _QUARANTINE.get(int(row_base), 0)
        if int(n_rows) > prev:
            _QUARANTINE[int(row_base)] = int(n_rows)
    if not prev:
        MEDIA.add("quarantined_spans")


def quarantined_spans() -> Dict[int, int]:
    """Snapshot of the quarantine queue (base row -> span rows)."""
    with _MEDIA_LOCK:
        return dict(_QUARANTINE)


def release_span(row_base: int) -> bool:
    """Drop a span from quarantine (it scanned clean); True if present."""
    with _MEDIA_LOCK:
        return _QUARANTINE.pop(int(row_base), None) is not None


def wear_snapshot(top: int = 8) -> Dict[int, int]:
    """The ``top`` most-written spans (base row -> write count)."""
    with _MEDIA_LOCK:
        return dict(sorted(WEAR.items(), key=lambda kv: -kv[1])[:top])


def drain_media_health() -> dict:
    """Snapshot and reset :data:`MEDIA`; returns the non-zero counters.
    (Compatibility shim over ``MEDIA.drain()`` -- the historical API.)"""
    return MEDIA.drain()


class Scrubber:
    """Background spare-span scrubber (DESIGN.md §14).

    Re-scans every quarantined span against ``model``'s simulated BIST:
    spans that scan clean were quarantined by a transient storm (the
    remapper treats "keeps failing verification" as "marginal media") and
    are *reclaimed* -- released from quarantine so the physical rows
    return to the usable pool; spans with persistent faults stay
    quarantined and are re-checked next pass.  ``scrub_once`` is the
    synchronous unit of work (tests drive it directly);
    ``start``/``stop`` run it on a daemon thread at ``interval_s`` --
    the serving loop's background media hygiene.
    """

    def __init__(self, model: "FaultModel", *, interval_s: float = 0.25):
        self.model = model
        self.interval_s = float(interval_s)
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def scrub_once(self) -> dict:
        """One scrub pass; returns ``{"scrubbed", "reclaimed",
        "still_bad"}`` counts and updates :data:`MEDIA`."""
        reclaimed = still_bad = 0
        for base, rows in quarantined_spans().items():
            if self.model.span_bad(base, rows):
                still_bad += 1
            elif release_span(base):
                reclaimed += 1
        MEDIA.add("scrub_passes")
        MEDIA.add("spans_scrubbed", reclaimed + still_bad)
        MEDIA.add("spans_reclaimed", reclaimed)
        MEDIA["spans_still_bad"] = still_bad   # gauge, not cumulative
        return {"scrubbed": reclaimed + still_bad,
                "reclaimed": reclaimed, "still_bad": still_bad}

    def start(self) -> "Scrubber":
        if self._thread is not None:
            return self
        self._stop.clear()

        def loop():
            while not self._stop.wait(self.interval_s):
                self.scrub_once()

        self._thread = threading.Thread(target=loop, daemon=True,
                                        name="pim-scrubber")
        self._thread.start()
        return self

    def stop(self) -> None:
        if self._thread is None:
            return
        self._stop.set()
        self._thread.join(timeout=5.0)
        self._thread = None
