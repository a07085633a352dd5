"""The port's persistent artifact cache (``repro_torch.runtime.
artifact_cache``), held to the reference's contract on the CPU.

One case for each test of ``tests/test_artifact_cache.py``, on the
schedule tier and on the packed tier (the streams B1, B3 and B4 read):
disk round trips are bit-exact against numpy under every schedule and
layout, corruption heals, version and format skew are a plain miss, the
size cap evicts least-recently-used entries, concurrent writers never
tear a file, and ``warm()`` (in process, and through a second
``--pim-serve --pim-device cpu`` replica) restores a process to hot with
no levelize and no packing.  Then the parity anchors: the port's schedule
artifacts have the reference's paths and bytes, and the binary tier (the
kernels' libraries) behaves like the reference's executable tier under a
fake toolchain.  Inputs come from seeded numpy generators.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro.core import pim_numerics as rpn
from repro.kernels import ops as rops
from repro.runtime.artifact_cache import ArtifactCache as RefCache
from repro_torch import pim_ufunc as pim
from repro_torch.core import pim_numerics as tpn
from repro_torch.kernels import ops as kops
from repro_torch.kernels import pim_exec
from repro_torch.kernels import plan as kplan
from repro_torch.runtime import telemetry
from repro_torch.runtime.artifact_cache import _MAGIC, ArtifactCache
# the kernels' loop over a packed stream, in plain PyTorch
from test_torch_ring import _run_packed_fused

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = {"device": "cpu", "backend": "ref"}
TIERS = ("sched", "packed")


def _c(name: str) -> int:
    return int(telemetry.REGISTRY.counter(f"pim.cache.{name}"))


def _env() -> dict:
    env = dict(os.environ)
    env["PYTHONPATH"] = os.path.join(REPO, "src") + (
        os.pathsep + env["PYTHONPATH"] if env.get("PYTHONPATH") else "")
    return env


@pytest.fixture
def cache(tmp_path):
    """A fresh on-disk cache installed process-wide over an empty
    in-memory compiled cache (what earlier tests of the process left
    there would never reach the disk), uninstalled and cleared afterwards
    so tests stay isolated."""
    c = ArtifactCache(tmp_path / "cache")
    kops.clear_compiled_cache()
    kops.set_artifact_cache(c)
    try:
        yield c
    finally:
        kops.set_artifact_cache(None)
        kops.clear_compiled_cache()
        kplan.clear_tuned()


def _fp16_operands(rng, n):
    # mid-range exponents: products/sums stay normal (no NaN/Inf/subnormal)
    def bits(k):
        return (rng.integers(10, 21, k).astype(np.uint16) << 10 |
                rng.integers(0, 1 << 10, k).astype(np.uint16)
                ).view(np.float16)
    return bits(n), bits(n)


def _packed_run(prep) -> dict:
    """Run ``prep`` on the CPU through the packed stream its schedule's
    kernel would read (``_Compiled.get_packed``, so through the cache's
    packed tier), with the kernels' loop in plain PyTorch; returns the
    output ports' values."""
    prog, plan = prep.program, prep.plan
    in_names = tuple(sorted(prep.inputs))
    comp = kops.compiled(prog, plan)
    r = comp.resolve(prog, plan, in_names)
    packed = comp.get_packed(prog, plan, r.kind, "cpu")
    x = np.zeros((len(in_names), prep.n_rows), np.int32)
    for p, n in enumerate(in_names):
        x[p] = prep.inputs[n]
    out = _run_packed_fused(torch.from_numpy(x), packed, r.in_idx,
                            r.out_idx, n_cells=r.sched.n_cells,
                            one_cell=r.one_cell, in_widths=r.in_widths,
                            out_widths=r.out_widths,
                            planes=plan.layout.planes)
    return {n: out[i].numpy().astype(np.uint32).astype(np.uint64)
            for i, n in enumerate(r.names)}


def _mul8(tier: str, x, y):
    """uint8 mul through ``tier``: the ufunc (schedules) or the packed
    stream of its default plan; returns the products."""
    if tier == "sched":
        return pim.mul(x, y, width=8, **CPU)
    prep = pim.prepare("mul", x, y, width=8, **CPU)
    return _packed_run(prep)["z"]


# --------------------------------------------------------------------------
# the reference's contract, tier by tier
# --------------------------------------------------------------------------

@pytest.mark.parametrize("tier", TIERS)
def test_disk_roundtrip_bit_exact_all_layouts_schedules(cache, tier):
    """Populate the disk tier, drop all in-memory compiled state, and
    re-execute: every (layout x schedule) combination must come back from
    disk (no fresh levelize, no fresh packing) bit-identical to numpy."""
    rng = np.random.default_rng(0)
    n = 256
    x = rng.integers(0, 1 << 16, n).astype(np.uint16)
    y = rng.integers(0, 1 << 16, n).astype(np.uint16)
    fx, fy = _fp16_operands(rng, n)
    schedules = ("slots", "slots-static", "dense") if tier == "sched" \
        else ("slots", "dense")
    combos = [(lay, sch) for lay in ("rows32", "rows64")
              for sch in schedules]

    def run_all():
        outs = []
        for lay, sch in combos:
            kw = dict(CPU, layout=lay, schedule=sch)
            if tier == "sched":
                outs.append(pim.add(x, y, width=16, **kw))
                outs.append(pim.fp_mul(fx, fy, **kw))
                continue
            outs.append(_packed_run(pim.prepare("add", x, y, width=16,
                                                **kw))["z"])
            prep = pim.prepare("fp_mul", fx, fy, **kw)
            outs.append(prep.finish(_packed_run(prep)))
        return outs

    run_all()                                   # populate disk
    assert _c("disk_writes") > 0
    assert kops.clear_compiled_cache() > 0      # drop in-memory state

    lev0, pk0, hits0 = _c("levelized"), _c("packed"), _c("disk_hits")
    outs = run_all()
    assert _c("levelized") == lev0, "schedule came from levelize, not disk"
    assert _c("packed") == pk0, "stream came from packing, not disk"
    assert _c("disk_hits") > hits0
    for i in range(0, len(outs), 2):
        assert np.array_equal(outs[i], x.astype(np.uint64) + y)
        assert np.array_equal(outs[i + 1], (fx * fy).astype(np.float16))


@pytest.mark.parametrize("tier", TIERS)
def test_corruption_recomputes_and_heals(cache, tier):
    """A byte flipped anywhere in an artifact fails the checksum: the load
    counts ``disk_errors``, unlinks the bad file, recomputes the correct
    answer, and the write-through heals the entry for the next reader."""
    rng = np.random.default_rng(1)
    x = rng.integers(0, 1 << 8, 64).astype(np.uint8)
    y = rng.integers(0, 1 << 8, 64).astype(np.uint8)
    _mul8(tier, x, y)
    files = sorted(e.path for e in cache._files()
                   if os.path.basename(e.path).startswith(tier))
    assert files
    for path in files:
        with open(path, "r+b") as f:
            f.seek(20)
            b = f.read(1)
            f.seek(20)
            f.write(bytes([b[0] ^ 0xFF]))
    kops.clear_compiled_cache()

    err0, pk0 = _c("disk_errors"), _c("packed")
    out = _mul8(tier, x, y)
    assert _c("disk_errors") > err0
    assert np.array_equal(out, x.astype(np.uint64) * y)
    if tier == "packed":
        assert _c("packed") > pk0               # repacked
    for path in files:                  # bad files unlinked or rewritten
        if os.path.exists(path):
            with open(path, "rb") as f:
                assert f.read(8) == _MAGIC

    # healed: a third cold start loads from disk again
    kops.clear_compiled_cache()
    lev0, pk0 = _c("levelized"), _c("packed")
    assert np.array_equal(_mul8(tier, x, y), out)
    assert _c("levelized") == lev0 and _c("packed") == pk0


@pytest.mark.parametrize("tier", TIERS)
def test_version_mismatch_is_plain_miss(cache, tier, monkeypatch):
    """A future-format magic makes every load a miss (never a parse), and
    so does another record format of the packed streams (a change to
    ``csrc/ring.cuh``): execution recomputes and overwrites."""
    rng = np.random.default_rng(2)
    x = rng.integers(0, 1 << 8, 64).astype(np.uint8)
    y = rng.integers(0, 1 << 8, 64).astype(np.uint8)
    out0 = _mul8(tier, x, y)
    if tier == "sched":
        for e in cache._files():
            with open(e.path, "r+b") as f:
                f.write(b"PIMART99")
    else:
        monkeypatch.setattr(pim_exec, "packed_format",
                            lambda: "tile512-win8-gwin2-const2-ringchanged")
    kops.clear_compiled_cache()
    lev0, pk0, err0 = _c("levelized"), _c("packed"), _c("disk_errors")
    out1 = _mul8(tier, x, y)
    counter = "levelized" if tier == "sched" else "packed"
    assert _c(counter) > (lev0 if tier == "sched" else pk0)
    assert np.array_equal(out0, out1)
    if tier == "packed":
        assert _c("disk_errors") == err0        # skew is no error


@pytest.mark.parametrize("tier", TIERS)
def test_size_cap_evicts_least_recently_used(tmp_path, tier):
    """Writes past ``max_bytes`` evict oldest-mtime files first (loads
    refresh mtime, so the order is least-recently-used)."""
    prog = tpn.program_for("int-serial", "add", 8)
    plan = kops.make_plan(**CPU)
    sched = kops.program_schedule(prog, plan)
    packed = pim_exec.pack_slots(sched.a, sched.b, sched.out,
                                 n_cells=sched.n_cells)

    def store(c, key):
        if tier == "sched":
            c.store_schedule(key, (6, 8, 128), "slots", sched)
            return c.sched_path(key, (6, 8, 128), "slots")
        c.store_packed(key, (6, 8, 128), "slots", packed)
        return c.packed_path(key, (6, 8, 128), "slots",
                             pim_exec.packed_format())

    big = ArtifactCache(tmp_path / "big")
    store(big, b"\x01" * 16)
    one = os.path.getsize(big._files()[0].path)

    c = ArtifactCache(tmp_path / "capped", max_bytes=int(one * 2.5))
    ev0 = _c("disk_evictions")
    paths = []
    for i, age in enumerate((100, 50)):
        p = store(c, bytes([i]) * 16)
        t = os.path.getmtime(p) - age
        os.utime(p, (t, t))
        paths.append(p)
    newest = store(c, b"\x10" * 16)
    assert not os.path.exists(paths[0]), "oldest entry survived the cap"
    assert os.path.exists(newest)
    assert _c("disk_evictions") > ev0
    assert c.total_bytes() <= c.max_bytes


def test_concurrent_multiprocess_writers(tmp_path):
    """Four processes race the same cache directory on the same programs,
    schedules and packed streams both: all succeed, and every surviving
    artifact is complete and loadable."""
    cache_dir = tmp_path / "shared"
    script = (
        "import numpy as np\n"
        "from repro_torch import pim_ufunc as pim\n"
        "from repro_torch.core import pim_numerics as pn\n"
        "from repro_torch.kernels import ops\n"
        "pim.configure(cache_dir=%r, device='cpu', backend='ref')\n"
        "x = np.arange(64, dtype=np.uint8); y = (x * 3 + 1).astype(np.uint8)\n"
        "assert np.array_equal(pim.add(x, y, width=8),\n"
        "    x.astype(np.uint64) + y)\n"
        "assert np.array_equal(pim.mul(x, y, width=8),\n"
        "    x.astype(np.uint64) * y)\n"
        "p = pn.program_for('int-serial', 'mul', 8)\n"
        "plan = ops.make_plan(device='cpu', backend='ref')\n"
        "ops.compiled(p, plan).get_packed(p, plan, 'slots', 'cpu')\n"
        "print('OK')\n" % str(cache_dir))
    procs = [subprocess.Popen([sys.executable, "-c", script], cwd=REPO,
                              env=_env(), stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for _ in range(4)]
    for p in procs:
        out, err = p.communicate(timeout=600)
        assert p.returncode == 0 and "OK" in out, err[-800:]
    c = ArtifactCache(cache_dir)
    headers = c.entries()               # _read verifies every checksum
    kinds = {h["kind"] for h in headers}
    assert kinds == {"sched", "packed"}
    assert not [n for n in os.listdir(cache_dir) if n.endswith(".tmp")]


def test_warm_installs_schedules_and_streams(cache):
    """``warm()`` on a populated directory rebuilds programs from their
    recorded provenance and installs the schedule, its device operands
    and its packed stream: the next call pays no levelize and no packing
    and stays bit-exact; an entry whose program hash disagrees is
    skipped."""
    rng = np.random.default_rng(3)
    fx, fy = _fp16_operands(rng, 512)
    prep = pim.prepare("fp_add", fx, fy, **CPU)
    out0 = prep.finish(_packed_run(prep))
    assert np.array_equal(pim.fp_add(fx, fy, **CPU), out0)
    kops.clear_compiled_cache()

    counts = _warm_on_cpu(cache)
    assert counts["schedules"] >= 1 and counts["streams"] >= 1
    assert counts["executables"] == 0 and counts["skipped"] == 0
    assert kops.is_compiled(prep.program, prep.plan)
    lev0, pk0, miss0 = _c("levelized"), _c("packed"), _c("disk_misses")
    out1 = prep.finish(_packed_run(prep))
    assert np.array_equal(pim.fp_add(fx, fy, **CPU), out1)
    assert _c("levelized") == lev0 and _c("packed") == pk0
    assert _c("disk_misses") == miss0
    assert np.array_equal(out0, out1)
    assert np.array_equal(out1, (fx + fy).astype(np.float16))

    # a schedule entry naming another program is skipped, never trusted
    for e in cache._files():
        if os.path.basename(e.path).startswith("sched"):
            header, payload = cache._read(e.path)
            header["provenance"] = ["program_for", "fp-serial", "mul",
                                    "fp16"]
            cache._write(e.path, header, payload)
    kops.clear_compiled_cache()
    counts = _warm_on_cpu(cache)
    assert counts["schedules"] == 0 and counts["skipped"] >= 1


def _warm_on_cpu(cache) -> dict:
    with pim.options(device="cpu"):
        return cache.warm()


def _run_serve(reqs, cache_dir, metrics=None):
    args = [sys.executable, "-m", "repro_torch.launch.serve", "--pim-serve",
            "--pim-device", "cpu", "--pim-window-ms", "20",
            "--pim-cache-dir", str(cache_dir)]
    if metrics is not None:
        args += ["--pim-metrics-file", str(metrics)]
    proc = subprocess.run(args, input="\n".join(reqs) + "\n", cwd=REPO,
                          env=_env(), capture_output=True, text=True,
                          timeout=600)
    assert proc.returncode == 0, proc.stderr[-2000:]
    jlines = [json.loads(l) for l in proc.stderr.splitlines()
              if l.startswith("{")]
    (summary,) = [l for l in jlines if l["type"] == "summary"]
    warm = [l for l in jlines if l["type"] == "warm_start"]
    answers = [json.loads(l) for l in proc.stdout.splitlines()]
    return summary, warm, answers


def test_second_server_warm_starts_with_zero_recompiles(tmp_path):
    """Two ``--pim-serve --pim-device cpu`` replicas share one
    ``--pim-cache-dir``: the first levelizes and persists; the second
    warm-starts -- no fresh levelize, disk hits, no errors, the same
    answers -- and the disk counters ride the Prometheus exposition."""
    reqs = [json.dumps({"op": op, "dtype": "uint8",
                        "x": [1, 2, 3], "y": [3, 2, 1]})
            for op in ("add", "mul", "sub") for _ in range(2)]
    cache_dir = tmp_path / "cache"
    metrics = tmp_path / "metrics.prom"

    s1, (w1,), a1 = _run_serve(reqs, cache_dir)
    assert s1["served"] == 6 and s1["errors"] == 0
    assert s1["cache"]["levelized"] > 0
    assert s1["cache"]["disk_writes"] > 0
    assert w1["schedules"] == 0
    assert [a["result"] for a in a1] == [[4, 4, 4]] * 2 + \
        [[3, 4, 3]] * 2 + [[254, 0, 2]] * 2

    s2, warm, a2 = _run_serve(reqs, cache_dir, metrics=metrics)
    assert s2["served"] == 6 and s2["errors"] == 0
    (w,) = warm
    assert set(w) == {"type", "dir", "schedules", "streams", "executables",
                      "skipped", "us"}
    assert w["schedules"] >= 3 and w["executables"] == 0
    assert s2["cache"]["levelized"] == 0, \
        "second replica recompiled despite a populated artifact cache"
    assert s2["cache"]["disk_hits"] > 0
    assert s2["cache"]["disk_errors"] == 0
    assert s2["kernels"]["nvcc_runs"] == 0
    assert [a["result"] for a in a2] == [a["result"] for a in a1]
    assert all(a["cached"] for a in a2)

    text = metrics.read_text()
    for name in ("pim_cache_disk_hits", "pim_cache_hits"):
        assert name in text, f"{name} missing from Prometheus exposition"


def test_ufunc_cache_dir_keyword_installs_and_uninstalls(tmp_path):
    """``pim.add(..., cache_dir=d)`` installs the cache for the call (and
    any tuned.json beside it); a call without it (and no configured
    directory) drops it again."""
    d = tmp_path / "cache"
    x = np.arange(10, dtype=np.uint8)
    try:
        assert np.array_equal(pim.add(x, x, cache_dir=str(d), **CPU),
                              x.astype(np.uint64) * 2)
        assert kops.artifact_cache().root == str(d)
        assert [e for e in os.listdir(d) if e.startswith("sched")]
        pim.add(x, x, **CPU)
        assert kops.artifact_cache() is None
    finally:
        pim._ensure_artifact_cache()
        kops.clear_compiled_cache()


# --------------------------------------------------------------------------
# parity anchors and the binary tier
# --------------------------------------------------------------------------

#: The programs whose schedule artifacts must match the reference's.
PARITY = [
    ("program_for", ("int-serial", "add", 16)),
    ("program_for", ("int-serial", "mul", 16)),
    ("program_for", ("fp-serial", "add", "fp16")),
    ("program_for", ("fp-serial", "div", "fp16")),
    ("fused_program_for", ("int-serial", (("in", "a", 8), ("in", "b", 8),
                                          ("in", "c", 8), ("mul", 0, 1),
                                          ("add", 3, 2)), None)),
]


@pytest.mark.parametrize("schedule", ["slots", "dense"])
@pytest.mark.parametrize("builder,args", PARITY,
                         ids=["add16", "mul16", "fp_add16", "fp_div16",
                              "fused_madd8"])
def test_schedule_artifacts_match_reference(tmp_path, builder, args,
                                            schedule):
    """The port's schedule artifact of a program is the reference's: the
    same file name (content key, compile key, alloc) and the same bytes
    (header with provenance, arrays, digest)."""
    ref_dir, port_dir = tmp_path / "ref", tmp_path / "port"
    try:
        rops.set_artifact_cache(RefCache(ref_dir))
        kops.set_artifact_cache(ArtifactCache(port_dir))
        rprog = getattr(rpn, builder)(*args)
        tprog = getattr(tpn, builder)(*args)
        rplan = rops.make_plan(backend="ref", schedule=schedule)
        tplan = kops.make_plan(schedule=schedule, **CPU)
        rops.clear_compiled_cache()
        kops.clear_compiled_cache()
        rops.compiled(rprog, rplan).get_schedule(rprog, rplan)
        kops.compiled(tprog, tplan).get_schedule(tprog, tplan)
    finally:
        rops.set_artifact_cache(None)
        kops.set_artifact_cache(None)
        rops.clear_compiled_cache()
        kops.clear_compiled_cache()
    names = sorted(os.listdir(ref_dir))
    assert len(names) == 1 and sorted(os.listdir(port_dir)) == names
    assert (ref_dir / names[0]).read_bytes() == \
        (port_dir / names[0]).read_bytes()


FAKE = ("Cuda compilation tools, release 12.4, V12.4.131", "12.4", "sm_90")


def test_binary_tier_round_trip_and_toolchain_skew(tmp_path):
    """A library's bytes come back bit-exact under its toolchain; another
    ``nvcc``, CUDA or capability is a plain miss (no error), and so is
    another library name."""
    c = ArtifactCache(tmp_path / "bin")
    blob = np.random.default_rng(4).bytes(4096)
    c.store_binary("slot_scan-0123456789abcdef.so", FAKE, blob,
                   {"kind": "fixed", "name": "slot_scan"})
    hit0, err0 = _c("disk_hits"), _c("disk_errors")
    assert c.load_binary("slot_scan-0123456789abcdef.so", FAKE) == blob
    assert _c("disk_hits") == hit0 + 1
    miss0 = _c("disk_misses")
    for chain in (("Cuda compilation tools, release 12.6, V12.6.20",)
                  + FAKE[1:], FAKE[:1] + ("12.6",) + FAKE[2:],
                  FAKE[:2] + ("sm_80",)):
        assert c.load_binary("slot_scan-0123456789abcdef.so", chain) is None
    assert c.load_binary("slot_scan-fedcba9876543210.so", FAKE) is None
    assert _c("disk_misses") == miss0 + 4 and _c("disk_errors") == err0
    # a header whose toolchain disagrees with its path is skew, not error
    path = c.bin_path("slot_scan-0123456789abcdef.so", FAKE)
    header, payload = c._read(path)
    header["toolchain"] = ["other", "12.4", "sm_90"]
    c._write(path, header, payload)
    assert c.load_binary("slot_scan-0123456789abcdef.so", FAKE) is None
    assert _c("disk_errors") == err0


@pytest.mark.parametrize("cut", ["flip", "truncate"])
def test_binary_tier_digest_fails_before_the_bytes_leave(tmp_path, cut):
    """A flipped byte or a truncated entry fails its digest inside
    ``load_binary``: it counts ``disk_errors``, the file is unlinked, and
    no bytes come back to be written where ``dlopen`` could read them."""
    c = ArtifactCache(tmp_path / "bin")
    blob = np.random.default_rng(5).bytes(8192)
    c.store_binary("lib-1.so", FAKE, blob)
    path = c.bin_path("lib-1.so", FAKE)
    with open(path, "r+b") as f:
        if cut == "flip":
            f.seek(4000)
            b = f.read(1)
            f.seek(4000)
            f.write(bytes([b[0] ^ 0x01]))
        else:
            f.truncate(os.path.getsize(path) // 2)
    err0 = _c("disk_errors")
    assert c.load_binary("lib-1.so", FAKE) is None
    assert _c("disk_errors") == err0 + 1 and not os.path.exists(path)


def test_binary_tier_evicts_least_recently_used(tmp_path):
    """Libraries share the size cap: a load refreshes an entry, so the
    least recently used one goes first."""
    blob = bytes(16 << 10)
    probe = ArtifactCache(tmp_path / "probe")
    probe.store_binary("lib-0.so", FAKE, blob)
    one = probe.total_bytes()
    c = ArtifactCache(tmp_path / "capped", max_bytes=int(one * 2.5))
    for i, age in enumerate((100, 50)):
        c.store_binary(f"lib-{i}.so", FAKE, blob)
        p = c.bin_path(f"lib-{i}.so", FAKE)
        t = os.path.getmtime(p) - age
        os.utime(p, (t, t))
    assert c.load_binary("lib-0.so", FAKE) == blob      # used: now newest
    c.store_binary("lib-2.so", FAKE, blob)
    assert os.path.exists(c.bin_path("lib-0.so", FAKE))
    assert not os.path.exists(c.bin_path("lib-1.so", FAKE))
    assert c.total_bytes() <= c.max_bytes


def test_publish_never_replaces_a_library(tmp_path, monkeypatch):
    """``pim_exec.publish`` writes a library under its name in the build
    directory, completely or not at all, and leaves a file already there
    (which a process may have loaded) as it is."""
    monkeypatch.setattr(pim_exec, "BUILD_DIR", tmp_path / "build")
    so = pim_exec.BUILD_DIR / "lib-abc.so"
    pim_exec.publish(b"first", so)
    inode = os.stat(so).st_ino
    pim_exec.publish(b"second", so)
    assert so.read_bytes() == b"first" and os.stat(so).st_ino == inode
    assert sorted(os.listdir(pim_exec.BUILD_DIR)) == ["lib-abc.so"]


def test_build_takes_a_library_from_the_binary_tier(tmp_path, monkeypatch):
    """With no ``nvcc`` here, ``pim_exec.build`` of a fixed kernel that the
    cache holds for this toolchain writes the cached bytes to an empty
    build directory and runs no ``nvcc``; one it does not hold raises for
    want of ``nvcc`` (it never runs a plain version instead)."""
    monkeypatch.setattr(pim_exec, "BUILD_DIR", tmp_path / "build")
    c = ArtifactCache(tmp_path / "cache")
    so = pim_exec._so_path("check_words")
    c.store_binary(so.name, pim_exec.toolchain(), b"\x7fELF-check-words",
                   {"kind": "fixed", "name": "check_words"})
    runs0 = pim_exec.COMPILES["runs"]
    try:
        kops.set_artifact_cache(c)
        assert pim_exec.build(["check_words"]) == {}
        assert so.read_bytes() == b"\x7fELF-check-words"
        assert pim_exec.COMPILES["runs"] == runs0
        if not pim_exec.shutil.which("nvcc") and \
                not os.path.exists(os.path.join(pim_exec.CUDA_HOME, "bin",
                                                "nvcc")):
            with pytest.raises(RuntimeError, match="nvcc not found"):
                pim_exec.build(["gate_serial"])
    finally:
        kops.set_artifact_cache(None)


def test_packed_format_names_the_ring_header():
    """The packed tier's record format carries the tile and window sizes
    and the hash of ``csrc/ring.cuh``: editing the header changes it."""
    fmt = pim_exec.packed_format()
    assert f"tile{pim_exec.TILE_RECORDS}" in fmt and \
        f"win{pim_exec.WINDOW}" in fmt and "ring" in fmt


def test_check_packed_refuses_streams_that_disagree():
    """A packed stream from disk must match its schedule before a kernel
    may read it: its gate count and its cells' range."""
    prog = tpn.program_for("int-serial", "add", 8)
    s = kops.program_schedule(prog, kops.make_plan(**CPU))
    p = pim_exec.pack_slots(s.a, s.b, s.out, n_cells=s.n_cells)
    pim_exec.check_packed(p, s.a.size, s.n_cells)
    with pytest.raises(ValueError, match="disagrees"):
        pim_exec.check_packed(p, s.a.size + 1, s.n_cells)
    with pytest.raises(ValueError, match="outside"):
        pim_exec.check_packed(p, s.a.size, int(s.out.max()))
