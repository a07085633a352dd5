"""The port's dry run: the census of a traced step against the reference
census's own toy (``tests/test_analysis.py``), the records ``run_cell``
writes against the reference's schema, and the port's roofline reading
them."""

import dataclasses
import json

import pytest
import torch
import torch.distributed as dist
import torch.distributed._functional_collectives as funcol

from repro_torch.configs import registry
from repro_torch.launch import dryrun, roofline
from repro_torch.launch.hlo_census import Trace, census, peak_temp_bytes
from repro_torch.launch.mesh import fake_world
from repro_torch.launch.steps import SHAPES

# the keys of the reference's records (repro/launch/dryrun.py, run_cell)
SKIP_KEYS = {"arch", "shape", "mesh", "kind", "skip"}
CELL_KEYS = SKIP_KEYS | {
    "variant", "accum", "n_params", "n_params_active", "lower_s",
    "compile_s", "memory", "cost", "hlo_dot_flops", "hlo_mem_bytes",
    "collectives"}
COLLECTIVE_KINDS = {"all-reduce", "all-gather", "reduce-scatter",
                    "all-to-all", "collective-permute"}


def test_census_of_the_reference_toy():
    """``tests/test_analysis.py``'s HLO as a torch step on a fake group of
    8: a 5-trip loop of an all-gather and an 8x8 matmul, then one
    all-reduce.  The same totals: 5 x 1024 FLOPs, all-gather 5 x 256 B in
    5 ops, all-reduce 2 x 256 B in one."""
    with fake_world(8):
        group = dist.group.WORLD
        a = torch.empty(8, 8, device="meta")
        trace = Trace()
        trace.add_input(a)
        with trace:
            x = a
            for _ in range(5):
                x = funcol.all_gather_tensor(x[:1], 0, group) @ x
            ar = funcol.all_reduce(a, "sum", group)
            out = [x * 1, ar * 1]
        trace.mark_outputs(out)
    t = census(trace)
    assert t["dot_flops"] == 5 * 1024
    assert t["collectives"]["all-gather"] == {"count": 5, "bytes": 5 * 256}
    assert t["collectives"]["all-reduce"] == {"count": 1, "bytes": 2 * 256}
    assert set(t["collectives"]) == COLLECTIVE_KINDS
    assert t["mem_bytes"] > 0
    # at most the five gathered blocks and products live at once
    assert 0 < peak_temp_bytes(trace) <= 10 * 256


def _reduced(arch):
    """A reduced config under a name of its own, as the registry (and the
    roofline through it) resolves it."""
    name = f"{arch}-reduced"
    registry.ARCHS.setdefault(name, dataclasses.replace(
        registry.get(arch).reduced(), name=name))
    return name


# (arch, shape, multi_pod): a cell of every kind, both meshes, a
# sub-quadratic long-context decode, a local-attention ring whose
# positions are split over 'model' (the rule's last divisible dim), and
# two skips
CELLS = [("qwen3-8b", "train_4k", False), ("qwen3-8b", "prefill_32k", False),
         ("qwen3-8b", "decode_32k", True), ("qwen3-8b", "long_500k", False),
         ("rwkv6-1.6b", "long_500k", False),
         ("recurrentgemma-2b", "decode_32k", False),
         ("hubert-xlarge", "decode_32k", False)]


@pytest.fixture(scope="module")
def cells(tmp_path_factory):
    out = tmp_path_factory.mktemp("dryrun")
    names = [_reduced(a) for a in {a for a, _, _ in CELLS}]
    try:
        yield out, [(_reduced(a), s, mp, dryrun.run_cell(
            _reduced(a), s, mp, str(out))) for a, s, mp in CELLS]
    finally:
        for name in names:
            registry.ARCHS.pop(name)


def test_run_cell_writes_the_reference_schema(cells):
    out, recs = cells
    for name, shape, multi_pod, rec in recs:
        plan = SHAPES[shape]
        tag = f"{name}__{shape}__{'pod2' if multi_pod else 'pod1'}"
        with open(out / f"{tag}.json") as f:
            assert json.load(f) == rec
        assert rec["mesh"] == ("2x16x16" if multi_pod else "16x16")
        assert rec["kind"] == plan.kind
        if rec["skip"]:
            assert set(rec) == SKIP_KEYS
            continue
        assert set(rec) == CELL_KEYS
        assert set(rec["memory"]) == {
            "argument_size_in_bytes", "output_size_in_bytes",
            "temp_size_in_bytes", "alias_size_in_bytes"}
        assert set(rec["cost"]) == {"flops"}
        assert rec["hlo_dot_flops"] > 0 and rec["hlo_mem_bytes"] > 0
        assert set(rec["collectives"]) == COLLECTIVE_KINDS
        if plan.kind == "train":
            # every rank's gradients meet: some collective ran
            assert sum(c["count"] for c in rec["collectives"].values()) > 0
            assert rec["memory"]["alias_size_in_bytes"] > 0  # in place
    skips = {(n, s): r["skip"] for n, s, _, r in recs if r["skip"]}
    assert skips[(_reduced("qwen3-8b"), "long_500k")].startswith(
        "full attention is quadratic")
    assert skips[(_reduced("hubert-xlarge"), "decode_32k")].startswith(
        "encoder-only")
    # a cached cell is read back, not traced again
    name, shape, multi_pod, rec = recs[0]
    assert dryrun.run_cell(name, shape, multi_pod, str(out)) == rec


def test_roofline_reads_the_port_s_records(cells):
    out, recs = cells
    rows = roofline.load(str(out))
    assert {(r["arch"], r["shape"]) for r in rows} == {
        (n, s) for n, s, mp, r in recs if not r["skip"] and not mp}
    for r in rows:
        assert r["dominant"] in ("compute", "memory", "collective")
        assert r["hlo_flops_total"] > 0
    md = roofline.markdown(str(out))
    assert md.count(f"| {_reduced('qwen3-8b')} |") == 2


def test_main_runs_the_grid_and_exits_1_on_a_failure(cells, tmp_path,
                                                      capsys):
    name = _reduced("qwen3-8b")
    dryrun.main(["--arch", name, "--shape", "decode_32k", "--out",
                 str(tmp_path)])
    assert "dry-run complete" in capsys.readouterr().out
    assert [p.name for p in tmp_path.iterdir()] == [
        f"{name}__decode_32k__pod1.json"]
    with pytest.raises(SystemExit) as e:
        dryrun.main(["--arch", name, "--shape", "no_such_shape",
                     "--out", str(tmp_path)])
    assert e.value.code == 1
    assert "FAILURES:" in capsys.readouterr().out
