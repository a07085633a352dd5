"""Multi-pod dry run: trace every (arch x shape x mesh) cell on meta
tensors; the port of ``repro.launch.dryrun``.

Proves the distribution config is coherent without hardware: sharding
mismatches, an operation DTensor cannot distribute and unsupported
collectives all surface here.  One process plays rank 0 of a fake process
group as large as the mesh (:func:`~repro_torch.launch.mesh.fake_world`:
256 ranks for 16x16, 512 for 2x16x16), every parameter, optimizer moment,
batch and cache tensor is a DTensor of its sharding
(:mod:`~repro_torch.launch.sharding`) over a local shard on the ``meta``
device, and the train, prefill or decode step runs once at full size
under a :class:`~repro_torch.launch.hlo_census.Trace`, which records the
per-device ATen ops and collectives; nothing is allocated.  Emits one
JSON record per cell in the reference's schema, which
:mod:`~repro_torch.launch.roofline` reads:

* ``lower_s``: seconds to trace the step; ``compile_s``: seconds to count
  over the trace (there is no compiler stage);
* ``memory``: ``argument_size_in_bytes`` (the inputs' local shards),
  ``output_size_in_bytes``, ``alias_size_in_bytes`` (outputs that are
  inputs updated in place: the reference's donated buffers) and
  ``temp_size_in_bytes`` (the trace's peak of live intermediates,
  :func:`~repro_torch.launch.hlo_census.peak_temp_bytes`); XLA's
  ``generated_code_size_in_bytes`` has no counterpart and is left out;
* ``cost``: ``flops``, per device, by the formulas
  ``torch.utils.flop_counter.FlopCounterMode`` counts with, over the
  traced ops; XLA's ``bytes accessed`` has no counterpart and is left
  out;
* ``hlo_dot_flops``, ``hlo_mem_bytes``, ``collectives``: the census of
  the trace (:mod:`~repro_torch.launch.hlo_census`), per device.

Usage:
    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen3-8b \
        --shape train_4k [--multi-pod] [--all] [--out results/dryrun]
"""

from __future__ import annotations

import argparse
import json
import os
import time
import traceback
from typing import Dict, List

import torch
from torch.distributed.tensor import DTensor
from torch.distributed.tensor._utils import \
    compute_local_shape_and_global_offset

from ..configs import registry
from . import sharding as SH
from .hlo_census import Trace, census, peak_temp_bytes
from .mesh import fake_world, make_production_mesh
from .roofline import CHIPS
from .steps import (SHAPES, accum_for, cell_skip_reason, input_specs,
                    make_decode_step, make_prefill_step, make_train_step)


def _meta_input(trace: Trace):
    """``place`` for :func:`~repro_torch.launch.sharding.place_tree`: a
    DTensor of the sharding over a local shard on ``meta``, the shard an
    input of ``trace``."""
    def place(t: torch.Tensor, sharding: SH.NamedSharding) -> DTensor:
        pl = sharding.placements
        shape, _ = compute_local_shape_and_global_offset(
            t.shape, sharding.mesh, pl)
        local = torch.empty(shape, dtype=t.dtype, device="meta")
        trace.add_input(local)
        return DTensor.from_local(local, sharding.mesh, pl, run_check=False,
                                  shape=t.shape, stride=t.stride())
    return place


def _locals(tree) -> List[torch.Tensor]:
    if isinstance(tree, torch.nn.Module):
        tree = dict(tree.named_parameters())
    if isinstance(tree, dict):
        return [t for k in tree for t in _locals(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [t for v in tree for t in _locals(v)]
    return [tree.to_local() if isinstance(tree, DTensor) else tree]


def _memory(trace: Trace) -> Dict[str, int]:
    nb = trace.nbytes
    given = {trace.root[v] for v in trace.inputs}
    return {
        "argument_size_in_bytes": sum(nb[v] for v in trace.inputs),
        "output_size_in_bytes": sum(nb[v] for v in set(trace.outputs)),
        "temp_size_in_bytes": peak_temp_bytes(trace),
        "alias_size_in_bytes": sum(nb[v] for v in set(trace.outputs)
                                   if trace.root[v] in given),
    }


def run_cell(arch: str, shape_name: str, multi_pod: bool, out_dir: str,
             force: bool = False, serve_tp: bool = False,
             embed_d: bool = False, fused_accum: bool = False,
             accum_override: int = 0, variant: str = "",
             seq_cache: bool = False):
    tag = f"{arch}__{shape_name}__{'pod2' if multi_pod else 'pod1'}"
    if variant:
        tag += f"__{variant}"
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, tag + ".json")
    if os.path.exists(path) and not force:
        print(f"[skip-cached] {tag}")
        with open(path) as f:
            return json.load(f)

    cfg = registry.get(arch)
    plan = SHAPES[shape_name]
    skip = cell_skip_reason(cfg, plan)
    mesh_name = "2x16x16" if multi_pod else "16x16"
    rec = {"arch": arch, "shape": shape_name, "mesh": mesh_name,
           "kind": plan.kind, "skip": skip}
    if skip:
        with open(path, "w") as f:
            json.dump(rec, f, indent=1)
        print(f"[skip] {tag}: {skip}")
        return rec

    accum = accum_override or accum_for(cfg, plan)
    with fake_world(CHIPS[mesh_name]):
        t0 = time.time()
        mesh = make_production_mesh(multi_pod=multi_pod)
        specs = input_specs(cfg, plan, accum=accum)
        pshard = SH.param_shardings(
            mesh, specs["params"],
            serve=serve_tp and plan.kind != "train", embed_d=embed_d)
        bshard = SH.batch_shardings(mesh, specs["batch"],
                                    accum=(plan.kind == "train"))
        trace = Trace()
        place = lambda tree, sh: SH.place_tree(tree, sh, _meta_input(trace))
        params = place(specs["params"], pshard)
        if plan.kind == "train":
            opt = place(specs["opt"],
                        SH.opt_shardings(mesh, specs["opt"], pshard))
            batch = place(specs["batch"], bshard)
            fn = make_train_step(cfg, accum, fused_accum=fused_accum,
                                 acc_dtype=torch.bfloat16 if os.environ.get(
                                     "REPRO_BF16_ACC") else torch.float32)
            step = lambda: fn(params, opt, batch)
        elif plan.kind == "prefill":
            batch = place(specs["batch"], bshard)
            fn = make_prefill_step(cfg)
            step = lambda: fn(params, batch)
        else:
            cshard = SH.cache_shardings(mesh, specs["caches"],
                                        batch=plan.global_batch,
                                        seq_shard=seq_cache)
            caches = place(specs["caches"], cshard)
            batch = place({k: v for k, v in specs["batch"].items()
                           if k != "pos"}, bshard)
            batch["pos"] = plan.seq - 1      # the port's host position
            fn = make_decode_step(cfg)
            step = lambda: fn(params, caches, batch)

        with SH.activation_sharder(mesh), trace:
            out = step()
        trace.mark_outputs(_locals(out))
        t_lower = time.time() - t0
        cen = census(trace)
        mem = _memory(trace)
        cost = {"flops": float(sum(n.flops for n in trace.nodes))}
        t_compile = time.time() - t0 - t_lower

    rec.update({
        "variant": variant or "baseline",
        "accum": accum,
        "n_params": cfg.n_params, "n_params_active": cfg.n_params_active,
        "lower_s": round(t_lower, 1), "compile_s": round(t_compile, 1),
        "memory": mem, "cost": cost,
        "hlo_dot_flops": cen["dot_flops"],          # unrolled, per device
        "hlo_mem_bytes": cen["mem_bytes"],          # proxy (no fusion)
        "collectives": cen["collectives"],          # unrolled, per device
    })
    with open(path, "w") as f:
        json.dump(rec, f, indent=1)
    print(f"[ok] {tag} trace={t_lower:.1f}s count={t_compile:.1f}s "
          f"flops={cost['flops']:.3g} ops={len(trace.nodes)}")
    return rec


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--out", default="results/dryrun")
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--serve-tp", action="store_true")
    ap.add_argument("--embed-d", action="store_true")
    ap.add_argument("--fused-accum", action="store_true")
    ap.add_argument("--accum", type=int, default=0)
    ap.add_argument("--variant", default="")
    ap.add_argument("--seq-cache", action="store_true")
    args = ap.parse_args(argv)

    archs = list(registry.ARCHS) if args.all or not args.arch \
        else [args.arch]
    shapes = list(SHAPES) if args.all or not args.shape else [args.shape]
    meshes = [False, True] if (args.both_meshes or args.all) \
        else [args.multi_pod]
    failures = []
    for arch in archs:
        for shape in shapes:
            for mp in meshes:
                try:
                    run_cell(arch, shape, mp, args.out, force=args.force,
                             serve_tp=args.serve_tp, embed_d=args.embed_d,
                             fused_accum=args.fused_accum,
                             accum_override=args.accum,
                             variant=args.variant,
                             seq_cache=args.seq_cache)
                except Exception:
                    failures.append((arch, shape, mp))
                    traceback.print_exc()
    if failures:
        print("FAILURES:", failures)
        raise SystemExit(1)
    print("dry-run complete")


if __name__ == "__main__":
    main()
