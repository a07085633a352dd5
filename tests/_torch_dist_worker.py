"""One rank of the port's multi-process CPU checks (``gloo``), started by
``tests/test_torch_distributed.py`` as

    python tests/_torch_dist_worker.py CASE RANK WORLD STORE OUT

``CASE`` is ``compression``, ``model`` or a group of :data:`FAMILIES`.

``STORE`` is a file for the group's ``FileStore`` (no port to pick),
``OUT`` a directory each rank writes its results into.  Imports nothing
of JAX: the reference's side runs in the test process.
"""

import os
import sys
from datetime import timedelta

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor

from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.configs import registry
from repro_torch.launch import sharding as SH
from repro_torch.launch.mesh import make_mesh
from repro_torch.launch.steps import make_train_step
from repro_torch.models import convert
from repro_torch.models import model as M
from repro_torch.optim import adamw
from repro_torch.optim.compression import compressed_psum, init_residuals
from repro_torch.runtime.elastic import reshard_plan


def compression(rank, world, out):
    """Each rank's row block of every input, two rounds of
    ``compressed_psum`` (the residuals fed back); the blocks back."""
    inputs = np.load(os.path.join(out, "inputs.npz"))
    grads = {}
    for k in sorted(inputs.files):
        a = inputs[k]
        rows = a.shape[0] // world
        block = torch.from_numpy(a[rank * rows:(rank + 1) * rows].copy())
        grads[k] = block.to(torch.bfloat16) if k.startswith("bf16") \
            else block
    res = init_residuals(grads)
    got = {}
    for rnd in range(2):
        red, res = compressed_psum(grads, res)
        for k in grads:
            got[f"red{rnd}_{k}"] = convert.to_numpy(red[k])
            got[f"res{rnd}_{k}"] = convert.to_numpy(res[k])
    np.savez(os.path.join(out, f"rank{rank}.npz"), **got)


def _f32_model(cfg, seed=0):
    lm = M.init_model(cfg, torch.Generator().manual_seed(seed), device="cpu")
    return convert.assemble(cfg, {n: p.detach().float()
                                  for n, p in lm.named_parameters()})


def _batch(cfg, b, s, seed=1):
    """One microbatch [1, b, ...] of the model's inputs and labels."""
    g = torch.Generator().manual_seed(seed)
    ints = lambda: torch.randint(0, cfg.vocab, (1, b, s), generator=g,
                                 dtype=torch.int32)
    out = {"labels": ints()}
    if cfg.frontend == "audio":
        out["frames"] = torch.randn((1, b, s, cfg.frontend_dim), generator=g)
    else:
        out["tokens"] = ints()
    if cfg.frontend == "vision":
        out["vision"] = torch.randn((1, b, cfg.vision_seq, cfg.frontend_dim),
                                    generator=g)
    return out


def _state(cfg, params):
    """Plain copies of the parameters and fresh moments."""
    p = convert.assemble(cfg, {n: t.detach().clone()
                               for n, t in params.named_parameters()})
    return p, adamw.init(p)


def model(rank, world, out):
    """A reduced qwen3-8b in float32 on a 2x2 mesh against the same model
    unsharded (every rank computes both): the forward's logits, two train
    steps' losses, gradient norms and parameters, a checkpoint of the
    sharded state read back plain, and a plain checkpoint restored onto
    the mesh by ``reshard_plan``."""
    cfg = registry.get("qwen3-8b").reduced()
    base = _f32_model(cfg)
    batch = _batch(cfg, 4, 16)
    mb = {k: v[0] for k, v in batch.items()}
    opt_cfg = adamw.AdamWConfig(warmup_steps=1, total_steps=4)
    got = {}

    want_logits, _ = M.forward(cfg, base, mb, remat=False)
    plain_p, plain_o = _state(cfg, base)
    step = make_train_step(cfg, 1, opt_cfg)
    for i in range(2):
        plain_p, plain_o, met = step(plain_p, plain_o, batch)
        got[f"plain_loss{i}"] = float(met["loss"])
        got[f"plain_gnorm{i}"] = float(met["grad_norm"])

    mesh = make_mesh((2, 2), ("data", "model"))
    with SH.activation_sharder(mesh):
        ps = SH.param_shardings(mesh, base)
        sbatch = SH.place_tree(batch, SH.batch_shardings(mesh, batch,
                                                         accum=True))
        smb = {k: v[0] for k, v in sbatch.items()}
        logits, _ = M.forward(cfg, SH.place_tree(base, ps), smb,
                              remat=False)
        got["logits_rel"] = float(
            (logits.full_tensor() - want_logits).abs().max()
            / want_logits.abs().max())

        p, o = _state(cfg, base)
        sp = SH.place_tree(p, ps)
        so = SH.place_tree(o, SH.opt_shardings(mesh, o, ps))
        for i in range(2):
            sp, so, met = step(sp, so, sbatch)
            got[f"mesh_loss{i}"] = float(met["loss"])
            got[f"mesh_gnorm{i}"] = float(met["grad_norm"])
        want = dict(plain_p.named_parameters())
        got["params_rel"] = max(
            float((t.detach().full_tensor() - want[n]).abs().max()
                  / want[n].abs().max().clamp(min=1e-30))
            for n, t in sp.named_parameters())

        # the sharded state saved (rank 0 writes), read back plain
        ckpt = CheckpointManager(os.path.join(out, "ckpt_mesh"))
        ckpt.save(2, {"params": sp, "opt": so})
        back = dict(ckpt.restore({"params": base, "opt": adamw.init(base)}
                                 )["params"].named_parameters())
        got["saved_sharded_exact"] = all(
            np.array_equal(convert.to_numpy(back[n]), convert.to_numpy(t))
            for n, t in sp.named_parameters())

        # the plain state restored onto the mesh
        ckpt = CheckpointManager(os.path.join(out, "ckpt_plain"))
        tree = {"params": plain_p, "opt": plain_o}
        ckpt.save(1, tree)

        def shardings(mesh, tpl):
            pshard = SH.param_shardings(mesh, tpl["params"])
            return {"params": pshard,
                    "opt": SH.opt_shardings(mesh, tpl["opt"], pshard)}

        placed = reshard_plan(ckpt, tree, mesh, shardings)
        want = shardings(mesh, tree)
        ok = int(convert.to_numpy(placed["opt"]["step"])) == \
            int(plain_o["step"])
        parts = lambda t: {"params": t["params"], "m": t["opt"]["m"],
                           "v": t["opt"]["v"]}
        saved, want = parts(tree), parts(want)
        for key, part in parts(placed).items():
            values = dict(saved[key].named_parameters())
            for n, t in part.named_parameters():
                ok &= isinstance(t, DTensor) and \
                    tuple(t.placements) == want[key][n].placements and \
                    np.array_equal(convert.to_numpy(t),
                                   convert.to_numpy(values[n]))
        got["restored_exact"] = bool(ok)
    if rank == 0:
        np.savez(os.path.join(out, "model.npz"),
                 **{k: np.asarray(v) for k, v in got.items()})


#: The other layer families, reduced, in three jobs: MoE (and MLA), the
#: recurrent two, the frontends (vision cross-attention, audio).
FAMILIES = {"moe": ("qwen3-moe-235b-a22b", "deepseek-v2-236b"),
            "recurrent": ("recurrentgemma-2b", "rwkv6-1.6b"),
            "frontends": ("llama-3.2-vision-90b", "hubert-xlarge")}


def families(group, rank, world, out):
    """Each family of ``group`` reduced, in float32, on a 2x2 mesh
    against itself unsharded: the forward's logits and one train step's
    loss.  Both run with the mesh's sharder installed, so the MoE routes
    the same groups (one a data shard)."""
    mesh = make_mesh((2, 2), ("data", "model"))
    opt_cfg = adamw.AdamWConfig(warmup_steps=1, total_steps=4)
    got = {}
    for arch in FAMILIES[group]:
        cfg = registry.get(arch).reduced()
        base = _f32_model(cfg)
        batch = _batch(cfg, 4, 16)
        mb = {k: v[0] for k, v in batch.items()}
        step = make_train_step(cfg, 1, opt_cfg)
        with SH.activation_sharder(mesh):
            want, _ = M.forward(cfg, base, mb, remat=False)
            p, o = _state(cfg, base)
            loss = float(step(p, o, batch)[2]["loss"])
            ps = SH.param_shardings(mesh, base)
            sbatch = SH.place_tree(batch, SH.batch_shardings(
                mesh, batch, accum=True))
            logits, _ = M.forward(cfg, SH.place_tree(base, ps),
                                  {k: v[0] for k, v in sbatch.items()},
                                  remat=False)
            p, o = _state(cfg, base)
            sp = SH.place_tree(p, ps)
            so = SH.place_tree(o, SH.opt_shardings(mesh, o, ps))
            mesh_loss = float(step(sp, so, sbatch)[2]["loss"])
        got[f"{arch}_logits_rel"] = float(
            (logits.full_tensor() - want).abs().max() / want.abs().max())
        got[f"{arch}_loss_rel"] = abs(mesh_loss - loss) / abs(loss)
    if rank == 0:
        np.savez(os.path.join(out, f"{group}.npz"),
                 **{k: np.asarray(v) for k, v in got.items()})


def main():
    case, rank, world, store, out = sys.argv[1:]
    rank, world = int(rank), int(world)
    dist.init_process_group(
        "gloo", store=dist.FileStore(store, world), rank=rank,
        world_size=world, timeout=timedelta(seconds=60))
    try:
        if case in FAMILIES:
            families(case, rank, world, out)
        else:
            {"compression": compression, "model": model}[case](
                rank, world, out)
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    main()
