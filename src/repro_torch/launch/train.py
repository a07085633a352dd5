"""End-to-end training entry point (example-scale and
production-shaped), on PyTorch: the port of ``repro.launch.train``.

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-8b \
        --reduced --steps 300 --batch 8 --seq 256 --ckpt-dir DIR \
        [--device cpu]

The reference's flags, plus ``--device`` (default ``cuda``: raises
without a GPU, never drops to the CPU).  Random weights from a
``torch.Generator`` seeded by ``--seed`` on the device, the train step of
:func:`~repro_torch.launch.steps.make_train_step` (remat, gradient
accumulation, AdamW), the fault-tolerant loop (resume from the newest
checkpoint, async checkpoints every ``--ckpt-every`` steps,
preemption-safe), deterministic data.  The reference's loop writes no
checkpoint at its end, so a run resumes from the last periodic one.

The reference's distribution: the launcher's ``(n_dev, 1)`` mesh over
``("data", "model")`` with the activation sharder installed
(:func:`~repro_torch.launch.sharding.launch_mesh`; ``n_dev`` the process
group's ranks: one, or torchrun's), the parameters and AdamW's moments
DTensors of ``param_shardings``/``opt_shardings`` and each batch of
``batch_shardings`` (every rank draws the same batch and keeps its
slice).  Under torchrun each rank runs this on its own device:

    torchrun --nproc-per-node 2 -m repro_torch.launch.train --reduced \
        --device cpu
"""

from __future__ import annotations

import argparse
import os
import tempfile

import torch

from ..checkpoint.manager import CheckpointManager
from ..configs import registry
from ..data.pipeline import DataConfig, DataIterator
from ..kernels.ops import _checked_device
from ..models import model as M
from ..optim import adamw
from ..runtime.train_loop import train_loop
from . import sharding as SH
from .steps import make_train_step


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-8b")
    ap.add_argument("--reduced", action="store_true",
                    help="tiny same-family config (CPU-scale)")
    ap.add_argument("--d-model", type=int, default=None)
    ap.add_argument("--layers", type=int, default=None)
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--accum", type=int, default=1)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--ckpt-dir", default=os.path.join(
        tempfile.gettempdir(), "repro_torch_ckpt"))
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="where training runs: cuda (raises without one) "
                         "or cpu")
    args = ap.parse_args(argv)

    cfg = registry.get(args.arch)
    if args.reduced:
        over = {}
        if args.d_model:
            over["d_model"] = args.d_model
        if args.layers:
            over["n_layers"] = args.layers
        cfg = cfg.reduced(**over)
    device = _checked_device(args.device)
    with SH.launch_mesh(device) as mesh:
        return _train(args, cfg, device, mesh)


def _train(args, cfg, device, mesh):
    params = M.init_model(
        cfg, torch.Generator(device=device).manual_seed(args.seed),
        device=device)
    opt = adamw.init(params)
    pshard = SH.param_shardings(mesh, params)
    oshard = SH.opt_shardings(mesh, opt, pshard)
    params, opt = SH.place_tree(params, pshard), SH.place_tree(opt, oshard)
    opt_cfg = adamw.AdamWConfig(lr=args.lr, total_steps=args.steps,
                                warmup_steps=max(args.steps // 20, 1))
    step_core = make_train_step(cfg, args.accum, opt_cfg)

    dcfg = DataConfig(
        vocab=cfg.vocab, seq_len=args.seq, global_batch=args.batch,
        seed=args.seed,
        frontend_dim=cfg.frontend_dim, vision_seq=cfg.vision_seq,
        kind={"audio": "audio", "vision": "vlm"}.get(cfg.frontend, "lm"))
    it = DataIterator(dcfg)
    ckpt = CheckpointManager(args.ckpt_dir, keep=2)

    def step_fn(state, batch):
        mb = {k: torch.from_numpy(v).to(device).reshape(
                  (args.accum, args.batch // args.accum) + v.shape[1:])
              for k, v in batch.items()}
        mb = SH.place_tree(mb, SH.batch_shardings(mesh, mb, accum=True))
        p, o, metrics = step_core(state["params"], state["opt"], mb)
        return {"params": p, "opt": o}, metrics

    state = {"params": params, "opt": opt}
    out = train_loop(step_fn=step_fn, state=state, data_iter=it, ckpt=ckpt,
                     total_steps=args.steps, ckpt_every=args.ckpt_every)
    print("final:", {k: float(v) for k, v in out["metrics"].items()})
    return out


if __name__ == "__main__":
    main()
