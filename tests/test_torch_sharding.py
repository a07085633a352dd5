"""The port's meshes and sharding rules against the reference's: the
elastic mesh choice, every leaf's spec for all ten architectures at full
size on both production meshes, and the blocks each mesh coordinate
holds against jax's ``devices_indices_map``."""

import json
import os
import subprocess
import sys
import textwrap

import jax
import pytest
from jax.sharding import AbstractMesh

from repro.configs import registry as ref_registry
from repro.launch import sharding as ref_sh
from repro.launch.steps import SHAPES as REF_SHAPES
from repro.launch.steps import batch_specs as ref_batch_specs
from repro.models import model as ref_model
from repro.optim import adamw as ref_adamw
from repro.runtime.elastic import choose_mesh as ref_choose_mesh
from repro_torch.configs import registry
from repro_torch.launch import sharding as SH
from repro_torch.launch.mesh import (axis_size, dp_axes, fake_world,
                                     make_production_mesh)
from repro_torch.launch.steps import SHAPES, batch_specs
from repro_torch.models import convert
from repro_torch.models import model as M
from repro_torch.optim import adamw
from repro_torch.runtime.elastic import choose_mesh

ARCHS = sorted(registry.ARCHS)
MESHES = [False, True]
_MESH_IDS = ["16x16", "2x16x16"]


@pytest.mark.parametrize("divisors", [[32, 8], [8], [64, 40], [28, 4, 12],
                                      [1], [96]])
def test_choose_mesh_equals_the_reference(divisors):
    for n in range(1, 601):
        assert choose_mesh(n, model_divisors=divisors) == \
            ref_choose_mesh(n, model_divisors=divisors), n


def test_elastic_mesh_respects_divisors():
    for n in (256, 255, 128, 96, 17):
        data, model = choose_mesh(n, model_divisors=[32, 8])
        assert 32 % model == 0 and 8 % model == 0
        assert data * model <= n
    assert choose_mesh(256, model_divisors=[32, 8]) == (32, 8)


def _ref_mesh(multi_pod):
    if multi_pod:
        return AbstractMesh((2, 16, 16), ("pod", "data", "model"))
    return AbstractMesh((16, 16), ("data", "model"))


def _world(multi_pod):
    """The fake group of a production mesh's ranks."""
    return fake_world(512 if multi_pod else 256)


def _ref_specs(tree):
    return {tuple(_key(k) for k in path): tuple(s.spec)
            for path, s in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _key(k):
    return k.key if hasattr(k, "key") else k.idx


def _port_param_specs(cfg, shardings, prefix=()):
    """The port's {name: sharding} as the reference's {path: spec}: a
    group's layers stack on a leading replicated axis, and all of them
    must agree."""
    out = {}
    for name, sh in shardings.items():
        path, g = convert._reference_path(cfg, name)
        spec = (None,) + tuple(sh.spec) if g is not None else tuple(sh.spec)
        key = prefix + path
        assert out.setdefault(key, spec) == spec, (name, out[key], spec)
    return out


@pytest.mark.parametrize("multi_pod", MESHES, ids=_MESH_IDS)
@pytest.mark.parametrize("arch", ARCHS)
def test_param_and_opt_specs_equal_the_reference(arch, multi_pod):
    rcfg = ref_registry.get(arch)
    cfg = registry.get(arch)
    rmesh = _ref_mesh(multi_pod)
    rparams = jax.eval_shape(
        lambda: ref_model.init_model(rcfg, jax.random.PRNGKey(0)))
    params = M.LM(cfg, device="meta")
    with _world(multi_pod):
        mesh = make_production_mesh(multi_pod=multi_pod)
        assert tuple(mesh.mesh_dim_names) == tuple(rmesh.axis_names)
        for serve in (False, True):
            for embed_d in (False, True):
                want = _ref_specs(ref_sh.param_shardings(
                    rmesh, rparams, serve=serve, embed_d=embed_d))
                ps = SH.param_shardings(mesh, params, serve=serve,
                                        embed_d=embed_d)
                assert _port_param_specs(cfg, ps) == want, (serve, embed_d)
        ropt = jax.eval_shape(lambda: ref_adamw.init(rparams))
        want = _ref_specs(ref_sh.opt_shardings(
            rmesh, ropt, ref_sh.param_shardings(rmesh, rparams)))
        osh = SH.opt_shardings(mesh, adamw.init(params), ps)
        got = {("step",): tuple(osh["step"].spec)}
        for k in ("m", "v"):
            got.update(_port_param_specs(cfg, osh[k], (k,)))
        assert got == want


@pytest.mark.parametrize("multi_pod", MESHES, ids=_MESH_IDS)
@pytest.mark.parametrize("arch", ARCHS)
def test_batch_and_cache_specs_equal_the_reference(arch, multi_pod):
    rcfg = ref_registry.get(arch)
    cfg = registry.get(arch)
    rmesh = _ref_mesh(multi_pod)
    with _world(multi_pod):
        mesh = make_production_mesh(multi_pod=multi_pod)
        for name, plan in SHAPES.items():
            rb = ref_batch_specs(rcfg, REF_SHAPES[name])
            b = batch_specs(cfg, plan)
            for accum in (False, True):
                want = _ref_specs(ref_sh.batch_shardings(rmesh, rb,
                                                         accum=accum))
                got = {(k,): tuple(s.spec) for k, s in
                       SH.batch_shardings(mesh, b, accum=accum).items()}
                assert got == want, (name, accum)
            if plan.kind != "decode" or cfg.encoder_only:
                continue
            rc = jax.eval_shape(lambda: ref_model.init_caches(
                rcfg, plan.global_batch, plan.seq))
            caches = M.init_caches(cfg, plan.global_batch, plan.seq,
                                   device="meta")
            base, width = len(cfg.prefix), len(cfg.group)
            for seq_shard in (False, True):
                want = _ref_specs(ref_sh.cache_shardings(
                    rmesh, rc, batch=plan.global_batch, seq_shard=seq_shard))
                got = {}
                for i, layer in enumerate(SH.cache_shardings(
                        mesh, caches, batch=plan.global_batch,
                        seq_shard=seq_shard)):
                    for key, s in layer.items():
                        if i < base:
                            got[("prefix", i, key)] = tuple(s.spec)
                            continue
                        path = ("groups", (i - base) % width, key)
                        spec = (None,) + tuple(s.spec)
                        assert got.setdefault(path, spec) == spec
                assert got == want, (name, seq_shard)


def test_specs_become_placements():
    from torch.distributed.tensor import Replicate, Shard
    with fake_world(8):
        from repro_torch.launch.mesh import make_mesh
        mesh = make_mesh((2, 4), ("data", "model"))
        assert dp_axes(mesh) == ("data",)
        assert axis_size(mesh, ("data", "model")) == 8
        assert SH.placements(mesh, SH.P(None, ("data", "model"))) == \
            (Shard(1), Shard(1))
        assert SH.placements(mesh, SH.P("model", "data")) == \
            (Shard(1), Shard(0))
        assert SH.placements(mesh, SH.P()) == (Replicate(), Replicate())
        assert SH.P(("data",), None) == SH.P("data", None)
        with pytest.raises(NotImplementedError):
            SH.placements(mesh, SH.P(("model", "data")))


# ---------------------------------------------------------------- blocks

_CASES = [
    # (mesh shape, axis names, global shape, spec)
    ((2, 4), ("data", "model"), (16, 64), (None, ("data", "model"))),
    ((2, 4), ("data", "model"), (64, 16), ("model", "data")),
    ((2, 4), ("data", "model"), (32, 64), ("data", "model")),
    ((2, 4), ("data", "model"), (8, 16, 4), ("model", "data", None)),
    ((2, 4), ("data", "model"), (4, 8, 32, 16), ("data", None, None,
                                                 "model")),
    ((2, 2, 2), ("pod", "data", "model"), (16, 8), (("pod", "data"),
                                                   "model")),
    ((2, 2, 2), ("pod", "data", "model"), (8, 32), (None,
                                                   ("pod", "data", "model"))),
]

_BLOCKS_SCRIPT = textwrap.dedent("""
    import os, sys, json
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    import jax, numpy as np
    from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
    out = []
    for mshape, names, shape, spec in json.loads(sys.argv[1]):
        devs = np.array(jax.devices()[:8]).reshape(mshape)
        mesh = Mesh(devs, tuple(names))
        spec = [tuple(a) if isinstance(a, list) else a for a in spec]
        idx = NamedSharding(mesh, P(*spec)).devices_indices_map(
            tuple(shape))
        blocks = {}
        for coord in np.ndindex(*mshape):
            sl = idx[devs[coord]]
            blocks[",".join(map(str, coord))] = [
                [s.start or 0, s.stop if s.stop is not None else n]
                for s, n in zip(sl, shape)]
        out.append(blocks)
    print(json.dumps(out))
""")


@pytest.fixture(scope="module")
def ref_blocks(tmp_path_factory):
    script = tmp_path_factory.mktemp("blocks") / "blocks.py"
    script.write_text(_BLOCKS_SCRIPT)
    env = dict(os.environ, PYTHONPATH="src", JAX_PLATFORMS="cpu")
    out = subprocess.run([sys.executable, str(script), json.dumps(_CASES)],
                         env=env, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0, out.stderr[-2000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


def test_local_blocks_equal_the_references_devices(ref_blocks):
    """Rank r of the port's mesh holds, of every case, the block that the
    reference's device at the same mesh coordinate holds."""
    import numpy as np
    from torch.distributed.tensor._utils import \
        compute_local_shape_and_global_offset
    from repro_torch.launch.mesh import make_mesh
    for (mshape, names, shape, spec), want in zip(_CASES, ref_blocks):
        for rank, coord in enumerate(np.ndindex(*mshape)):
            with fake_world(8, rank=rank):
                mesh = make_mesh(mshape, names)
                assert tuple(mesh.get_coordinate()) == coord
                local, offset = compute_local_shape_and_global_offset(
                    shape, mesh, SH.placements(mesh, SH.P(*spec)))
            got = [[o, o + n] for o, n in zip(offset, local)]
            assert got == want[",".join(map(str, coord))], \
                (mshape, shape, spec, coord)


def test_checkpoint_reshard_on_restore(tmp_path):
    """``tests/test_substrate.py::test_checkpoint_reshard_on_restore`` on
    the port: a tree saved plain comes back through
    ``restore(..., shardings=)`` as DTensors of those shardings on the
    running mesh (one rank, ``gloo``), the same values."""
    import torch
    from repro_torch.checkpoint.manager import CheckpointManager
    ckpt = CheckpointManager(str(tmp_path))
    tree = {"w": torch.arange(64, dtype=torch.float32).reshape(8, 8)}
    ckpt.save(1, tree)
    with SH.launch_mesh("cpu") as mesh:
        sh = {"w": SH.NamedSharding(mesh, SH.P("data", None))}
        out = ckpt.restore(tree, shardings=sh)
        assert isinstance(out["w"], SH.DTensor)
        assert tuple(out["w"].placements) == sh["w"].placements
        assert out["w"].device_mesh == mesh
        assert torch.equal(out["w"].full_tensor(), tree["w"])


def test_mesh_for_takes_the_first_ranks_of_choose_mesh():
    """``elastic.mesh_for``: the (data, model) grid ``choose_mesh`` picks,
    over the group's first ``data * model`` ranks, data-major."""
    from repro_torch.runtime.elastic import mesh_for
    with fake_world(8):
        mesh = mesh_for(8, [4, 8])
        assert tuple(mesh.mesh_dim_names) == ("data", "model")
        assert tuple(mesh.shape) == choose_mesh(8, model_divisors=[4, 8])
        assert mesh.mesh.flatten().tolist() == list(range(8))
        sub = mesh_for(6, [4])              # 6 ranks: model 2, data 3
        assert tuple(sub.shape) == (3, 2)
        assert sub.mesh.flatten().tolist() == list(range(6))


def test_meshes_default_to_the_card():
    """As ``jax.make_mesh`` takes the default backend's devices, the port's
    mesh constructors make a one-rank group on the card unless
    ``device="cpu"`` says otherwise (a running group decides for itself:
    ``fake_world`` above, ``gloo`` workers)."""
    import inspect
    from repro_torch.launch import mesh as MS
    for fn in (MS.make_mesh, MS.make_smoke_mesh, SH.launch_mesh.__wrapped__):
        assert inspect.signature(fn).parameters["device"].default == "cuda"
    with fake_world(1):
        assert MS.make_smoke_mesh().device_type == "cpu"
