"""The port's activation-sharding points against the reference's: a
recording sharder installed in both packages sees the same (tag, shape)
sequence over a forward, a prefill and a decode step of every family.

The reference scans its groups and traces a scan's body once; each model
here has one group (the prefix and ``cfg.group`` once), so the port's
loop over the groups runs its body once too."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import ARCHS as RARCHS
from repro.models import layers as RL
from repro.models import model as RM
from repro_torch.configs.registry import ARCHS
from repro_torch.models import convert
from repro_torch.models import layers as L
from repro_torch.models import model as M

FAMILIES = ["qwen3-8b", "qwen3-moe-235b-a22b", "deepseek-v2-236b",
            "recurrentgemma-2b", "rwkv6-1.6b", "llama-3.2-vision-90b",
            "hubert-xlarge"]
B, S = 2, 8


def _one_group(archs, name):
    cfg = archs[name]
    return cfg.reduced(n_layers=len(cfg.prefix) + len(cfg.group))


class _Recorder:
    def __init__(self):
        self.seen = []

    def __call__(self, tag, x):
        self.seen.append((tag, tuple(x.shape)))
        return x


@pytest.fixture
def recorders():
    ref, port = _Recorder(), _Recorder()
    RM.set_activation_sharder(ref)
    M.set_activation_sharder(port)
    try:
        yield ref, port
    finally:
        RM.set_activation_sharder(lambda tag, x: x)
        M.set_activation_sharder(lambda tag, x: x)


def _take(rec):
    seen, rec.seen = rec.seen, []
    return seen


@pytest.mark.parametrize("name", FAMILIES)
def test_sharding_points_match_the_reference(name, recorders):
    ref, port = recorders
    rcfg, cfg = _one_group(RARCHS, name), _one_group(ARCHS, name)
    assert rcfg.n_groups == cfg.n_groups == 1
    rp = RM.init_model(rcfg, jax.random.PRNGKey(0))
    lm = convert.from_reference(cfg, jax.tree.map(np.asarray, rp),
                                device="cpu")
    rng = np.random.default_rng(0)
    toks = rng.integers(0, cfg.vocab, (B, S)).astype(np.int32)
    rbatch, batch = {}, {}
    if cfg.frontend == "audio":
        frames = rng.standard_normal((B, S, cfg.frontend_dim), np.float32)
        rbatch["frames"], batch["frames"] = jnp.asarray(frames), \
            torch.from_numpy(frames)
    else:
        rbatch["tokens"], batch["tokens"] = jnp.asarray(toks), \
            torch.from_numpy(toks)
    vis = None
    if cfg.frontend == "vision":
        vis = rng.standard_normal((B, cfg.vision_seq, cfg.frontend_dim),
                                  np.float32)
        rbatch["vision"], batch["vision"] = jnp.asarray(vis), \
            torch.from_numpy(vis)

    RM.forward(rcfg, rp, rbatch, remat=False)
    M.forward(cfg, lm, batch, remat=False)
    want = _take(ref)
    assert want and _take(port) == want
    if cfg.encoder_only:
        return
    RM.prefill(rcfg, rp, rbatch)
    M.prefill(cfg, lm, batch)
    assert _take(port) == _take(ref)
    RM.decode_step(rcfg, rp, RM.init_caches(rcfg, B, S),
                   jnp.asarray(toks[:, 0]), jnp.int32(0),
                   vision=None if vis is None else jnp.asarray(vis))
    M.decode_step(cfg, lm, M.init_caches(cfg, B, S, device="cpu"),
                  torch.from_numpy(toks[:, 0]), 0,
                  vision=None if vis is None else torch.from_numpy(vis))
    want = _take(ref)
    assert want and _take(port) == want


@pytest.mark.parametrize("multi_pod", [False, True])
def test_installing_sets_the_moe_groups_to_the_data_axes(multi_pod):
    """``install_activation_sharder`` sets the MoE dispatch groups to the
    data-parallel size, in both packages alike."""
    from jax.sharding import AbstractMesh
    from repro.launch import sharding as RSH
    from repro_torch.launch import sharding as SH
    from repro_torch.launch.mesh import fake_world, make_mesh
    shape = (2, 2, 4) if multi_pod else (2, 4)
    names = ("pod", "data", "model") if multi_pod else ("data", "model")
    try:
        RSH.install_activation_sharder(AbstractMesh(shape, names))
        with fake_world(int(np.prod(shape))), \
                SH.activation_sharder(make_mesh(shape, names)):
            assert L._MOE_GROUPS == RL._MOE_GROUPS == \
                int(np.prod(shape[:-1]))
        assert L._MOE_GROUPS == 1        # the one before comes back
    finally:
        RM.set_activation_sharder(lambda tag, x: x)
        RL.set_moe_groups(1)
