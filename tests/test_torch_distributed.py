"""The port's collectives and sharded model on spawned ``gloo`` ranks
(``tests/_torch_dist_worker.py``), held against the reference: the int8
error-feedback all-reduce bit for bit against the reference's 8-device
``shard_map``, and every family reduced on a 2x2 mesh against the port's
unsharded model (itself held against the reference in
``tests/test_torch_lm.py``, ``tests/test_torch_lm_families.py`` and
``tests/test_torch_train.py``).  Every rank runs under a time limit and
is killed past it."""

import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(ROOT, "tests", "_torch_dist_worker.py")
TIMEOUT = 120      # seconds for all the ranks of one job


def _env():
    src = os.path.join(ROOT, "src")
    return dict(os.environ, PYTHONPATH=src, OMP_NUM_THREADS="1",
                JAX_PLATFORMS="cpu")


def run_ranks(case: str, world: int, out) -> None:
    """Starts ``world`` ranks of ``case`` and waits for all of them; a
    rank still running after :data:`TIMEOUT` seconds fails the test, and
    every rank is gone when this returns."""
    store = os.path.join(out, "store")
    procs = [subprocess.Popen(
        [sys.executable, WORKER, case, str(r), str(world), store, str(out)],
        env=_env(), stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True) for r in range(world)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=TIMEOUT)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, p in enumerate(procs):
        assert p.returncode == 0, f"rank {r}:\n{logs[r][-3000:]}"


_REF_SCRIPT = textwrap.dedent("""
    import os, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    import jax, jax.numpy as jnp, numpy as np
    from jax.sharding import PartitionSpec as P
    from repro.optim.compression import compressed_psum, init_residuals
    shard_map = getattr(jax, "shard_map", None)
    if shard_map is None:
        from jax.experimental.shard_map import shard_map
    out = sys.argv[1]
    inputs = np.load(os.path.join(out, "inputs.npz"))
    g = {k: jnp.asarray(inputs[k]).astype(
            jnp.bfloat16 if k.startswith("bf16") else jnp.float32)
         for k in inputs.files}
    mesh = jax.make_mesh((8,), ("data",))
    agg = jax.jit(shard_map(lambda gg, rr: compressed_psum(gg, rr, "data"),
                            mesh=mesh, in_specs=(P("data"), P("data")),
                            out_specs=(P("data"), P("data"))))
    r = init_residuals(g)
    got = {}
    for rnd in range(2):
        red, r = agg(g, r)
        for k in g:
            a = np.asarray(red[k])
            got[f"red{rnd}_{k}"] = a.view(np.uint16) \\
                if a.dtype.name == "bfloat16" else a
            got[f"res{rnd}_{k}"] = np.asarray(r[k])
    np.savez(os.path.join(out, "reference.npz"), **got)
""")


def test_compressed_psum_bit_equal_to_the_reference(tmp_path):
    rng = np.random.default_rng(0)
    np.savez(tmp_path / "inputs.npz",
             # the reference test's input (tests/test_substrate.py)
             f32_arange=np.arange(64, dtype=np.float32).reshape(8, 8) / 7.0,
             f32_rand=(rng.standard_normal((16, 33)) * 3).astype(np.float32),
             bf16_rand=rng.standard_normal((8, 40)).astype(np.float32))
    script = tmp_path / "reference.py"
    script.write_text(_REF_SCRIPT)
    ref = subprocess.run([sys.executable, str(script), str(tmp_path)],
                         env=_env(), capture_output=True, text=True,
                         timeout=TIMEOUT)
    assert ref.returncode == 0, ref.stderr[-3000:]
    run_ranks("compression", 8, tmp_path)
    want = np.load(tmp_path / "reference.npz")
    ranks = [np.load(tmp_path / f"rank{r}.npz") for r in range(8)]
    assert sorted(ranks[0].files) == sorted(want.files)
    for k in want.files:
        got = np.concatenate([r[k] for r in ranks])
        assert got.dtype == want[k].dtype, k
        assert np.array_equal(got, want[k]), k
    # error feedback: the second round's residual is the first's error
    assert np.abs(want["res0_f32_rand"]).max() > 0


@pytest.fixture(scope="module")
def model_run(tmp_path_factory):
    out = tmp_path_factory.mktemp("mesh2x2")
    run_ranks("model", 4, out)
    return dict(np.load(out / "model.npz"))


# float32 throughout: only the order of the sums over shards differs
RTOL = 1e-5


def test_sharded_forward_matches_unsharded(model_run):
    assert model_run["logits_rel"] <= RTOL


@pytest.mark.parametrize("i", [0, 1])
def test_sharded_train_steps_match_unsharded(model_run, i):
    for key in ("loss", "gnorm"):
        want = model_run[f"plain_{key}{i}"]
        assert abs(model_run[f"mesh_{key}{i}"] - want) <= RTOL * abs(want)
    assert model_run["params_rel"] <= RTOL


def test_sharded_state_checkpoints_and_reshards(model_run):
    assert model_run["saved_sharded_exact"]
    assert model_run["restored_exact"]


FAMILY_GROUPS = {"moe": ("qwen3-moe-235b-a22b", "deepseek-v2-236b"),
                 "recurrent": ("recurrentgemma-2b", "rwkv6-1.6b"),
                 "frontends": ("llama-3.2-vision-90b", "hubert-xlarge")}


@pytest.mark.parametrize("group", sorted(FAMILY_GROUPS))
def test_other_families_sharded_match_unsharded(group, tmp_path):
    """MoE (the routing on each rank's own groups), MLA, RG-LRU, RWKV6,
    vision cross-attention and the audio frontend on the 2x2 mesh."""
    run_ranks(group, 4, tmp_path)
    got = np.load(tmp_path / f"{group}.npz")
    for arch in FAMILY_GROUPS[group]:
        assert got[f"{arch}_logits_rel"] <= RTOL, arch
        assert got[f"{arch}_loss_rel"] <= RTOL, arch
