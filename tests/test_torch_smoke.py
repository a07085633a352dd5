"""``chip_smoke.py``'s host-side helpers, on the CPU (the script itself
needs a GPU)."""

import importlib.util
import json
import subprocess
import sys
import time
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent


@pytest.fixture(scope="module")
def smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


_CHILD = ("import json\n"
          "for i in range(200):\n"
          "    print(json.dumps({'i': i, 'pad': 'x' * 50}), flush=True)\n")


def test_a_replicas_stdout_keeps_every_line(smoke):
    """A replica that has written many lines before the reader wakes: the
    first line and the rest together are every line, each whole (a
    buffered ``readline`` before ``communicate`` lost lines and cut one
    in two, and the warm-start phase failed on it)."""
    proc = subprocess.Popen([sys.executable, "-c", _CHILD],
                            stdout=subprocess.PIPE, bufsize=0)
    time.sleep(0.5)                      # the reader wakes late
    first, t_first, rest = smoke.first_line_then_rest(proc, 60)
    lines = (first + rest).splitlines()
    assert [json.loads(l)["i"] for l in lines] == list(range(200))
    assert t_first <= time.perf_counter()


def test_a_buffered_pipe_is_refused(smoke):
    proc = subprocess.Popen([sys.executable, "-c", _CHILD],
                            stdout=subprocess.PIPE, text=True)
    try:
        with pytest.raises(ValueError, match="bufsize=0"):
            smoke.first_line_then_rest(proc, 60)
    finally:
        proc.communicate(timeout=60)


def test_decode_bound_counts_each_cache_kind(smoke):
    """A dense model's bound is the weights, the embedding rows and the
    keys and values read and written (the formula of ``lm_phase``); a
    fixed-size state (RG-LRU, RWKV) is read and written once, whatever
    the position, and a local ring stops growing at its window."""
    import torch
    from repro_torch.configs.registry import ARCHS
    from repro_torch.models import model as M
    cfg = ARCHS["qwen3-8b"].reduced()
    lm = M.LM(cfg, device="meta")
    w = sum(p.numel() * 2 if p.dtype == torch.bfloat16 else p.numel() * 4
            for n, p in lm.named_parameters() if n != "embed")
    b, pos = 4, 9
    kv = cfg.n_layers * 2 * b * cfg.n_kv_heads * cfg.hd * 2 * (pos + 2)
    t_bytes, t_ops = smoke.decode_bound(lm, cfg, b, pos)
    assert t_bytes == (w + b * cfg.d_model * 2 + kv) / \
        smoke.HBM_BYTES_PER_S * 1e3
    assert smoke.decode_bound_ms(lm, cfg, b, pos) == max(t_bytes, t_ops)
    for name, kind in (("recurrentgemma-2b", "recurrent"),
                       ("rwkv6-1.6b", "rwkv")):
        cfg = ARCHS[name].reduced()
        c = M.init_cache(cfg, kind, b, 8, device="meta")
        held = sum(t.numel() * t.element_size() for t in c.values())
        assert smoke.cache_bytes(cfg, kind, b, 3) == \
            smoke.cache_bytes(cfg, kind, b, 300) == 2 * held
    cfg = ARCHS["recurrentgemma-2b"].reduced()
    assert smoke.cache_bytes(cfg, "local", b, cfg.window + 5) == \
        smoke.cache_bytes(cfg, "local", b, cfg.window - 1) > \
        smoke.cache_bytes(cfg, "local", b, 0)
    assert smoke.cache_bytes(cfg, "cross", b, 5) == 0


def test_grow_caches_grows_only_a_sequence_axis(smoke):
    import torch
    from repro_torch.configs.registry import ARCHS
    from repro_torch.models import model as M
    for name in ("recurrentgemma-2b", "deepseek-v2-236b", "rwkv6-1.6b",
                 "llama-3.2-vision-90b"):
        cfg = ARCHS[name].reduced()
        caches = M.init_caches(cfg, 2, 6, device="cpu")
        grown = smoke.grow_caches(caches, 3)
        for c, g in zip(caches, grown):
            n = M.seq_len(c)
            assert M.seq_len(g) == (None if n is None else n + 3)
            for k in c:
                want = list(c[k].shape)
                if n is not None:
                    want[1] += 3
                assert list(g[k].shape) == want
                assert torch.equal(g[k][:, :c[k].shape[1]], c[k])


def test_train_bound_of_the_twelve_layer_cut(smoke):
    """qwen3-8b at 12 of 36 layers, batch 8 x seq 256: 3,560,020,992
    parameters, 622,329,856 of them in the embedding; operations 6 x N x
    tokens at 989 TFLOP/s (about 36.5 ms), bytes 38 B a parameter at
    3.35 TB/s (about 40.4 ms).  A layer, the embedding with the head and
    the final norm add up to the parameters."""
    assert 12 * 192_946_432 + 1_244_659_712 + 4096 == 3_560_020_992
    ops, nbytes = smoke.train_bound_ms(3_560_020_992, 622_329_856, 8 * 256)
    assert ops == pytest.approx(6 * 2_937_691_136 * 2048 / 989e12 * 1e3)
    assert 36.4 < ops < 36.6 and 40.3 < nbytes < 40.5


def test_train_checks_run_on_the_cpu(smoke, tmp_path):
    """The card checks' helpers with the CPU in the card's place: one
    step against itself is exact, and the resume is bit-identical."""
    errs = smoke.train_card_against_cpu("qwen3-8b", "cpu")
    assert errs == {"loss": 0.0, "grad_norm": 0.0, "m": 0.0, "v": 0.0,
                    "params": 0.0, "flips": 0}
    assert smoke.train_resume_check(tmp_path, "cpu")
