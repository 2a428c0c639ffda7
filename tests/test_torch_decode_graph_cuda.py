"""The engine's plain decode step as a CUDA graph replay, held to the
same step run eagerly, on the card.

Marked ``cuda``: without a CUDA device every test here skips (decided
inside the fixture, never at import). On a GPU host run

    python -m pytest --noconftest -p no:cacheprovider \
        tests/test_torch_decode_graph_cuda.py

Two engines on the same weights serve the same requests in the same
order, one replaying its captured step (every shard on one card: the
default) and one made to launch the step eagerly: over more than 200
steps of requests entering and leaving the batch, on a bf16 and an int8
pool, the tokens and each token's fp32 logits are equal bit for bit;
every step after the first is a replay, and the kernel launch counters
read as the eager engine's. Reloading the weights (new storage) captures
again, and the tokens then are the new weights' eager tokens. The CPU
half (the fixed-shape step itself) is ``tests/test_torch_decode_graph.py``.
"""

import numpy as np
import pytest
import torch

from kubeflow_tpu_torch.compute import generate as t_gen
from kubeflow_tpu_torch.compute.models import transformer as tt
from kubeflow_tpu_torch.compute.ops import flash_attention as flash_ops
from kubeflow_tpu_torch.compute.ops import paged_attention as paged_ops

pytestmark = pytest.mark.cuda

CFG = tt.Config(vocab_size=512, d_model=256, n_layers=4, n_heads=4,
                n_kv_heads=2, max_seq=512, dtype="bfloat16",
                attention="flash", remat=False)
COUNTERS = ((paged_ops.paged_decode_attention, "launches"),
            (paged_ops.paged_decode_attention, "launches_i8"),
            (flash_ops.flash_attention, "launches"))


@pytest.fixture()
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _params(seed):
    return tt.init_params(CFG, torch.Generator().manual_seed(seed),
                          device="cuda")


def _requests(seed=3, n=40):
    """Prompts of 5–300 tokens with budgets of 8–64: at 8 slots, more
    than 200 decode steps with rows entering and leaving."""
    rng = np.random.default_rng(seed)
    return [(rng.integers(0, CFG.vocab_size, int(rng.integers(5, 300)))
             .tolist(), int(rng.integers(8, 65))) for _ in range(n)]


def _engine(params, graph, **kw):
    eng = t_gen.GenerationEngine(params, CFG, max_slots=8, block_size=16,
                                 max_context=512, prefix_cache=False,
                                 debug_logits=True, name="graph", **kw)
    eng._graphable = graph and eng._graphable
    return eng


def _serve(eng, reqs):
    """``reqs`` submitted while the engine thread waits, so every engine
    takes the same schedule → each request's tokens and fp32 logits, and
    the launch counters' growth."""
    before = [getattr(fn, a) for fn, a in COUNTERS]
    with eng._cond:
        handles = [eng.submit(p, max_tokens=m) for p, m in reqs]
    out = []
    for h in handles:
        toks, _ = h.result(timeout=600)
        out.append((toks, np.stack(h.logits)))
    torch.cuda.synchronize()
    return out, [getattr(fn, a) - n for (fn, a), n in zip(COUNTERS, before)]


def _same(a, b):
    return len(a) == len(b) and all(
        ta == tb and np.array_equal(la, lb)
        for (ta, la), (tb, lb) in zip(a, b))


@pytest.mark.parametrize("kv_dtype", [None, "int8"], ids=["bf16", "int8"])
def test_replay_equals_the_eager_step(dev, kv_dtype):
    params, reqs = _params(0), _requests()
    eager, graph = (_engine(params, g, kv_dtype=kv_dtype)
                    for g in (False, True))
    try:
        want, eager_launches = _serve(eager, reqs)
        got, graph_launches = _serve(graph, reqs)
    finally:
        eager.close()
        graph.close()
    assert _same(got, want)
    st = graph.stats
    assert st["decode_steps"] >= 200
    assert st["decode_steps"] == eager.stats["decode_steps"]
    assert st["decode_graph_captures"] == 1
    assert st["decode_graph_replays"] == st["decode_steps"] - 1
    assert 0 < st["decode_graph_capture_seconds_total"] \
        < st["decode_launch_seconds_total"]
    assert eager.stats["decode_graph_replays"] == 0
    assert graph_launches == eager_launches
    i8 = 1 if kv_dtype else 0
    assert graph_launches[i8] == st["decode_steps"] * CFG.n_layers
    assert graph_launches[1 - i8] == 0
    assert any(r[0] == "engine.decode.capture"
               for r in graph.trace.records())


def test_weight_reload_captures_again(dev):
    reqs = _requests(seed=5, n=12)
    new = _params(1)
    graph = _engine(_params(0), True)
    eager = _engine(new, False)
    try:
        _serve(graph, reqs)
        graph._load_weights(new)
        got, _ = _serve(graph, reqs)
        want, _ = _serve(eager, reqs)
    finally:
        graph.close()
        eager.close()
    assert _same(got, want)
    st = graph.stats
    assert st["decode_graph_captures"] == 2
    assert st["decode_graph_replays"] == st["decode_steps"] - 2
