"""The AFMoE family (Arcee's Trinity) in the port, on the CPU: the model
(``transformer.PortConfig``: windowed and global NoPE layers, leading
dense layers, sigmoid-routed experts with a selection-only bias and a
shared expert, the attention gate, QK-norm, four norms a layer, the
scaled embedding) through ``apply`` and through the generation engine
(monolithic and chunked prefill, a prefix hit, the decode step), held
to the benchmark's plain float32 reference (``portbench/reference/
afmoe.py``) on the same seeded weights; the windowed plain reads of
K1, K2 and K3 against a dense banded mask; planted faults that the
comparison must catch; and what the engine and training refuse.

Tolerances, float32 throughout: the program and the reference sum the
same products in other orders (per-head einsums, a grouped matmul, an
online softmax over blocks) and read as equal to ~1e-6 of the logits'
size (about 1); ``LOGIT_TOL`` 1e-4 leaves a hundredfold room, and each
planted fault moves the logits by more than 1e-2. A served token's
logit may lie below the reference's best by at most ``GAP_TOL``, the
same 1e-4 (0.0 read). Windowed plain reads are held to 1e-5, a dense
banded softmax differing from the streamed one only in the order of
its sums.
"""

import dataclasses
import json
from pathlib import Path

import numpy as np
import pytest
import torch

from kubeflow_tpu_torch.compute import attention as attn_lib
from kubeflow_tpu_torch.compute import generate as t_gen
from kubeflow_tpu_torch.compute.models import transformer as tt
from kubeflow_tpu_torch.compute.ops import flash_attention as flash_ops
from kubeflow_tpu_torch.compute.ops import paged_attention as paged_ops
from portbench import compare
from portbench.inputs import afmoe_weights
from portbench.reference import afmoe as ref
from portbench.reference.model import fp32_matmuls
from portbench.runners.serve_afmoe import port_config

ROOT = Path(__file__).resolve().parents[1]
LOGIT_TOL = 1e-4
GAP_TOL = 1e-4
L, W, BS = 6, 8, 4


def _config():
    """Trinity-Mini's configuration file at a tiny size: 2 dense and 4
    expert layers (windowed, windowed, windowed, global; then windowed,
    windowed), 16 experts top-4 plus a shared one, window 8."""
    cfg = json.loads((ROOT / "portbench/configs/trinity-mini.json")
                     .read_text())
    cfg.update(hidden_size=32, num_hidden_layers=L, num_attention_heads=4,
               num_key_value_heads=2, head_dim=16, intermediate_size=48,
               moe_intermediate_size=8, num_experts=16,
               num_experts_per_tok=4, vocab_size=97, sliding_window=W,
               layer_types=["full_attention" if (i + 1) % 4 == 0
                            else "sliding_attention" for i in range(L)])
    return cfg


CFG = _config()
PORT = port_config(CFG, {"dtype": "float32", "attention": "dense",
                         "remat": False, "moe_gmm_block_m": 4}, 128)


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """These shapes are tiny: one intra-op thread runs them fastest, and
    keeps them quick beside the suite's other workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def params():
    return afmoe_weights.make(CFG, 2 ** 31 + 5, "cpu", torch.float32)


def _prompts(n=4, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, CFG["vocab_size"], int(m)).tolist()
            for m in rng.integers(36, 44, n)]


def _ref_logits(params, seqs, positions, model=None):
    with fp32_matmuls():
        return ref.served_logits(
            params, [torch.tensor(s) for s in seqs],
            [torch.as_tensor(p) for p in positions],
            model or ref.Model.of(CFG))["fp32"]


def _serve(params, config, prompts, max_tokens=6, **kw):
    eng = t_gen.GenerationEngine(params, config, max_slots=4, block_size=BS,
                                 max_context=96, device="cpu", **kw)
    try:
        hs = [eng.submit(p, max_tokens=max_tokens) for p in prompts]
        out = [(h.result(timeout=120)[0], h.logits) for h in hs]
        return out, dict(eng.stats)
    finally:
        eng.close()


def _served_gap(params, prompts, served, model=None):
    """The widest gap of a served token below the reference's best."""
    seqs = [p + t[:-1] for p, (t, _) in zip(prompts, served)]
    pos = [np.arange(len(p) - 1, len(p) - 1 + len(t))
           for p, (t, _) in zip(prompts, served)]
    lg = _ref_logits(params, seqs, pos, model)
    return max(compare.served_gap(a, torch.tensor(t))
               for a, (t, _) in zip(lg, served))


def _logit_gap(params, prompts, served, model=None):
    """Largest |program − reference| over every emitted token's fp32
    logits (the engine's ``debug_logits``)."""
    seqs = [p + t[:-1] for p, (t, _) in zip(prompts, served)]
    pos = [np.arange(len(p) - 1, len(p) - 1 + len(t))
           for p, (t, _) in zip(prompts, served)]
    lg = _ref_logits(params, seqs, pos, model)
    return max(float((torch.tensor(np.stack(rows)) - r).abs().max())
               for r, (_, rows) in zip(lg, served))


def test_the_config_is_the_published_model():
    assert [PORT.layer_window(i) for i in range(L)] == [W, W, W, 0, W, W]
    assert [PORT.layer_rope(i) for i in range(L)] == [True] * 3 + [False] \
        + [True] * 2
    full = port_config(json.loads((ROOT / "portbench/configs/"
                                   "trinity-mini.json").read_text()),
                       {}, 12544)
    assert tt.param_count(full) == 26_123_974_400     # norms included


def test_apply_is_the_reference(params):
    prompts = _prompts(2)
    toks = torch.tensor([p[:36] for p in prompts])
    got = tt.apply(params, toks, PORT)
    want = _ref_logits(params, toks.tolist(), [np.arange(36)] * 2)
    for g, w in zip(got, want):
        assert float((g - w).abs().max()) < LOGIT_TOL


def test_monolithic_prefill_and_decode_logits(params):
    prompts = _prompts()
    served, stats = _serve(params, PORT, prompts, prefix_cache=False,
                           debug_logits=True)
    assert _logit_gap(params, prompts, served) < LOGIT_TOL
    # each prefill and each decode step calls the 4 expert layers once;
    # a decode step computes every slot's rows (top-4 of 16 experts)
    calls = 4 * (stats["prefills"] + stats["decode_steps"])
    assert stats["moe_calls"] == calls
    assert 0 < stats["moe_active_experts_total"] <= 16 * calls
    assert stats["moe_padded_rows_total"] > stats["moe_assignments_total"]


@pytest.mark.parametrize("how", ["chunked", "prefix_hit"])
def test_chunked_prefill_and_prefix_hit(params, how):
    prompts = _prompts()
    kw = {"prefill_chunk": 12} if how == "chunked" else {}
    if how == "prefix_hit":      # each prompt asked again after itself
        prompts = [p for p in prompts[:2] for _ in range(2)]
    served, stats = _serve(params, PORT, prompts, **kw)
    if how == "chunked":
        assert stats["prefill_chunks"] > len(prompts)
    else:
        assert stats["prefix_hits"] >= 2
    assert _served_gap(params, prompts, served) <= GAP_TOL
    # the prefill calls' work: every prompt position computed once or
    # read from the cache; the K2 calls read what the hits skipped
    assert stats["prefill_tokens_total"] + stats["prefix_tokens_skipped"] \
        == sum(len(p) for p in prompts)
    assert stats["prefill_cached_tokens_total"] > 0
    if how == "prefix_hit":
        assert stats["prefill_cached_prefix_total"] \
            == stats["prefix_tokens_skipped"] > 0
    # the decode step's expert calls: 4 layers a step, every slot's rows
    assert stats["moe_decode_calls"] == 4 * stats["decode_steps"]
    assert stats["moe_decode_assignments_total"] \
        == stats["moe_decode_calls"] * 4 * PORT.moe_top_k
    assert 0 < stats["moe_decode_active_experts_total"] \
        < stats["moe_active_experts_total"]


def _faulty(name, monkeypatch):
    """The program with one planted fault → its config."""
    if name == "window_ignored":       # RoPE still where it was
        monkeypatch.setattr(tt.PortConfig, "layer_window", lambda s, i: 0)
        return PORT
    if name in ("gate_dropped", "qk_norm_dropped"):
        part = {"gate_dropped": "attn_gate", "qk_norm_dropped": "qk_norm"}
        monkeypatch.setitem(tt.FAMILIES, "afmoe",
                            tt.FAMILIES["afmoe"] - {part[name]})
        return PORT
    if name == "bf16":
        return dataclasses.replace(PORT, dtype="bfloat16")
    real = tt._sigmoid_router

    def biased(logits, lp, config, k):     # the bias in the weights too
        scores, _, idx = real(logits, lp, config, k)
        g = torch.gather(scores + lp["router_bias"].float(), -1, idx)
        return scores, g / g.sum(-1, keepdim=True) * config.moe_route_scale, \
            idx
    monkeypatch.setattr(tt, "_sigmoid_router", biased)
    return PORT


@pytest.mark.parametrize("fault", ["window_ignored", "bias_in_weights",
                                   "gate_dropped", "qk_norm_dropped",
                                   "bf16"])
def test_planted_faults_fail(params, fault, monkeypatch):
    prompts = _prompts(2)
    cfg = _faulty(fault, monkeypatch)
    served, _ = _serve(params, cfg, prompts, prefix_cache=False,
                       debug_logits=True)
    assert _logit_gap(params, prompts, served) > 100 * LOGIT_TOL


def _banded(q, k, v, q_pos, k_len, window):
    """Dense softmax attention, each query at ``q_pos`` over keys ``[0,
    k_len)`` within ``window`` of it: q ``[S, H, D]``, k/v ``[T, KV, D]``
    (already prescaled q)."""
    rep = q.shape[1] // k.shape[1]
    k, v = (t.repeat_interleave(rep, dim=1).double() for t in (k, v))
    s = torch.einsum("shd,thd->hst", q.double(), k)
    t = torch.arange(k.shape[0])
    ok = (t[None] <= q_pos[:, None]) & (t[None] > q_pos[:, None] - window) \
        & (t[None] < k_len)
    p = torch.softmax(s.masked_fill(~ok[None], float("-inf")), dim=-1)
    return torch.einsum("hst,thd->shd", p, v).float()


@pytest.mark.parametrize("window", [1, 5, 8, 13, 100])
def test_windowed_plain_reads_are_the_banded_mask(window):
    g = torch.Generator().manual_seed(1)
    kv, rep, D, bs, bps = 2, 4, 16, 4, 16
    pages = tuple(torch.randn((4 * bps, bs, kv, D), generator=g)
                  for _ in range(2))
    tables = torch.randperm(4 * bps, generator=g).reshape(4, bps)
    lengths = torch.tensor([1, 9, 30, 64])
    q = torch.randn((4, 1, kv * rep, D), generator=g)
    got = paged_ops.paged_decode_reference(q, pages, tables, lengths,
                                           block_size=bs, n_rep=rep,
                                           window=window)
    qs = flash_ops._prescale(q, None)
    for i in range(4):
        ctx = [pages[j][tables[i]].reshape(-1, kv, D) for j in range(2)]
        want = _banded(qs[i], *ctx, lengths[i:i + 1] - 1, int(lengths[i]),
                       window)
        assert float((got[i] - want).abs().max()) < 1e-5
    plen, S = torch.tensor([0, 7, 20, 40]), 6
    qc = torch.randn((4, S, kv * rep, D), generator=g)
    kc, vc = (torch.randn((4, S, kv, D), generator=g) for _ in range(2))
    got = paged_ops.paged_chunk_reference(qc, pages, tables, plen, kc, vc,
                                          block_size=bs, n_rep=rep,
                                          window=window)
    qs = flash_ops._prescale(qc, None)
    for i in range(4):
        p = int(plen[i])
        ctx = [torch.cat([pages[j][tables[i]].reshape(-1, kv, D)[:p], c[i]])
               for j, c in ((0, kc), (1, vc))]
        want = _banded(qs[i], *ctx, p + torch.arange(S), p + S, window)
        assert float((got[i] - want).abs().max()) < 1e-5
    qf = torch.randn((1, 30, kv * rep, D), generator=g)
    kf, vf = (torch.randn((1, 30, kv, D), generator=g) for _ in range(2))
    got, _ = flash_ops.flash_attention_reference(qf, kf, vf, True,
                                                 window=window)
    want = _banded(flash_ops._prescale(qf, None)[0], kf[0], vf[0],
                   torch.arange(30), 30, window)
    assert float((got[0] - want).abs().max()) < 1e-5
    dense = attn_lib.dense_attention(qf, attn_lib.repeat_kv(kf, rep),
                                     attn_lib.repeat_kv(vf, rep),
                                     window=window)
    assert float((dense[0] - want).abs().max()) < 1e-5


def test_the_port_config_off_is_the_config():
    """A ``PortConfig`` at its defaults computes what ``Config`` does, to
    the bit, and its dataclass fields hold JAX's and the new ones."""
    base = dict(vocab_size=64, d_model=32, n_layers=2, n_heads=4,
                n_kv_heads=2, max_seq=32, dtype="float32", remat=False,
                attention="dense")
    a, b = tt.Config(**base), tt.PortConfig(**base)
    p = tt.init_params(a, torch.Generator().manual_seed(3), device="cpu")
    toks = torch.randint(0, 64, (2, 20), generator=torch.Generator())
    assert torch.equal(tt.apply(p, toks, a), tt.apply(p, toks, b))
    names = {f.name for f in dataclasses.fields(tt.Config)}
    assert "sliding_window" not in names and not b.extended


def test_what_is_refused(params):
    with pytest.raises(ValueError, match="training does not take"):
        tt.loss_fn(params, {"tokens": torch.zeros((1, 4), dtype=torch.long),
                            "targets": torch.zeros((1, 4), dtype=torch.long)},
                   PORT)
    with pytest.raises(ValueError, match="dropless"):
        t_gen.GenerationEngine(
            tt.init_params(tt.Config(vocab_size=64, d_model=32, n_layers=1,
                                     n_heads=4, moe_experts=4,
                                     dtype="float32"), device="cpu"),
            tt.Config(vocab_size=64, d_model=32, n_layers=1, n_heads=4,
                      moe_experts=4, dtype="float32"), device="cpu")
    with pytest.raises(ValueError, match="unsharded"):
        t_gen.GenerationEngine(params, PORT, device="cpu",
                               attn_backend="gather")
    with pytest.raises(NotImplementedError, match="window"):
        q = torch.randn((1, 8, 2, 16), requires_grad=True)
        flash_ops.flash_attention(q, q, q, window=4)[0].sum().backward()


def test_the_arithmetic_of_the_new_readers():
    """``roofline/afmoe.py`` at Trinity-Mini's sizes: the parameters a
    token passes through (3.06 B, of 26.12 B), a band's pairs, and K6's
    serving bytes; and each new reader finds nothing to read in a run
    whose engine counts none of it (the parent's), so it reports
    nothing."""
    from portbench.roofline import afmoe
    sh = afmoe.Afmoe.of(json.loads((ROOT / "portbench/configs/"
                                    "trinity-mini.json").read_text()))
    assert (sh.sliding_layers, sh.global_layers) == (24, 8)
    assert sh.body_params() + sh.head_params() == 3_064_463_360
    assert afmoe.band_pairs(5, 0) == afmoe.band_pairs(5, 9) == 15
    assert afmoe.band_pairs(10, 3) == 6 + 7 * 3
    (b1, f1), (b2, f2) = afmoe.gmm_serve(sh, 10, 2)
    assert b1 == (10 * (2048 + 2048) + 2 * 2048 * 2048) * 2
    assert f2 == 2 * 10 * 1024 * 2048
    assert afmoe.decode_token_flops(sh, 100) < afmoe.decode_token_flops(
        sh, 5000)
    dense = type("Run", (), {"trace": object(), "data": {
        "stats": ({}, {}), "trace_stats": ({}, {}), "stretches": [],
        "records": []}})()
    for name in ("mfu_pct.afmoe.serve", "gmm_roofline.serve",
                 "paged_decode_window_roofline", "flash_fwd_window_roofline",
                 "moe_pad_pct.serve", "paged_chunk_roofline.serve",
                 "mfu_pct.computed.serve"):
        assert _reader(name).read(dense, H100) is None


H100 = {"platform": "gpu", "kind": "NVIDIA H100 80GB HBM3"}


def _reader(name):
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        name, ROOT / "portbench" / "metrics" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class _Trace:
    """A traced stretch of ``window_s`` seconds whose kernels of
    ``group`` took ``seconds``."""

    def __init__(self, group, seconds, window_s=4.0):
        self.group, self.secs = group, seconds
        self.t0, self.t1, self.window_s = 0.0, window_s, window_s

    def seconds_in(self, group):
        return self.secs if group == self.group else 0.0


def test_gmm_roofline_bounds_decode_and_prefill_apart():
    """Decode calls over the decoded tokens' rows, bound by bytes; a
    prefill call at its mean, bound by operations; the two added."""
    from portbench.roofline import afmoe, kernels, peaks_for
    sh = afmoe.Afmoe.of(json.loads((ROOT / "portbench/configs/"
                                    "trinity-mini.json").read_text()))
    pk = peaks_for(H100["kind"])
    zero = dict.fromkeys(_reader("gmm_roofline.serve").KEYS, 0)
    end = dict(zero, moe_calls=300 + 30, moe_decode_calls=300,
               moe_assignments_total=300 * 384 + 30 * 96000,
               moe_decode_assignments_total=300 * 384,
               moe_active_experts_total=300 * 120 + 30 * 128,
               moe_decode_active_experts_total=300 * 120,
               decode_token_slots=10 * 40)
    run = type("Run", (), {"trace": _Trace("K6 grouped_matmul", 0.5),
                           "data": {"afmoe": sh, "itemsize": 2,
                                    "trace_stats": (zero, end)}})()

    def least(rows, active):
        c = afmoe.gmm_serve(sh, rows, active)
        return kernels.bound(sum(b for b, _ in c), sum(f for _, f in c),
                             "bfloat16", pk)
    dec, pre = least(400 * 8 * 30, 300 * 120), least(96000, 128)
    assert (dec[1], pre[1]) == ("bytes", "operations")
    got = _reader("gmm_roofline.serve").read(run, H100)
    assert got == pytest.approx(100 * (dec[0] + 30 * pre[0]) / 0.5)


def test_the_prefix_readers():
    """``paged_chunk_roofline.serve`` and ``mfu_pct.computed.serve`` over
    a stretch's prefill counters (mistral's shape): K2's bytes and
    operations of the hits' suffixes, and the model FLOPs of the
    positions computed, not of the prompts."""
    from portbench.roofline import kernels, peaks_for, prefill_work
    from portbench.roofline.model_flops import Shape
    sh = Shape.of(json.loads((ROOT / "portbench/configs/mistral-7b.json")
                             .read_text()))
    pk = peaks_for(H100["kind"])
    keys = ("prefill_tokens_total", "prefill_attn_pairs_total", "prefills",
            "prefill_cached_tokens_total", "prefill_cached_prefix_total",
            "prefill_cached_attn_pairs_total")
    zero = dict.fromkeys(keys, 0)
    # one miss of 2048 and three hits of 70 after 2000 cached positions
    hit = 70 * 2000 + 70 * 71 // 2
    end = dict(zero, prefill_tokens_total=2048 + 3 * 70,
               prefill_attn_pairs_total=2048 * 2049 // 2 + 3 * hit,
               prefills=4, prefill_cached_tokens_total=3 * 70,
               prefill_cached_prefix_total=3 * 2000,
               prefill_cached_attn_pairs_total=3 * hit)
    data = {"shape": sh, "itemsize": 2, "trace_stats": (zero, end),
            "records": []}
    run = type("Run", (), {"trace": _Trace("K2 paged_chunk", 1e-3),
                           "data": data})()
    b, f = prefill_work.paged_chunk(210, 6000, 3 * hit, 32, 8, 128)
    assert b == (2 * 210 * 32 * 128 + 2 * 6210 * 8 * 128) * 2
    want = kernels.bound(b, f, "bfloat16", pk)[0] * 32 / 1e-3
    assert _reader("paged_chunk_roofline.serve").read(run, H100) \
        == pytest.approx(100 * want)
    flops = prefill_work.computed_prefill_flops(
        sh, 2048 + 210, end["prefill_attn_pairs_total"], 4)
    assert flops < 4 * 2 * sh.body_params() * 2048
    assert _reader("mfu_pct.computed.serve").read(run, H100) \
        == pytest.approx(100 * flops / (4.0 * pk[0]["bfloat16"]))


def _tiny_cell(limits, top):
    """``trinity-mini.docqa-long`` through the harness at this tiny size
    (the program in float32, 4 callers on 4 slots) → its line."""
    from portbench import harness
    mix = dict(json.loads((ROOT / "portbench/traffic/docqa-long.json")
                          .read_text()),
               prompt_tokens={"dist": "loguniform", "min": 20, "max": 60},
               output_tokens={"dist": "uniform", "min": 2, "max": 6},
               clients=4, lead_s=1, tail_s=1, warmup_requests=2,
               warmup_output_tokens=2)
    cell = json.loads((ROOT / "portbench/workloads/"
                       "trinity-mini.docqa-long.json").read_text())
    st = dict(cell, program={"dtype": "float32", "moe_gmm_block_m": 8},
              engine={"max_slots": 4, "block_size": 4, "max_context": 96,
                      "num_blocks": 128, "default_max_tokens": 8},
              wait_s=10, trace_stretch_s=1, limits=limits,
              check=dict(cell["check"], top=top))
    return harness.run_cell(harness.load_benchmark(),
                            "trinity-mini.docqa-long", 2 ** 31 + 7, 2, 0,
                            device="cpu", config=CFG, settings=st, mix=mix)


def test_the_cell_runs_on_the_cpu():
    """Every request finishes, every served token is the reference's
    best (``top`` 1, limit 0: the program is float32 here), and the
    line carries the cell's end-to-end metrics."""
    line = _tiny_cell({"off_top_share": 0.0}, 1)
    assert line["correct"] is True and line["failed"] == 0
    assert line["checks"]["off_top_share"]["value"] == 0.0
    assert set(line["metrics"]) == {"setup_s", "gen_tokens_per_s"}


def test_the_cells_check_fails_a_planted_fault(monkeypatch):
    """The runner's own comparison, at the same tiny size, with the
    window ignored: served tokens leave the reference's best, and the
    line is not correct."""
    monkeypatch.setattr(tt.PortConfig, "layer_window", lambda s, i: 0)
    line = _tiny_cell({"off_top_share": 0.0}, 1)
    assert line["failed"] == 0
    assert line["checks"]["off_top_share"]["value"] > 0.0
    assert line["correct"] is False
