"""``chip_smoke.py``'s build report: the kernels' names read from the
symbols ``nvcc -Xptxas -v`` prints on the card, and their registers and
spills. CPU only: the log is a fixed string in ptxas's format. Also the
pure checks of the phases (among them the unary predict phases':
occupancy and coalescing, the eviction's memory drop, the canary split
and the answer formats)."""

import numpy as np
import pytest

import chip_smoke

NS = "_ZN45_GLOBAL__N__5e7a0f37_12_flash_bwd_cu_3e1c50db"


@pytest.mark.parametrize("symbol,name", [
    (NS + "23flash_bwd_dkv_tc_kernelILi128EEEvPK13__nv_bfloat16S3_S3_S3_"
     "PKfS5_PS1_S6_iiiiiif", "flash_bwd_dkv_tc_kernel<128>"),
    (NS + "19flash_bwd_dq_kernelI13__nv_bfloat16Li64EEEvPKT_S4_S4_S4_PKfS6_"
     "PS2_iiiiif", "flash_bwd_dq_kernel<bf16, 64>"),
    (NS + "20flash_bwd_dkv_kernelIfLi32EEEvPKT_S3_S3_S3_PKfS5_PS1_S6_iiiiif",
     "flash_bwd_dkv_kernel<float, 32>"),
    ("_ZN12_GLOBAL__N_113decode_kernelI13__nv_bfloat16aLi128EEEvv",
     "decode_kernel<bf16, int8, 128>"),
    ("_ZN12_GLOBAL__N_16kernelEv", "kernel"),
    ("_ZN12_GLOBAL__N_16kernelILb1EEEvv", "kernel<true>"),
    ("_ZN12_GLOBAL__N_16kernelILb0ELi64EEEvv", "kernel<false, 64>"),
    ("_ZN12_GLOBAL__N_16kernelILl1EEEvv", "_ZN12_GLOBAL__N_16kernelILl1EEEvv"),
    ("kubeflow_flash_fwd", "kubeflow_flash_fwd"),
])
def test_demangle_names_the_kernel_and_its_template_arguments(symbol, name):
    assert chip_smoke._demangle(symbol) == name


def test_ptxas_entries_reads_registers_and_spills_per_kernel():
    log = "\n".join([
        "ptxas info    : 0 bytes gmem",
        f"ptxas info    : Compiling entry function '{NS}19flash_fwd_tc_"
        "kernelILi128EEEvv' for 'sm_90a'",
        f"ptxas info    : Function properties for {NS}19flash_fwd_tc_kernel",
        "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads",
        "ptxas info    : Used 197 registers, used 1 barriers, 400 bytes "
        "cmem[0]",
        f"ptxas info    : Compiling entry function '{NS}16flash_fwd_kernel"
        "IfLi64EEEvv' for 'sm_90a'",
        "    24 bytes stack frame, 24 bytes spill stores, 16 bytes spill loads",
        "ptxas info    : Used 128 registers, used 1 barriers",
    ])
    entries = chip_smoke.ptxas_entries(log)
    assert list(entries) == ["flash_fwd_tc_kernel<128>",
                             "flash_fwd_kernel<float, 64>"]
    tc = entries["flash_fwd_tc_kernel<128>"]
    assert (tc["registers"], tc["spill_stores"], tc["spill_loads"]) == (
        197, 0, 0)
    assert len(tc["lines"]) == 2
    fp32 = entries["flash_fwd_kernel<float, 64>"]
    assert (fp32["registers"], fp32["spill_stores"], fp32["spill_loads"]) == (
        128, 24, 16)
    assert chip_smoke.ptxas_entries("") == {}


def test_serialized_wgmma_finds_ptxas_warning_c7515():
    """The build phase fails on these lines: a kernel whose wgmma ptxas
    serialized runs every product after the one before."""
    warning = (f"ptxas info    : (C7515) Potential Performance Loss: "
               f"wgmma.mma_async instructions are serialized due to the "
               f"presence of Extern calls in the function '{NS}_kernel'")
    log = "\n".join([
        f"ptxas info    : Compiling entry function '{NS}_kernel' for "
        "'sm_90a'", warning,
        "ptxas info    : Used 168 registers, used 1 barriers"])
    assert chip_smoke.serialized_wgmma(log) == [warning.strip()]
    assert chip_smoke.serialized_wgmma(log.replace(warning, "")) == []


def _stream_result(frames, ttft_ms, max_tokens=2):
    return {"status": 200, "max_tokens": max_tokens, "frames": frames,
            "head": {"content-type": "application/x-ndjson",
                     "x-ttft-ms": ttft_ms}}


GOOD = [{"token": 5, "index": 0}, {"token": 9, "index": 1},
        {"done": True, "reason": "length", "tokens": [5, 9],
         "ttft_s": 0.012345}]


def test_check_wire_takes_a_whole_stream():
    assert chip_smoke._check_wire([_stream_result(GOOD, "12.345")],
                                  vocab=16) == [[5, 9]]


@pytest.mark.parametrize("frames,ttft_ms,max_tokens", [
    (GOOD, "12.3", 2),                                  # X-TTFT-Ms off
    ([GOOD[1], GOOD[0], GOOD[2]], "12.345", 2),         # indices out of order
    ([GOOD[0], GOOD[2]], "12.345", 2),                  # a frame missing
    (GOOD, "12.345", 3),                                # budget not spent
    ([{"token": 99, "index": 0}, {"token": 9, "index": 1},
      dict(GOOD[2], tokens=[99, 9])], "12.345", 2),     # out of the vocab
], ids=["ttft", "order", "missing", "budget", "vocab"])
def test_check_wire_refuses_a_broken_stream(frames, ttft_ms, max_tokens):
    with pytest.raises(AssertionError):
        chip_smoke._check_wire(
            [_stream_result(frames, ttft_ms, max_tokens)], vocab=16)


def test_check_wire_refuses_an_error_status():
    with pytest.raises(AssertionError, match="503"):
        chip_smoke._check_wire([{"status": 503, "head": {},
                                 "error": "draining"}], vocab=16)


def test_first_mismatches():
    assert chip_smoke._first_mismatches(
        [[1, 2, 3], [1, 2], [4, 5]], [[1, 2, 3], [1, 2, 3], [4, 6]]) == [
        None, 2, 1]


def _qos_result(tenant, cls, head_cls=None):
    return {"head": {"x-qos-class": head_cls or cls},
            "frames": [{"done": True, "qos": {"tenant": tenant,
                                              "class": cls}}]}


def test_check_qos_classes_takes_each_tenants_class():
    chip_smoke._check_qos_classes(
        [_qos_result("crawler", "batch"), _qos_result("acme", "interactive")],
        ["crawler", "acme"])


@pytest.mark.parametrize("result", [
    _qos_result("crawler", "batch", head_cls="standard"),   # header off
    _qos_result("crawler", "standard"),                     # done view off
    _qos_result("acme", "batch"),                           # other tenant
    {"head": {"x-qos-class": "batch"}, "frames": [{"done": True}]},
], ids=["header", "done-class", "done-tenant", "no-qos-view"])
def test_check_qos_classes_refuses_another_class(result):
    with pytest.raises(AssertionError, match="crawler"):
        chip_smoke._check_qos_classes([result], ["crawler"])


def test_qos_tokens_reads_the_family_by_tenant_and_class():
    text = "\n".join([
        "# TYPE serving_qos_tokens_total counter",
        'serving_qos_tokens_total{tenant="acme",class="interactive"} 96.0',
        'serving_qos_tokens_total{tenant="crawler",class="batch"} 16',
        'serving_qos_ttft_seconds_count{tenant="acme",class="interactive"} 2',
        'serving_generate_tokens_total{model="default"} 112.0'])
    assert chip_smoke._qos_tokens(text) == {("acme", "interactive"): 96.0,
                                            ("crawler", "batch"): 16.0}
    assert chip_smoke._qos_tokens("") == {}


def test_admission_order_reads_admitted_events_of_the_requests():
    timeline = [{"event": "admitted", "request": 1},
                {"event": "first_token", "request": 1},
                {"event": "admitted", "request": 3},
                {"event": "suspended", "request": 3},
                {"event": "admitted", "request": 2},
                {"event": "admitted", "request": 3},
                {"event": "admitted", "request": 9}]
    assert chip_smoke._admission_order(timeline, [2, 3, 1]) == [1, 3, 2, 3]


def test_check_resumes_holds_the_skip_floor_and_the_prefill_cap():
    good = {"prefix_tokens_skipped": 512, "prefilled": 9}
    chip_smoke._check_resumes([good, dict(good, prefilled=32)], 512, 32)
    for bad in ([], [dict(good, prefix_tokens_skipped=496)],
                [good, dict(good, prefilled=33)]):
        with pytest.raises(AssertionError):
            chip_smoke._check_resumes(bad, 512, 32)


class _Handle:
    def __init__(self, tokens, max_tokens, reason="length"):
        self.out_tokens, self.max_tokens, self.reason = (tokens, max_tokens,
                                                         reason)


@pytest.mark.parametrize("stream,ok", [
    ({"handle": _Handle([1, 2, 3], 3), "indices": [0, 1, 2]}, True),
    ({"handle": _Handle([1, 2], 3), "indices": [0, 1]}, False),
    ({"handle": _Handle([1, 2, 3], 3), "indices": [0, 2, 1]}, False),
    ({"handle": _Handle([1, 2, 3], 3), "indices": [0, 1, 1, 2]}, False),
    ({"handle": _Handle([1, 2, 99], 3), "indices": [0, 1, 2]}, False),
    ({"handle": _Handle([1, 2, 3], 3, "eos"), "indices": [0, 1, 2]}, False),
], ids=["whole", "short", "order", "repeat", "vocab", "reason"])
def test_check_streams(stream, ok):
    stream = dict(stream, tenant="crawler")
    if ok:
        chip_smoke._check_streams([stream], vocab=16)
    else:
        with pytest.raises(AssertionError):
            chip_smoke._check_streams([stream], vocab=16)


def test_pctl_is_the_engines_rule():
    vals = [5, 1, 4, 2, 3]
    assert chip_smoke._pctl(vals, 0.5) == 3
    assert chip_smoke._pctl(vals, 0.95) == 5
    assert chip_smoke._pctl(list(range(100)), 0.95) == 95


def test_qos_requests_share_no_block():
    batch, inter = chip_smoke.qos_requests(32768, 8, 128, 8)
    assert [len(p) for p, _ in batch] == [512] * 8
    assert [len(p) for p, _ in inter] == [64] * 8
    assert {m for _, m in batch} == {128} and {m for _, m in inter} == {16}
    firsts = {tuple(p[:16]) for p, _ in batch + inter}
    assert len(firsts) == 16


def test_bundle_bytes_of_the_flagships_intruder():
    """56 blocks of 16 over 12 layers, 2 KV heads of 128: the bf16 pages,
    the int8 pages (half) and their fp32 scales."""
    assert chip_smoke.bundle_bytes(56, 16, 12, 2, 128, 2) == (11_010_048, 0)
    assert chip_smoke.bundle_bytes(56, 16, 12, 2, 128, 1, int8=True) == (
        5_505_024, 172_032)


def test_itg_stats_are_the_engines_percentiles_in_ms():
    gaps = [0.010] * 95 + [0.020] * 4 + [0.5]
    stats = chip_smoke.itg_stats(gaps)
    assert stats["gaps"] == 100 and stats["p50_ms"] == 10.0
    assert stats["p99_ms"] == 500.0 and stats["max_ms"] == 500.0
    assert chip_smoke.itg_stats(gaps[:99])["p99_ms"] == 20.0


def test_launches_are_attributed_per_run_and_summed_per_path():
    at = {"flash_fwd": 48, "paged_decode": 200}
    end = {"flash_fwd": 48, "paged_decode": 1524}
    assert chip_smoke.launch_delta(at, end) == {"flash_fwd": 0,
                                                "paged_decode": 1324}
    export = {"flash_fwd": 12, "paged_decode": 0}
    assert chip_smoke.launch_sum(export, end) == {"flash_fwd": 60,
                                                  "paged_decode": 1524}


def test_disagg_requests_are_the_schedule():
    shorts, intruder = chip_smoke.disagg_requests(32768)
    assert [len(p) for p, _ in shorts] == [64] * 4
    assert {m for _, m in shorts} == {128} and len(intruder) == 896
    assert len({tuple(p[:16]) for p, _ in shorts}
               | {tuple(intruder[:16])}) == 5


def _hop(frames, migrated="100", status=200):
    return {"prefill_status": 200,
            "prefill_head": {"content-type": "application/x-tensor"},
            "meta": {"page_bytes": 96, "scale_bytes": 4},
            "attach_status": status, "frames": frames,
            "attach_head": {"content-type": "application/x-ndjson",
                            "x-kv-bytes-migrated": migrated}}


HOP = [{"token": 5, "index": 0}, {"token": 9, "index": 1},
       {"done": True, "reason": "length", "tokens": [5, 9]}]


def test_check_hop_takes_a_whole_two_hop_answer():
    assert chip_smoke.check_hop(_hop(HOP), 2, vocab=16) == [5, 9]


@pytest.mark.parametrize("hop,max_tokens", [
    (_hop(HOP, migrated="96"), 2),                      # scales left out
    (_hop([HOP[1], HOP[0], HOP[2]]), 2),                # indices out of order
    (_hop(HOP), 3),                                     # budget not spent
    (_hop(HOP, status=400), 2),                         # refused import
    (dict(_hop(HOP), prefill_status=503), 2),           # no bundle
], ids=["bytes", "order", "budget", "attach-400", "prefill-503"])
def test_check_hop_refuses_a_broken_hop(hop, max_tokens):
    with pytest.raises(AssertionError):
        chip_smoke.check_hop(hop, max_tokens, vocab=16)


def test_check_tp_launches_takes_one_launch_a_shard():
    flat = {"flash_fwd": 12, "paged_chunk": 0, "paged_decode": 0}
    chip_smoke.check_tp_launches({"flash_fwd": 24, "paged_chunk": 0,
                                  "paged_decode": 0}, flat,
                                 {"flash_fwd": 12, "paged_chunk": 0}, 2)


@pytest.mark.parametrize("sharded,flat", [
    ({"flash_fwd": 12}, {"flash_fwd": 12}),      # one launch for 2 shards
    ({"flash_fwd": 36}, {"flash_fwd": 12}),
    ({"flash_fwd": 22}, {"flash_fwd": 11}),      # not the expected count
])
def test_check_tp_launches_refuses_other_counts(sharded, flat):
    with pytest.raises(AssertionError, match="launches"):
        chip_smoke.check_tp_launches(sharded, flat, {"flash_fwd": 12}, 2)


def test_check_pool_doubling_holds_the_capacity_claim():
    chip_smoke.check_pool_doubling({1: 2, 2: 4}, {1: 8, 2: 8},
                                   {1: 4096, 2: 4096}, 8, 2)


@pytest.mark.parametrize("peaks,per_chip,shard_bytes", [
    ({1: 2, 2: 3}, {1: 8, 2: 8}, {1: 4096, 2: 4096}),
    ({1: 0, 2: 0}, {1: 8, 2: 8}, {1: 4096, 2: 4096}),
    ({1: 2, 2: 4}, {1: 8, 2: 16}, {1: 4096, 2: 4096}),
    ({1: 2, 2: 4}, {1: 8, 2: 8}, {1: 4096, 2: 8192}),
])
def test_check_pool_doubling_refuses(peaks, per_chip, shard_bytes):
    with pytest.raises(AssertionError):
        chip_smoke.check_pool_doubling(peaks, per_chip, shard_bytes, 8, 2)


_TP_MAIN = {"tp2_tokens_equal": True, "tp2_pool_bytes_equal": True,
            "tp2_local_splits_pool_bytes_equal": False}


def test_check_tp_identity_takes_equal_streams_and_a_split_sensitive_pool():
    chip_smoke.check_tp_identity(dict(_TP_MAIN))


@pytest.mark.parametrize("key", sorted(_TP_MAIN))
def test_check_tp_identity_refuses(key):
    with pytest.raises(AssertionError):
        chip_smoke.check_tp_identity({**_TP_MAIN, key: not _TP_MAIN[key]})


@pytest.mark.parametrize("peak,ok", [(0, True), (4095, True),
                                     (4096, False), (9000, False)])
def test_check_export_copy_refuses_a_copy_of_the_pool(peak, ok):
    if ok:
        chip_smoke.check_export_copy(peak, 8192)
    else:
        with pytest.raises(AssertionError, match="copied the pool"):
            chip_smoke.check_export_copy(peak, 8192)


def test_local_splits_takes_a_shards_own_heads_and_restores_the_rules():
    from kubeflow_tpu_torch.compute.ops import paged_attention as ops
    saved = (ops.decode_splits, ops.chunk_splits)
    with chip_smoke.local_splits(2):
        # the engine passes the model's 2 KV heads; a shard holds 1
        assert ops.decode_splits(8, 2, 16, 64, 132) \
            == saved[0](8, 1, 16, 64, 132) == 32
        assert ops.chunk_splits(1, 256, 2, 4, 16, 64, 132) \
            == saved[1](1, 256, 1, 4, 16, 64, 132)
    assert (ops.decode_splits, ops.chunk_splits) == saved
    assert ops.decode_splits(8, 2, 16, 64, 132) == 17


def test_locked_submit_gives_engines_one_schedule():
    """Two engines fed the same requests under their locks admit them as
    one queue: the same tokens and the same pool bytes."""
    import torch
    from kubeflow_tpu_torch.compute import generate as gen_lib
    from kubeflow_tpu_torch.compute.models import transformer
    cfg = transformer.Config(vocab_size=64, d_model=32, n_layers=2,
                             n_heads=4, max_seq=64, dtype="float32",
                             attention="dense", remat=False)
    params = transformer.init_params(cfg, torch.Generator().manual_seed(0),
                                     device="cpu")
    reqs = [([1, 2, 3], 5), ([4] * 9, 3), ([7, 8], 6)]
    engines = [gen_lib.GenerationEngine(params, cfg, max_slots=2,
                                        block_size=8, device="cpu",
                                        name=f"locked{i}")
               for i in range(2)]
    try:
        outs = [[h.result(timeout=60)[0]
                 for h in chip_smoke._locked_submit(e, reqs)]
                for e in engines]
        assert outs[0] == outs[1]
        assert [len(o) for o in outs[0]] == [5, 3, 6]
        assert chip_smoke._same_pool(engines[0]._cache, engines[1]._cache)
    finally:
        for e in engines:
            e.close()


def test_vs_oracle_grades_up_to_the_first_mismatch():
    import numpy as np
    rows = [np.array([0.0, 1.0]), np.array([1.0, 0.0]),
            np.array([0.0, 1.0])]
    oracle = [([1, 0, 1], rows)]
    close = [r + 0.05 for r in rows]
    assert chip_smoke._vs_oracle([([1, 0, 1], close)], oracle, 0.2, 0.1,
                                 "x")[0]["first_mismatch"] is None
    far = [rows[0], rows[1] + 0.05, rows[2] + 5.0]     # past the mismatch
    got = chip_smoke._vs_oracle([([1, 1, 0], far)], oracle, 0.2, 0.1, "x")
    assert got[0]["first_mismatch"] == 1
    with pytest.raises(AssertionError):
        chip_smoke._vs_oracle([([1, 0, 1], far)], oracle, 0.2, 0.1, "x")


# ------------------------------------------------- the mesh train phases

def test_check_mesh_launches_takes_one_a_layer_a_position():
    names = ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")
    chip_smoke.check_mesh_launches(dict.fromkeys(names, 144), names,
                                   12 * 4, 3, "train_mesh")
    with pytest.raises(AssertionError, match="want 96 a step"):
        chip_smoke.check_mesh_launches(
            {"flash_fwd": 288, "flash_bwd_dq": 288, "flash_bwd_dkv": 287},
            names, 12 * 8, 3, "bert_mesh")


def _mesh_mlp_state():
    import functools

    from kubeflow_tpu_torch.compute import mesh, train
    from kubeflow_tpu_torch.compute.models import mlp
    cfg = mlp.Config(in_dim=8, hidden=8, n_classes=4)
    m = mesh.make_mesh(data=2, tensor=2, devices=["cpu"] * 4)
    opt = train.make_optimizer(1e-3, warmup_steps=0, total_steps=10)
    state = train.init_state(functools.partial(mlp.init_params, cfg), opt,
                             mesh=m, logical_axes=mlp.logical_axes(cfg))
    return cfg, m, opt, state


def test_unequal_copies_finds_a_copy_one_bit_off():
    import torch
    _, _, _, state = _mesh_mlp_state()
    assert chip_smoke.unequal_copies(state) == []
    w = state.params["layers"][0]["w"]          # (embed, mlp): data copies
    with torch.no_grad():
        w.pieces[3].view(torch.int32)[0, 0] += 1
    assert chip_smoke.unequal_copies(state) == [(1, 3)]


def test_params_rule_is_test_torch_trains():
    import torch
    want = [torch.zeros(2000)]
    assert chip_smoke.params_rule([torch.full((2000,), 5e-7)], want, 1e-3,
                                  1)[2]
    two = torch.zeros(2000)
    two[:2] = 1.9e-3                             # 0.1 % flipped by ~2·lr
    assert chip_smoke.params_rule([two], want, 1e-3, 1)[2]
    three = two.clone()
    three[2] = 1e-5                              # a third beyond 1e-6
    assert not chip_smoke.params_rule([three], want, 1e-3, 1)[2]
    assert not chip_smoke.params_rule([torch.full((2000,), 3e-3)], want,
                                      1e-3, 1)[2]
    # one element of a 64-channel leaf: 1.6 % of the leaf, 0.05 % of all
    small = torch.zeros(64)
    small[0] = 1.9e-3
    pair = ([small, torch.zeros(1936)], [torch.zeros(64), torch.zeros(1936)])
    assert not chip_smoke.params_rule(*pair, 1e-3, 1)[2]
    worst, share, ok = chip_smoke.params_rule(*pair, 1e-3, 1,
                                              whole_model=True)
    assert ok and share == 1 / 2000


def test_mesh_grads_are_the_logical_gradients():
    """The conformance phase's mesh gradient (each piece summed over its
    copies, gathered) is the unsharded model's, and the sync-BN check's
    per-leaf error reads it."""
    import numpy as np
    import torch

    from kubeflow_tpu_torch.compute import data, train
    from kubeflow_tpu_torch.compute.models import mlp
    cfg, m, _, state = _mesh_mlp_state()
    host = {"image": np.random.default_rng(0).standard_normal(
        (4, 8)).astype(np.float32), "label": np.arange(4, dtype=np.int32)}
    loss_fn = train.plain_loss(mlp.loss_fn, cfg)
    loss, grads = chip_smoke.mesh_grads(state, loss_fn,
                                        data.shard_batch(host, m))
    params = train.tree_map(lambda t: t.detach().requires_grad_(),
                            train.gather_params(state))
    value, _ = loss_fn(params, {}, data.to_device(host, "cpu"))
    want = torch.autograd.grad(value, train.tree_leaves(params))
    assert abs(loss - float(value)) <= 1e-6 * abs(float(value))
    assert max(chip_smoke._leaf_errors(grads, want)) <= 1e-6
    assert chip_smoke._leaf_errors([torch.ones(3)], [torch.full((3,), 2.)]
                                   ) == [0.5]


def _tiny_moe(**kw):
    from kubeflow_tpu_torch.compute.models import transformer
    return transformer.Config(**{**dict(
        vocab_size=64, d_model=32, n_layers=2, n_heads=2, max_seq=16,
        dtype="float32", attention="dense", remat=False, moe_experts=4,
        moe_top_k=2, moe_dropless=True), **kw})


@pytest.mark.parametrize("kw", [{}, dict(pipeline_stages=2),
                                dict(moe_dropless=False)],
                         ids=["dropless", "gpipe", "capacity"])
def test_router_tape_records_and_replays_the_choices(kw):
    """The tape reads each layer's choices in global row order from a
    2-piece mesh and from one device alike; replaying them on one device
    gives its own loss, and replaying other choices gives another."""
    import numpy as np
    import torch

    from kubeflow_tpu_torch.compute import data, mesh, train
    from kubeflow_tpu_torch.compute.models import transformer
    cfg = _tiny_moe(**kw)
    params = transformer.init_params(cfg, torch.Generator().manual_seed(0),
                                     device="cpu")
    host = {"tokens": np.random.default_rng(1).integers(
        0, 64, (4, 16), dtype=np.int32)}
    host["targets"] = np.roll(host["tokens"], -1, axis=1)
    m = mesh.make_mesh(data=2, expert=2, devices=["cpu"] * 4)
    state = train.init_state(
        lambda g, device: train.tree_map(torch.clone, params),
        train.make_optimizer(), mesh=m,
        logical_axes=transformer.logical_axes(cfg))
    with chip_smoke.RouterTape(cfg) as on_mesh:
        transformer.loss_fn(state.params, data.shard_batch(host, m), cfg)
    batch = data.to_device(host, "cpu")
    with chip_smoke.RouterTape(cfg) as alone:
        want = transformer.loss_fn(params, batch, cfg)[0]
    assert on_mesh.flips(alone) == (0, None)
    for layer in range(cfg.n_layers):
        assert on_mesh.choices(layer).shape == (4, 16, 2)
    with chip_smoke.RouterTape(cfg, replay=on_mesh):
        again = transformer.loss_fn(params, batch, cfg)[0]
    assert float(again) == float(want)
    idx, probs = on_mesh.calls[1][0]        # layer 1's first piece
    on_mesh.calls[1][0] = ((idx + 1) % 4, probs)
    with chip_smoke.RouterTape(cfg, replay=on_mesh):
        other = transformer.loss_fn(params, batch, cfg)[0]
    assert float(other) != float(want)
    n, gap = on_mesh.flips(alone)
    assert n == idx.shape[0] * idx.shape[1] and gap is not None
    assert transformer._router is not None and not isinstance(
        transformer._router, chip_smoke.RouterTape)


def test_params_digest_sees_one_bit():
    import torch
    _, _, _, state = _mesh_mlp_state()
    before = chip_smoke._params_digest(state)
    assert torch.equal(before, chip_smoke._params_digest(state))
    with torch.no_grad():
        state.params["layers"][0]["w"].pieces[0].view(torch.int32)[0, 0] += 1
    assert not torch.equal(before, chip_smoke._params_digest(state))


@pytest.mark.parametrize("before,after,want", [
    (None, {"sum": 32.0, "count": 8}, (8, 32.0, 4.0)),
    ({"sum": 10.0, "count": 10}, {"sum": 42.0, "count": 18},
     (8, 32.0, 4.0)),
    ({"sum": 5.0, "count": 5}, {"sum": 5.0, "count": 5}, (0, 0.0, 0.0))])
def test_occupancy_delta_reads_the_dispatches_between_two_reads(
        before, after, want):
    assert chip_smoke.occupancy_delta(before, after) == want


@pytest.mark.parametrize("calls,requests,mean,ok", [
    (8, 32, 4.0, True), (32, 32, 1.0, False), (31, 32, 1.0, False),
    (8, 32, 1.0, False), (33, 32, 2.0, False)])
def test_check_coalesced_needs_fewer_calls_and_occupancy_above_one(
        calls, requests, mean, ok):
    if ok:
        chip_smoke.check_coalesced(calls, requests, mean)
    else:
        with pytest.raises(AssertionError, match="nothing coalesced"):
            chip_smoke.check_coalesced(calls, requests, mean)


@pytest.mark.parametrize("before,after,ok", [
    (1000, 100, True), (1000, 101, False), (1000, 0, True),
    (500, 500, False)])
def test_check_memory_drop_needs_nine_tenths_of_the_model(before, after,
                                                          ok):
    if ok:
        chip_smoke.check_memory_drop(before, after, 1000)
    else:
        with pytest.raises(AssertionError, match="eviction freed"):
            chip_smoke.check_memory_drop(before, after, 1000)


def test_canary_split_is_the_servers_route_under_the_same_seed():
    import random

    from kubeflow_tpu_torch.compute import serving

    server = serving.ModelServer(device="cpu")
    server._canary_rng = random.Random(5)
    server._canaries["m"] = {"model": "canary", "weight": 0.3}
    got = [server._route("m", "stable") for _ in range(40)]
    assert got == chip_smoke.canary_split(5, 0.3, 40, "stable", "canary")
    assert set(got) == {"stable", "canary"}
    assert chip_smoke.canary_split(5, 0.0, 8, "1", "2") == ["1"] * 8
    assert chip_smoke.canary_split(5, 1.0, 8, "1", "2") == ["2"] * 8


def test_predict_rows_reads_every_answer_format():
    import base64
    import json

    x = np.arange(6, dtype=np.float32).reshape(2, 3)
    x_tensor = {"content-type": "application/x-tensor",
                "x-tensor-dtype": "float32", "x-tensor-shape": "2,3"}
    json_ct = {"content-type": "application/json"}
    b64 = base64.b64encode(x.tobytes()).decode()
    answers = [
        (x_tensor, x.tobytes()),
        (json_ct, json.dumps({"predictions": x.tolist()}).encode()),
        (json_ct, json.dumps({"tensor": {"dtype": "float32",
                                         "shape": [2, 3],
                                         "b64": b64}}).encode())]
    for head, body in answers:
        got = chip_smoke._predict_rows(
            {"status": 200, "head": head, "body": body}, 3)
        np.testing.assert_array_equal(got, x)
    with pytest.raises(AssertionError, match="answered 503"):
        chip_smoke._predict_rows({"status": 503, "head": {}, "body": b""}, 3)


# ---------------------------------------------- the two serving transports

def _wire_run(step_s, tokens_per_stream=2):
    """A ``_wire_run`` result of 2 streams whose decode steps took
    ``step_s`` each."""
    done = {"done": True, "reason": "length",
            "tokens": list(range(tokens_per_stream)), "ttft_s": 0.01,
            "itg_p50_s": step_s, "itg_max_s": 2 * step_s}
    results = [{"frames": [done], "first_frame_s": 0.02}] * 2
    stats = {"decode_steps": 10, "decode_seconds_total": 10 * step_s,
             "prefills": 2}
    return {"results": results, "wall": 1.0, "launches": {"flash_fwd": 2},
            "outs": [([1, 2], "length")] * 2, "wall_in": 0.5,
            "d_wire": stats, "d_in": dict(stats, decode_seconds_total=0.05)}


@pytest.mark.parametrize("order", [("threaded", "async"),
                                   ("async", "threaded")])
def test_wire_rows_name_their_transport_and_the_async_ratios(order):
    steps = {"threaded": 0.015, "async": 0.010}
    rows = {t: chip_smoke.wire_row(t, _wire_run(steps[t]), {})
            for t in order}
    assert [r["transport"] for r in rows.values()] == list(order)
    row = rows["async"]
    assert row["decode_step_ms"] == pytest.approx(10.0)
    assert row["inproc_decode_step_ms"] == pytest.approx(5.0)
    assert row["inproc_tokens_per_s"] == pytest.approx(8.0)
    ratios = chip_smoke.transport_ratios(rows, chip_smoke.WIRE_RATIO_KEYS)
    assert ratios["order"] == list(order)
    assert ratios["decode_step_ms"] == pytest.approx(10.0 / 15.0)
    assert ratios["itg_p50_ms"] == pytest.approx(10.0 / 15.0)
    assert ratios["tokens_per_s"] == pytest.approx(1.0)
    nested = chip_smoke.transport_ratios(
        {"threaded": {"latency": {"binary": {"p50_ms": 4.0}}},
         "async": {"latency": {"binary": {"p50_ms": 3.0}}}},
        ("latency.binary.p50_ms",))
    assert nested == {"order": ["threaded", "async"],
                      "latency.binary.p50_ms": 0.75}


@pytest.mark.parametrize("launches,missing", [
    ({"paged_decode": 0, "flash_fwd": 0}, "['paged_decode', 'flash_fwd']"),
    ({"paged_decode": 3, "flash_fwd": 0}, "['flash_fwd']"),
    ({"paged_decode": 0, "flash_fwd": 12}, "['paged_decode']"),
    ({"paged_decode": 3, "flash_fwd": 12}, None)],
    ids=["neither", "no-k3", "no-k1", "both"])
def test_require_refuses_an_async_wire_run_without_k1_and_k3(launches,
                                                            missing):
    names = ("paged_decode", "flash_fwd")
    if missing is None:
        chip_smoke._require(launches, names, "wire (async)")
        return
    with pytest.raises(AssertionError) as err:
        chip_smoke._require(launches, names, "wire (async)")
    assert str(err.value) == (f"kernels never launched on the wire (async) "
                              f"path: {missing}")


@pytest.mark.parametrize("transport,ok", [("async", True),
                                          ("threaded", False)])
def test_check_transport_log_reads_the_startup_line(transport, ok):
    log = ["2026-01-01 00:00:00 root INFO model-server serving on :4312 "
           "(async transport)", "PORT 4312"]
    if ok:
        chip_smoke.check_transport_log(log, transport)
    else:
        with pytest.raises(AssertionError, match="threaded transport"):
            chip_smoke.check_transport_log(log, transport)


def _predict_answer(rows, ms, infer_ms="3.5"):
    return {"status": 200, "ms": ms, "body": rows.tobytes(),
            "head": {"content-type": "application/x-tensor",
                     "x-tensor-dtype": "float32",
                     "x-tensor-shape": f"1,{rows.shape[-1]}",
                     "x-served-version": "1",
                     "x-inference-time-ms": infer_ms}}


def test_predict_numbers_and_errors_of_one_transport(monkeypatch):
    monkeypatch.setattr(chip_smoke, "PREDICT_CLIENTS", 2)
    monkeypatch.setattr(chip_smoke, "PREDICT_PER_CLIENT", 2)
    ref = np.float32([[0.25, 0.75], [0.5, 0.5]])
    off = ref + np.float32([[0.0, 1e-3], [0.0, 0.0]])
    json_ok = {"status": 200, "ms": 100.0, "body": b'{"predictions": '
               b'[[0.25, 0.75]]}', "head": {"content-type":
                                             "application/json"}}
    run = {"binary": [[_predict_answer(off[:1], 10.0),
                       _predict_answer(off[:1], 30.0)],
                      [_predict_answer(ref[1:], 20.0, "4.5"),
                       _predict_answer(ref[1:], 40.0, "5.5")]],
           "binary_s": 0.5, "calls": 2, "dispatches": 2, "coalesced": 4.0,
           "occ_mean": 2.0, "json": [json_ok] * 2, "b64": [json_ok] * 2}
    errs = chip_smoke._predict_errors(run, ref, 2)
    assert max(errs["binary"]) == pytest.approx(1e-3, rel=1e-4)   # fp32
    assert errs["json"] == errs["b64"] == [0.0, 0.0]
    chip_smoke.check_predict_errors(errs, "async")
    with pytest.raises(AssertionError, match="binary rows over the async"):
        chip_smoke.check_predict_errors({"binary": [0.5]}, "async")
    numbers = chip_smoke._predict_numbers(run)
    assert numbers["images_per_s"] == {"binary": 8.0, "json": 10.0,
                                       "b64": 10.0}
    assert numbers["latency"]["binary"]["n"] == 4
    assert numbers["inference_time_ms_p50"] == pytest.approx(
        chip_smoke._pctl([3.5, 3.5, 4.5, 5.5], 0.5))
    assert numbers["occupancy_mean"] == 2.0
    run["binary"][0][0]["head"]["x-served-version"] = "2"
    with pytest.raises(AssertionError, match="x-tensor answer headers"):
        chip_smoke._predict_errors(run, ref, 2)


def test_the_predict_stream_refusal_is_the_async_transports_answer():
    import http.client

    from kubeflow_tpu_torch.compute import serving

    server = serving.ModelServer(device="cpu")
    server.register("m", lambda x: x)
    port = server.start(port=0, host="127.0.0.1", transport="async")
    try:
        conn = http.client.HTTPConnection("127.0.0.1", port, timeout=30)
        conn.request("POST", "/v1/models/m:predictStream", b"{}\n",
                     {"Content-Type": "application/x-ndjson"})
        resp = conn.getresponse()
        assert (resp.status, resp.read()) == (
            501, chip_smoke.PREDICT_STREAM_501)
        conn.close()
    finally:
        server.stop()


def _gang_ranks(**change):
    """Two ranks' ``process_mesh`` rows for one model (rank 1 with
    ``change``)."""
    base = {"model": "bert", "batch_per_rank": 8,
            "losses": [2.0, 2.0, 1.5, 1.2],
            "step_ms_each": [50.0, 10.0, 30.0, 40.0],
            "all_reduce_ms_each": [5.0, 1.0, 3.0, 4.0],
            "small_collective_ms": 2.0,
            "small_collectives_a_step": 106, "grad_bytes": 64,
            "params_equal_each_step": [True] * 4,
            "launches": dict.fromkeys(chip_smoke.BERT_KERNELS,
                                      12 * chip_smoke.PROCESS_STEPS)}
    return [{"bert": {**base, "rank": 0}},
            {"bert": {**base, "rank": 1, **change}}]


_ONE_LOSSES = [2.001, 2.001, 1.5, 1.2, 1.0]


def test_gang_row_reads_both_ranks_beside_one_process():
    """Step ms and the all_reduce from the steps between the first and
    the last, the small collectives' share of the last step, each
    step's loss beside the one-process row's same step."""
    row = chip_smoke._gang_row("bert", _gang_ranks(),
                               {"step_ms": 15.0, "losses": _ONE_LOSSES})
    assert row["step_ms"] == 20.0 and row["all_reduce_ms"] == 2.0
    assert row["all_reduce_share"] == 0.1
    assert row["small_collective_ms"] == 2.0
    assert row["small_collective_share"] == 0.05
    assert row["loss_rel_each"] == pytest.approx(
        [1e-3 / 2.001, 1e-3 / 2.001, 0.0, 0.0])
    chip_smoke.check_gang(row, chip_smoke.BERT_KERNELS, 12)


@pytest.mark.parametrize("change,one_losses", [
    (dict(params_equal_each_step=[True, False, True, True]), _ONE_LOSSES),
    (dict(losses=[2.0, 2.0, 1.6, 1.2]), _ONE_LOSSES),
    ({}, [2.1] + _ONE_LOSSES[1:]),
    ({}, _ONE_LOSSES[:3] + [1.21]),
    ({}, _ONE_LOSSES[:3]),
    (dict(launches=dict.fromkeys(chip_smoke.BERT_KERNELS, 35)),
     _ONE_LOSSES)],
    ids=["bytes", "losses", "step1", "later", "short", "launches"])
def test_check_gang_refuses(change, one_losses):
    row = chip_smoke._gang_row("bert", _gang_ranks(**change),
                               {"step_ms": 15.0, "losses": one_losses})
    with pytest.raises(AssertionError, match="process_mesh bert"):
        chip_smoke.check_gang(row, chip_smoke.BERT_KERNELS, 12)


_FP32_GANG = {"ranks_equal": True, "loss_rel": 0.0, "stats_rel_max": 2e-6,
              "init_grad_norm_rel": 0.0, "params_rule_ok": True,
              "tol": 1e-5}


@pytest.mark.parametrize("change", [
    {}, dict(ranks_equal=False), dict(stats_rel_max=2e-5),
    dict(init_grad_norm_rel=0.2), dict(params_rule_ok=False)])
def test_check_resnet_gang_fp32(change):
    report = {**_FP32_GANG, **change}
    if not change:
        chip_smoke.check_resnet_fp32(report, "fp32 ResNet gang")
        return
    with pytest.raises(AssertionError, match="fp32 ResNet gang"):
        chip_smoke.check_resnet_fp32(report, "fp32 ResNet gang")


def test_resnet_fp32_report_reads_two_sides():
    """The report's relative gaps and the params rule over all elements;
    a mesh's report (no ranks) passes ``check_resnet_fp32`` alone."""
    import torch
    leaf = torch.ones(4)
    want = (2.0, [leaf], 4.0, [leaf])
    got = (2.0 + 2e-6, [leaf + 2.0 ** -20], 4.0, [leaf + 1e-7])
    report = chip_smoke.resnet_fp32_report(got, want, 1e-3)
    assert report["loss_rel"] == pytest.approx(1e-6)
    assert report["stats_rel_max"] == 2.0 ** -20
    assert report["init_grad_norm_rel"] == 0.0 and report["params_rule_ok"]
    chip_smoke.check_resnet_fp32(report, "resnet_mesh")
    bad = chip_smoke.resnet_fp32_report(got, (2.0, [leaf], 4.0,
                                              [leaf + 1.0]), 1e-3)
    with pytest.raises(AssertionError, match="resnet_mesh"):
        chip_smoke.check_resnet_fp32(bad, "resnet_mesh")


def _1f1b_data_row(k3=384, k45=192, live=3, rel=1e-3):
    return {"launches": {"flash_fwd": k3, "flash_bwd_dq": k45,
                         "flash_bwd_dkv": k45},
            "1f1b": {"live_inputs": live},
            "loss_rel_vs_pipeline_1f1b": rel, "loss_rel_vs_gpipe": 0.0}


@pytest.mark.parametrize("kw,ok", [
    ({}, True), (dict(k3=192), False), (dict(k45=96), False),
    (dict(live=4), False), (dict(rel=2e-2), False)])
def test_check_1f1b_data_counts_both_cuts(kw, ok):
    """12 layers x 8 microbatches, each cut in two: K3 2 x 12 x 8 x 2
    (forward and recompute), K4/K5 12 x 8 x 2, at most 2P - 1 inputs."""
    row = _1f1b_data_row(**kw)
    if ok:
        chip_smoke.check_1f1b_data(row, 12, 8)
        return
    with pytest.raises(AssertionError, match="data"):
        chip_smoke.check_1f1b_data(row, 12, 8)


_F1B_FP32 = {"loss_rel": 2e-7, "leaf_rel_max": 4e-6, "tol_loss": 1e-5,
             "tol_leaf": 1e-3}


def _1f1b_gang_ranks(rank0=(), rank1=()):
    """Two ranks' rows of ``pipeline_1f1b_gang`` (the flagship's 12
    layers in 8 microbatches), each changed by its ``rank*`` items."""
    base = {"backend": "gloo", "loss": 5.0, "grads_equal": True,
            "live_inputs": 3, "batch_per_rank": 8, "ms": 3000.0,
            "ms_each": [6000.0, 3000.0, 3600.0],
            "launches": {"flash_fwd": 192, "flash_bwd_dq": 96,
                         "flash_bwd_dkv": 96},
            "collectives": {"join": {"ms": 360.0, "count": 8, "share": 0.1},
                            "grad_all_reduce": {"ms": 1800.0, "count": 1,
                                                "share": 0.5}},
            "fp32": dict(_F1B_FP32), "moe": dict(_F1B_FP32)}
    return [{**base, "rank": 0, **dict(rank0)},
            {**base, "rank": 1, "fp32": None, "moe": None, **dict(rank1)}]


def test_gang_1f1b_row_reads_both_ranks_beside_one_process():
    """The ranks' losses beside the one-process ``data=2 x pipeline=2``
    loss, ms and each collective's share as the ranks' means, launches
    summed over the ranks (every kernel named), rank 0's fp32 and MoE
    reports; the row passes ``check_1f1b_gang``."""
    ranks = _1f1b_gang_ranks(rank1={"ms": 3200.0, "collectives": {
        "join": {"ms": 400.0, "count": 8, "share": 0.2}}})
    row = chip_smoke.gang_1f1b_row(
        ranks, {"1f1b": {"loss": 5.0 * (1 + 1e-3), "ms": 1550.0}},
        ["flash_fwd", "flash_bwd_dq", "flash_bwd_dkv", "grouped_matmul"])
    assert row["losses"] == [5.0, 5.0] and row["ranks_equal"]
    assert row["loss_rel"] == pytest.approx(1e-3 / (1 + 1e-3))
    assert row["ms"] == 3100.0 and row["vs_one_process"] == 2.0
    assert row["collectives"]["join"] == {
        "ms": 380.0, "count": 8, "share": pytest.approx(0.15)}
    assert row["collectives"]["grad_all_reduce"]["share"] == 0.25
    assert row["launches"] == {"flash_fwd": 384, "flash_bwd_dq": 192,
                               "flash_bwd_dkv": 192, "grouped_matmul": 0}
    assert row["fp32"] == _F1B_FP32 and row["live_inputs"] == 3
    chip_smoke.check_1f1b_gang(row, 12, 8)


@pytest.mark.parametrize("rank0,rank1,one_loss", [
    ((), dict(grads_equal=False), 5.0),
    ((), dict(loss=5.0001), 5.0),
    ((), (), 5.2),
    ((), dict(launches={"flash_fwd": 191, "flash_bwd_dq": 96,
                        "flash_bwd_dkv": 96}), 5.0),
    ((), dict(launches={"flash_fwd": 192, "flash_bwd_dq": 96,
                        "flash_bwd_dkv": 192}), 5.0),
    ((), dict(live_inputs=4), 5.0),
    (dict(fp32={**_F1B_FP32, "loss_rel": 2e-5}), (), 5.0),
    (dict(fp32={**_F1B_FP32, "leaf_rel_max": 2e-3}), (), 5.0),
    (dict(moe={**_F1B_FP32, "loss_rel": 2e-5}), (), 5.0),
    (dict(moe={**_F1B_FP32, "leaf_rel_max": 2e-3}), (), 5.0)],
    ids=["grads", "losses", "one_process", "k3", "k45", "live",
         "fp32_loss", "fp32_leaf", "moe_loss", "moe_leaf"])
def test_check_1f1b_gang_refuses(rank0, rank1, one_loss):
    row = chip_smoke.gang_1f1b_row(
        _1f1b_gang_ranks(rank0, rank1), {"1f1b": {"loss": one_loss,
                                                  "ms": 1500.0}},
        ["flash_fwd", "flash_bwd_dq", "flash_bwd_dkv"])
    with pytest.raises(AssertionError, match="pipeline_1f1b_gang"):
        chip_smoke.check_1f1b_gang(row, 12, 8)


def test_moe_aux_report_reads_two_sides():
    """The loss's relative gap and the worst leaf's max |Δg| over its
    max |g|; ``check_moe_aux`` holds them to 1e-5 and 1e-3."""
    import torch
    want = (2.0, [torch.ones(3), torch.full((2,), 4.0)])
    close = (2.0 * (1 + 5e-6), [torch.ones(3), torch.tensor([4.0, 4.002])])
    report = chip_smoke.moe_aux_report(close, want)
    assert report["loss_rel"] == pytest.approx(5e-6)
    assert report["leaf_rel_max"] == pytest.approx(5e-4, rel=1e-3)
    chip_smoke.check_moe_aux(report, "MoE aux")
    for got in ((2.0 * (1 + 2e-5), want[1]),
                (2.0, [torch.ones(3), torch.tensor([4.0, 4.01])])):
        with pytest.raises(AssertionError, match="MoE aux"):
            chip_smoke.check_moe_aux(chip_smoke.moe_aux_report(got, want),
                                     "MoE aux")
