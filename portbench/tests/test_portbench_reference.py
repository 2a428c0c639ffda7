"""The plain reference against the port at a tiny width on the CPU, in
float32: the dense forward's logits, the MoE loss and its gradients,
one AdamW step, and the engine's served tokens through prefill and
decode. (The test imports the port; the reference does not.)"""

import torch

from portbench import compare
from portbench.inputs import weights
from portbench.reference import model as ref_model
from portbench.reference.optim import AdamW

from kubeflow_tpu_torch.compute import generate, train
from kubeflow_tpu_torch.compute.models import transformer


def port_config(cfg, seq):
    return transformer.Config(
        vocab_size=cfg["vocab_size"], d_model=cfg["hidden_size"],
        n_layers=cfg["num_hidden_layers"],
        n_heads=cfg["num_attention_heads"],
        n_kv_heads=cfg["num_key_value_heads"],
        d_ff=cfg["intermediate_size"], max_seq=seq,
        rope_theta=cfg["rope_theta"], dtype="float32", attention="flash",
        remat=False, moe_experts=cfg.get("num_local_experts") or 0,
        moe_top_k=cfg.get("num_experts_per_tok") or 1, moe_dropless=True,
        moe_gmm=True, moe_gmm_block_m=64)


def test_dense_forward_logits(tiny_serve):
    cfg = tiny_serve[0]
    params = weights.make(cfg, 5, "cpu", torch.float32)
    tokens = torch.randint(0, cfg["vocab_size"], (1, 48),
                           generator=torch.Generator().manual_seed(1))
    got = transformer.apply(params, tokens, port_config(cfg, 48))[0]
    m = ref_model.Model.of(cfg)
    want = ref_model.served_logits(params, [tokens[0]],
                                   [torch.arange(48)], m, block=16)["fp32"][0]
    assert torch.allclose(got, want, atol=1e-5, rtol=1e-5)


def test_moe_loss_gradients_and_update(tiny_train):
    cfg, mix, st = tiny_train
    m = ref_model.Model.of(cfg)
    rows = torch.randint(0, cfg["vocab_size"], (4, 65),
                         generator=torch.Generator().manual_seed(2))
    params = weights.make(cfg, 7, "cpu", torch.float32)
    flat = dict(weights.flat(params))
    for t in flat.values():
        t.requires_grad_(True)
    loss, _ = transformer.loss_fn(params, {"tokens": rows[:, :-1],
                                           "targets": rows[:, 1:]},
                                  port_config(cfg, 64))
    want = ref_model.loss(params, rows, m, block=16)
    assert abs(float(loss.detach()) - float(want.detach())) < 1e-5
    g_port = torch.autograd.grad(loss, list(flat.values()))
    g_ref = torch.autograd.grad(want, list(flat.values()))
    for k, a, b in zip(flat, g_port, g_ref):
        assert float((a - b).abs().max()) <= 1e-4 * float(b.abs().max()), k
    # one update: the port's AdamW and the plain one from equal gradients
    o = st["optimizer"]
    opt = train.make_optimizer(
        learning_rate=o["learning_rate"], warmup_steps=0,
        total_steps=o["total_steps"], weight_decay=o["weight_decay"],
        b1=o["b1"], b2=o["b2"], clip_norm=o["clip_norm"])
    port_p = [t.detach().clone() for t in flat.values()]
    opt.update(port_p, [g.clone() for g in g_port], opt.init(port_p))
    ref_p = {k: t.detach().clone() for k, t in flat.items()}
    AdamW(o["learning_rate"], o["b1"], o["b2"], o["eps"], o["weight_decay"],
          o["clip_norm"], o["total_steps"]).step(
        ref_p, dict(zip(flat, g_port)))
    for a, (k, b) in zip(port_p, ref_p.items()):
        assert torch.allclose(a, b, atol=1e-7, rtol=1e-6), k


def test_engine_tokens_through_the_cache(tiny_serve):
    cfg = tiny_serve[0]
    params = weights.make(cfg, 9, "cpu", torch.float32)
    eng = generate.GenerationEngine(params, port_config(cfg, 128),
                                    max_slots=4, block_size=16,
                                    max_context=128, device="cpu")
    g = torch.Generator().manual_seed(3)
    prompts = [torch.randint(0, cfg["vocab_size"], (n,), generator=g)
               for n in (20, 37, 52)]
    try:
        handles = [eng.submit(p.tolist(), max_tokens=6) for p in prompts]
        served = [torch.tensor(h.result(timeout=60)[0]) for h in handles]
    finally:
        eng.close()
    m = ref_model.Model.of(cfg)
    seqs = [torch.cat([p, s[:-1]]) for p, s in zip(prompts, served)]
    at = [torch.arange(len(p) - 1, len(p) - 1 + len(s))
          for p, s in zip(prompts, served)]
    logits = ref_model.served_logits(params, seqs, at, m, block=16)["fp32"]
    assert max(compare.served_gap(lg, s)
               for lg, s in zip(logits, served)) < 1e-4
