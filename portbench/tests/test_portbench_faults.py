"""A run with the timed path broken underneath comes out not correct:
each fault a cell can have, planted in the program of a tiny cell run on
the CPU (the harness's look for a card skipped), under the tiny cell's
limits. The same runs unbroken are correct. Serving: a token altered
where it is produced; a decode step that leaves its state (the KV pool)
unchanged. Training: a step that returns its state unchanged; half of
the batch left out, the mean taken over the rest. (Every cell takes one
card: there is no exchange between chips to leave out.)"""

import pytest

from portbench import harness

from kubeflow_tpu_torch.compute import generate, train
from kubeflow_tpu_torch.compute.models import transformer

SEED = 2 ** 31 + 777


def run_train(bench, tiny_train):
    cfg, mix, st = tiny_train
    return harness.run_cell(bench, "mixtral-8x7b.train-4k", SEED, 1, 0,
                            device="cpu", config=cfg, settings=st, mix=mix)


def run_serve(bench, tiny_serve):
    cfg, mix, st = tiny_serve
    return harness.run_cell(bench, "mistral-7b.docqa", SEED, 3, 0,
                            device="cpu", config=cfg, settings=st, mix=mix)


def failed_checks(result):
    return {k for k, c in result["checks"].items()
            if not c["value"] <= c["limit"]}


def test_unbroken_runs_are_correct(bench, tiny_train, tiny_serve):
    assert run_train(bench, tiny_train)["correct"] is True
    assert run_serve(bench, tiny_serve)["correct"] is True


def test_step_that_returns_its_state_unchanged(bench, tiny_train,
                                               monkeypatch):
    def update(self, params, grads, opt_state, unique=None):
        return train.global_norm(grads)
    monkeypatch.setattr(train.AdamW, "update", update)
    result = run_train(bench, tiny_train)
    assert result["correct"] is False
    assert "change_norm_gap" in failed_checks(result)


def test_half_the_batch_left_out(bench, tiny_train, monkeypatch):
    whole = transformer.loss_fn

    def half(params, batch, config):
        n = batch["tokens"].shape[0] // 2
        return whole(params, {k: v[:n] for k, v in batch.items()}, config)
    monkeypatch.setattr(transformer, "loss_fn", half)
    result = run_train(bench, tiny_train)
    assert result["correct"] is False
    assert "loss_rel_gap" in failed_checks(result)


@pytest.mark.parametrize("where", ["first", "later"])
def test_token_altered_where_it_is_produced(bench, tiny_serve, monkeypatch,
                                            where):
    emit = generate.GenerationEngine._emit

    def altered(self, handle, token):
        if (len(handle.out_tokens) == 0) == (where == "first"):
            token = (token + self.config.vocab_size // 2) \
                % self.config.vocab_size
        return emit(self, handle, token)
    monkeypatch.setattr(generate.GenerationEngine, "_emit", altered)
    result = run_serve(bench, tiny_serve)
    assert result["correct"] is False
    assert failed_checks(result) == {"widest_gap"}


def test_decode_step_that_leaves_the_pool_unchanged(bench, tiny_serve,
                                                   monkeypatch):
    monkeypatch.setattr(generate.GenerationEngine, "_write_kv",
                        lambda self, *a, **k: None)
    result = run_serve(bench, tiny_serve)
    assert result["correct"] is False
    assert failed_checks(result) == {"widest_gap"}
