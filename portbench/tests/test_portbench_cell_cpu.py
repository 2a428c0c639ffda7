"""A tiny cell of each runner, run on the CPU through the harness, its
line printed as the command prints it: the contract's keys, the cell's
metrics, and ``correct`` true."""

import io
import json

from portbench import harness

REQUIRED = ["correct", "attempted", "failed", "metrics", "device"]
SEED = 2 ** 31 + 12345        # larger than 32 signed bits hold


def last_line(result):
    out, err = io.StringIO(), io.StringIO()
    assert harness.finish(result, out=out, err=err) == 0
    lines = err.getvalue().splitlines()
    assert lines and all(line.startswith("check ") for line in lines[-3:])
    return json.loads(out.getvalue().splitlines()[-1])


def keys_of(line, trace):
    keys = list(line)
    assert keys[:5] == REQUIRED
    # the compared numbers come last, each beside its limit
    assert keys[-1] == "checks"
    assert set(keys) - set(REQUIRED) == ({"checks", "breakdown"} if trace
                                         else {"checks"})
    for c in line["checks"].values():
        assert set(c) == {"value", "limit"}


def test_serve_cell_line(bench, tiny_serve):
    cfg, mix, st = tiny_serve
    line = last_line(harness.run_cell(
        bench, "mistral-7b.docqa", SEED, 3, 0, device="cpu", config=cfg,
        settings=st, mix=mix))
    keys_of(line, trace=False)
    assert line["correct"] is True and line["failed"] == 0
    assert set(line["metrics"]) == {"setup_s", "gen_tokens_per_s"}
    # the closed loop's 4 callers each sent at least one request in the
    # window, and every one of them finished
    assert line["attempted"] >= mix["clients"]
    assert line["device"]["platform"] == "cpu"


def test_train_cell_traced_line(bench, tiny_train):
    cfg, mix, st = tiny_train
    line = last_line(harness.run_cell(
        bench, "mixtral-8x7b.train-4k", SEED, 2, 1, device="cpu",
        config=cfg, settings=st, mix=mix))
    keys_of(line, trace=True)
    assert line["correct"] is True
    # a CPU run reads no device metric: every per-layer metric here is
    # one of the card's, so none is printed
    assert line["metrics"] == {}
    assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}
    assert line["device"]["window_s"] > 0


def test_same_seed_same_schedule():
    from portbench.traffic import lm_requests as g, load_mix
    mix = load_mix("docqa")
    a, b = (g.schedule(mix, 8.0, SEED, 30, 32000) for _ in range(2))
    assert [r["due"] for r in a] == [r["due"] for r in b]
    assert all((x["prompt"] == y["prompt"]).all() for x, y in zip(a, b))
    c = g.schedule(mix, 8.0, SEED + 1, 30, 32000)
    # another seed: the same work in another order
    for phase in ("lead", "window", "tail"):
        lens = sorted(len(r["prompt"]) for r in a if r["phase"] == phase)
        assert lens == sorted(len(r["prompt"]) for r in c
                              if r["phase"] == phase)
        outs = sorted(r["max_tokens"] for r in a if r["phase"] == phase)
        assert outs == sorted(r["max_tokens"] for r in c
                              if r["phase"] == phase)
    assert sum(r["phase"] == "window" for r in a) == 240


def test_same_seed_same_sequence():
    import itertools
    from portbench.traffic import lm_requests as g, load_mix
    mix = load_mix("docqa")
    n = mix["clients"]

    def take(seed, k):
        return list(itertools.islice(g.sequence(mix, seed, 32000), k))
    a, b, c = take(SEED, 3 * n), take(SEED, 3 * n), take(SEED + 1, 3 * n)
    assert [r["id"] for r in a] == list(range(3 * n))
    assert all((x["prompt"] == y["prompt"]).all()
               and x["max_tokens"] == y["max_tokens"] for x, y in zip(a, b))
    # every block of `clients` requests holds the same work, in each
    # seed's own order
    for i in range(3):
        blk_a, blk_c = a[i * n:(i + 1) * n], c[i * n:(i + 1) * n]
        assert sorted(len(r["prompt"]) for r in blk_a) == \
            sorted(len(r["prompt"]) for r in blk_c) == \
            sorted(len(r["prompt"]) for r in a[:n])
        assert sorted(r["max_tokens"] for r in blk_a) == \
            sorted(r["max_tokens"] for r in blk_c)
    assert [len(r["prompt"]) for r in a[:n]] != \
        [len(r["prompt"]) for r in c[:n]]
    got = g.prompts(mix, SEED, 32000, [5, 2 * n + 1])
    assert set(got) == {5, 2 * n + 1}
    assert (got[2 * n + 1] == a[2 * n + 1]["prompt"]).all()


def test_live_blocks_peak():
    from portbench.readings import live_blocks_peak
    recs = [
        # 20 prompt tokens: 2 pages from the prefill's start (at 0.5); a
        # third once 13 tokens are fed back (at the 14th token's frame)
        {"send": 0.0, "prompt_len": 20, "done": {"prefill_s": 0.5},
         "times": [1.0 + i for i in range(14)]},
        # 16 prompt tokens: 1 page from 5.5, 2 from its second token's
        # frame
        {"send": 5.0, "prompt_len": 16, "done": {"prefill_s": 0.5},
         "times": [6.0, 7.0, 8.0]},
        # sent and never answered: no pages
        {"send": 1.0, "prompt_len": 99, "done": None, "times": []},
    ]
    assert live_blocks_peak(recs, 16, 0.0, 100.0) == 4
    assert live_blocks_peak(recs, 16, 0.0, 0.5) == 0
    assert live_blocks_peak(recs, 16, 0.0, 5.0) == 2
    assert live_blocks_peak(recs, 16, 13.5, 100.0) == 3
    assert live_blocks_peak(recs, 16, 14.5, 100.0) == 0
