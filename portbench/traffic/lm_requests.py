""":generate requests: prompts and answer lengths, sent either by a
closed loop of callers or on an open-loop schedule.

A mix with ``clients`` is a closed loop: that many callers, each
sending its next request as soon as its last one has finished (an
offline batch job that keeps ``clients`` requests in flight). The
callers start one after another over the first half of ``lead_s``; the
window opens ``lead_s`` after the first start and no request is sent
after it closes. They take requests in turn from one endless
:func:`sequence`, made in blocks of ``clients`` requests; each block
holds the same multiset of prompt and answer lengths (stratified
quantiles of the mix's distributions) in the seed's own order, with the
seed's own token ids, so seeds change the order of the work and not its
amount.

Given a rate instead (``portbench.sweep_rate``), :func:`schedule` lays
the requests out as an open loop: due on a schedule whether or not
earlier ones have finished, in three phases: ``lead_s`` seconds before
the window (the load builds up; not counted), the window of
``--seconds`` (counted) and ``tail_s`` after it (keeps the load on while
the window's last requests finish; not counted). Each phase holds
``round(rate × length)`` requests, stratified as above.

Mix parameters (``traffic/<name>.json``):

- ``prompt_tokens`` / ``output_tokens``: ``{"dist": "loguniform" |
  "uniform", "min", "max"}``;
- ``shared_prefix_tokens``: a prefix of this many tokens, drawn once a
  seed, that every prompt starts with (0: none);
- ``repeats_per_document``: each document is asked this many times,
  with a fresh question of ``question_tokens`` tokens after it, the
  repeats spread over the block or phase (1: every prompt unique);
- ``burst_factor``: open-loop arrivals come in groups of this many,
  :data:`BURST_GAP_S` apart within a group, the groups Poisson at
  ``rate / burst_factor`` (1: plain Poisson);
- ``clients``: the closed loop's callers;
- ``lead_s``, ``tail_s``: the time before and after the window;
- ``warmup_requests``, ``warmup_output_tokens``: the set-up's one
  concurrent pass (prompt lengths at evenly spaced quantiles of the
  mix).
"""

import itertools
import math

import numpy as np

#: seconds between the arrivals of one open-loop burst
BURST_GAP_S = 0.005


def _quantiles(n):
    return (np.arange(n) + 0.5) / max(n, 1)


def _lengths(dist, n):
    """``n`` lengths at evenly spaced quantiles of ``dist``."""
    q = _quantiles(n)
    lo, hi = float(dist["min"]), float(dist["max"])
    if dist["dist"] == "loguniform":
        vals = np.exp(math.log(lo) + q * (math.log(hi) - math.log(lo)))
    elif dist["dist"] == "uniform":
        vals = lo + q * (hi - lo)
    else:
        raise ValueError(f"unknown length distribution {dist['dist']!r}")
    return np.rint(vals).astype(np.int64)


def _arrivals(n, length, burst, rng):
    """``n`` arrival offsets in ``[0, length)``: Poisson (exponential
    gaps at stratified quantiles, in the seed's order, scaled to fill the
    phase), in groups of ``burst``."""
    if n == 0:
        return np.zeros((0,))
    groups = -(-n // burst)
    gaps = -np.log1p(-_quantiles(groups))
    gaps = rng.permutation(gaps)
    gaps *= length / gaps.sum()
    starts = np.cumsum(gaps) - gaps / 2
    times = np.concatenate([starts[i] + BURST_GAP_S * np.arange(
        min(burst, n - i * burst)) for i in range(groups)])
    return np.minimum(times, length * (1 - 1e-9))


def _block(mix, n, rng, vocab, prefix):
    """``n`` requests ``{"prompt", "max_tokens"}``: the mix's lengths at
    stratified quantiles, in the seed's order."""
    outs = rng.permutation(_lengths(mix["output_tokens"], n))
    repeats = max(1, int(mix.get("repeats_per_document", 1) or 1))
    question = int(mix.get("question_tokens", 0)) if repeats > 1 else 0
    n_docs = -(-n // repeats)
    doc_lens = rng.permutation(_lengths(mix["prompt_tokens"], n_docs)) \
        - len(prefix) - question
    if n and doc_lens.min() < 1:
        raise ValueError("prompt_tokens.min must exceed the shared prefix "
                         "and the question")
    docs = [rng.integers(0, vocab, int(m)) for m in doc_lens]
    which = rng.permutation(np.arange(n) % n_docs)
    reqs = []
    for i in range(n):
        parts = [prefix, docs[which[i]]]
        if question:
            parts.append(rng.integers(0, vocab, question))
        reqs.append({"prompt": np.concatenate(parts).astype(np.int64),
                     "max_tokens": int(outs[i])})
    return reqs


def _prefix(mix, rng, vocab):
    return rng.integers(0, vocab, int(mix.get("shared_prefix_tokens", 0)))


def sequence(mix, seed, vocab):
    """The closed loop's requests, endless, in the order the callers
    take them: ``{"id", "prompt" (int64 ids), "max_tokens"}``."""
    rng = np.random.default_rng(int(seed))
    prefix = _prefix(mix, rng, vocab)
    n = int(mix["clients"])
    ids = itertools.count()
    while True:
        for r in _block(mix, n, rng, vocab, prefix):
            r["id"] = next(ids)
            yield r


def schedule(mix, rate, seed, window_s, vocab):
    """The requests of one open-loop run, due-ordered: ``{"id", "phase"
    ("lead" | "window" | "tail"), "due" (seconds from the schedule's
    start; the window is ``[lead_s, lead_s + window_s)``), "prompt"
    (int64 ids), "max_tokens"}``."""
    rng = np.random.default_rng(int(seed))
    prefix = _prefix(mix, rng, vocab)
    burst = max(1, int(mix.get("burst_factor", 1) or 1))
    lead, tail = float(mix["lead_s"]), float(mix["tail_s"])
    out = []
    for phase, start, length in (("lead", 0.0, lead),
                                 ("window", lead, float(window_s)),
                                 ("tail", lead + float(window_s), tail)):
        n = int(round(rate * length))
        due = _arrivals(n, length, burst, rng)
        for d, r in zip(due, _block(mix, n, rng, vocab, prefix)):
            r["due"] = start + float(d)
            r["phase"] = phase
            out.append(r)
    out.sort(key=lambda r: r["due"])
    for i, r in enumerate(out):
        r["id"] = i
    return out


def prompts(mix, seed, vocab, ids, rate=None, window_s=None):
    """``{id: prompt}`` of the requests ``ids`` (the closed loop's, or,
    with a rate, the open-loop schedule's)."""
    ids = set(ids)
    if rate:
        reqs = schedule(mix, rate, seed, window_s, vocab)
    else:
        reqs = itertools.islice(sequence(mix, seed, vocab),
                                max(ids, default=-1) + 1)
    return {r["id"]: r["prompt"] for r in reqs if r["id"] in ids}


def warmup(mix, seed, vocab):
    """The set-up's concurrent pass: ``warmup_requests`` prompts at
    evenly spaced quantiles of the prompt lengths (the longest among
    them), ``warmup_output_tokens`` tokens each."""
    rng = np.random.default_rng(int(seed) + 1)
    n = int(mix["warmup_requests"])
    lens = _lengths(mix["prompt_tokens"], n)
    lens[-1] = int(mix["prompt_tokens"]["max"])
    return [{"id": -1 - i, "phase": "warmup", "due": 0.0,
             "prompt": rng.integers(0, vocab, int(m)).astype(np.int64),
             "max_tokens": int(mix["warmup_output_tokens"])}
            for i, m in enumerate(lens)]
