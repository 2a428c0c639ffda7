"""Training traffic: rows of packed documents, drawn from the seed on
the device, with a Zipf-like frequency of token ids over the
vocabulary.

Mix parameters (``traffic/<name>.json``): ``batch`` rows of ``seq``
tokens a step, ``zipf_exponent``, ``mean_doc_tokens``, ``separator_id``,
``permutation_seed``.

A token's rank ``r`` (1 = most frequent) is drawn with probability
``∝ r^-exponent``; ranks map to ids through one fixed permutation of
the vocabulary (the same for every seed, so every seed routes a text of
the same shape). Documents end where a position draws a boundary, with
probability ``1 / mean_doc_tokens`` (geometric lengths); the boundary
position holds ``separator_id``. Rows are ``seq + 1`` long: the tokens
are the first ``seq``, the targets the last ``seq``."""

import torch


def zipf_probs(vocab, exponent, device):
    ranks = torch.arange(1, vocab + 1, dtype=torch.float64, device=device)
    p = ranks.pow(-float(exponent))
    return (p / p.sum()).float()


def packed_rows(mix, seed, n_batches, vocab, device):
    """``[n_batches, batch, seq + 1]`` int64 token ids."""
    batch, seq = int(mix["batch"]), int(mix["seq"])
    g = torch.Generator(device=device)
    g.manual_seed(int(mix.get("permutation_seed", 0)))
    perm = torch.randperm(vocab, generator=g, device=device)
    g.manual_seed((int(seed) * 6_700_417 + 11) % (2 ** 63))
    probs = zipf_probs(vocab, mix["zipf_exponent"], device)
    shape = (n_batches, batch, seq + 1)
    ranks = torch.multinomial(probs, n_batches * batch * (seq + 1),
                              replacement=True, generator=g)
    ids = perm[ranks].reshape(shape)
    ends = torch.rand(shape, generator=g, device=device) \
        < 1.0 / float(mix["mean_doc_tokens"])
    return torch.where(ends, int(mix["separator_id"]), ids)
