"""The numbers that decide ``correct``: how far what the timed path
produced lies from the reference."""

import statistics

import torch


def worst_leaf_gap(prog, ref, leaves=None):
    """``(gap, path)``: the largest ``|‖prog‖ − ‖ref‖|`` over the
    leaves, each measured against the larger of the reference's norm of
    that leaf and of the median leaf. ``prog`` and ``ref`` map a leaf's
    path to its norm; ``leaves`` restricts the leaves compared."""
    keys = sorted(ref if leaves is None else leaves)
    med = statistics.median(ref[k] for k in keys)
    worst = (0.0, None)
    for k in keys:
        gap = abs(prog[k] - ref[k]) / max(ref[k], med, 1e-30)
        if gap > worst[0] or worst[1] is None:
            worst = (gap, k)
    return worst


def moved_leaves(ref_grad, share=1e-3):
    """The leaves the reference's first gradient moves: those whose
    norm is at least ``share`` of the median leaf's. A leaf below it has
    a gradient that is nought to rounding, which Adam turns into steps
    of round-off alone."""
    med = statistics.median(ref_grad.values())
    return [k for k, v in ref_grad.items() if v >= share * med]


def train_numbers(prog, ref):
    """The training cell's compared numbers from the program's and the
    reference's readings (``{"loss": [...], "grad": {...}, "change":
    {...}}``) → ``{name: value}`` and the worst leaves."""
    loss_gap = max(abs(p - r) / abs(r) for p, r in zip(prog["loss"],
                                                        ref["loss"]))
    grad_gap, grad_leaf = worst_leaf_gap(prog["grad"], ref["grad"])
    change_gap, change_leaf = worst_leaf_gap(
        prog["change"], ref["change"], moved_leaves(ref["grad"]))
    return ({"loss_rel_gap": loss_gap, "grad_norm_gap": grad_gap,
             "change_norm_gap": change_gap},
            {"grad_norm_gap": grad_leaf, "change_norm_gap": change_leaf})


def served_gap(logits, tokens):
    """The widest gap by which a served token's logit lies below the
    best logit of the reference at its position: ``logits [n, V]``
    float32, ``tokens [n]``."""
    best = logits.max(dim=-1).values
    got = logits.gather(-1, tokens[:, None])[:, 0]
    return float((best - got).max())


def control_gap(ref_logits, low_logits):
    """The control's reading at the same positions: the reference's gap
    of the token that the lower precision puts first."""
    return served_gap(ref_logits, torch.argmax(low_logits, dim=-1))
