"""``moe_pad_pct.serve``: the grouped matmul's padding in serving
(``models/transformer.py``'s expert layers on K6) — the padded rows
that hold no token-expert row, over all padded rows (the growth of the
engine's ``moe_padded_rows_total`` and ``moe_assignments_total``)
across the window less each traced stretch, in %; nothing where the
engine books no expert calls."""

from portbench.counters import untraced_growth


def read(run, device):
    got = untraced_growth(run, "moe_padded_rows_total",
                          "moe_assignments_total")
    if got is None:
        return None
    padded, rows = got
    return 100.0 * (padded - rows) / padded if padded else None
