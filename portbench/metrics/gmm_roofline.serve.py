"""``gmm_roofline.serve``: K6 (``ops/grouped_matmul.py``) in serving —
the least time the card could take for the grouped products of the
expert layer calls in the traced stretch, over K6's device time in the
trace, in %; nothing where the engine books no expert calls.

The decode steps and the prefills are bounded apart and the bounds
added (``roofline/afmoe.py``'s ``gmm_serve``: each routed row read and
written once and each active expert's weights read once, for gate|up
and down): decode over the rows of the tokens decoded in the stretch
(``decode_token_slots`` × top-k × expert layers; a step's idle slots
are computed, but are no work) and the experts its calls found active
(``moe_decode_active_experts_total``, idle slots' choices among them);
a prefill call at its mean rows and active experts (the growth of
``moe_calls``, ``moe_assignments_total`` and
``moe_active_experts_total`` less the decode step's), times the
calls. A bound of a mean reads low, never high, where calls differ."""

from portbench import readings
from portbench.roofline import afmoe, kernels

KEYS = ("moe_calls", "moe_assignments_total", "moe_active_experts_total",
        "moe_decode_calls", "moe_decode_assignments_total",
        "moe_decode_active_experts_total", "decode_token_slots")


def read(run, device):
    pk, tr, sh = readings.peaks(device), run.trace, run.data.get("afmoe")
    st = run.data.get("trace_stats")
    if pk is None or tr is None or sh is None or st is None \
            or KEYS[3] not in st[0]:
        return None
    calls, rows, active, d_calls, d_rows, d_active, tokens = (
        st[1][k] - st[0][k] for k in KEYS)
    k6 = readings.group_seconds(tr, "K6 grouped_matmul")
    if not k6 or not calls:
        return None
    dt = run.data["itemsize"]
    dtype = "bfloat16" if dt == 2 else "float32"

    def least(rows, active):
        c = afmoe.gmm_serve(sh, rows, active, dt)
        return kernels.bound(sum(b for b, _ in c), sum(f for _, f in c),
                             dtype, pk)[0]
    t = least(tokens * sh.top_k * sh.moe_layers, d_active) if d_calls else 0
    p_calls = calls - d_calls
    if p_calls:
        t += p_calls * least((rows - d_rows) / p_calls,
                             (active - d_active) / p_calls)
    return 100.0 * t / k6
