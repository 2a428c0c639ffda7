"""``elementwise_ms.train``: the train loop's unfused passes
(``compute/train.py``'s ``AdamW``, the casts, the activations) — device
ms a step in the frozen kernel grouping's ``elementwise`` group
(``roofline/groups.py``)."""

from portbench import readings


def read(run, device):
    if readings.peaks(device) is None or run.trace is None:
        return None
    return readings.group_seconds(run.trace, "elementwise") * 1e3 \
        / run.data["traced_steps"]
