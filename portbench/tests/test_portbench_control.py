"""The control at a size a test run holds: the reference computed one
precision below the configuration's (float8 products) in the program's
place fails the tiny cell's limits, where the program passes them; so
does half of each batch left out. ``portbench.control`` makes the same
readings on the card at the cell's own size."""

import json

from portbench import control


def readings(capsys, *args, **kw):
    capsys.readouterr()
    control.readings(*args, **kw)
    return [json.loads(line) for line in capsys.readouterr().out.splitlines()
            if line.startswith("{")]


def over(reading, limits):
    return {k for k, lim in limits.items() if not reading[k] <= lim}


def test_training_control_and_half_batch_fail(bench, tiny_train, capsys):
    cfg, mix, st = tiny_train
    got = readings(capsys, bench, "mixtral-8x7b.train-4k", [11, 12], {11},
                   1, device="cpu", config=cfg, settings=st, mix=mix)
    by = {(r["seed"], r["reading"]): r for r in got}
    lim = st["limits"]
    assert not over(by[11, "program"], lim) and not over(by[12, "program"],
                                                         lim)
    assert over(by[11, "control"], lim)
    assert "loss_rel_gap" in over(by[11, "half_batch"], lim)


def test_serving_control_fails(bench, tiny_serve, capsys):
    cfg, mix, st = tiny_serve
    got = readings(capsys, bench, "mistral-7b.docqa", [21], {21}, 3,
                   device="cpu", config=cfg, settings=st, mix=mix)
    by = {r["reading"]: r for r in got}
    assert by["program"]["widest_gap"] <= st["limits"]["widest_gap"]
    assert by["program"]["unfinished"] == 0
    assert by["control"]["widest_gap"] > st["limits"]["widest_gap"]
