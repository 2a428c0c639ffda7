"""The ``:generate`` client, run as a child process so that its sends
and reads do not share the server's interpreter lock::

    python3 -m portbench.client < job.json

The job (one JSON object on standard input) names the server
(``host``, ``port``, ``model``), the traffic mix, ``rate`` (null for the
mix's closed loop), ``seed``, ``window_s``, ``vocab`` and ``wait_s``.
The client draws the same requests as the parent from the same
generator, sends the set-up's warm-up pass (all at once) and waits for
it, prints ``{"event": "ready", "base": t}`` (``t`` the monotonic time
the loop starts at) and then runs the loop: the mix's ``clients``
callers, each sending its next request when its last has finished, the
window opening at ``t + lead_s``; or, with a rate, every request of the
open-loop schedule at ``t + due``, one connection each, whether or not
earlier ones have finished. A request is due when it is sent in the
closed loop and at its schedule's time in the open one; it belongs to
the window when that time lies inside. The client records the send
time, the arrival of every token frame and the done frame. When every
request of the window has finished, or ``wait_s`` after the window has
closed, it stops, disconnects what is still open (the server cancels
those slots) and prints ``{"event": "records", ...}``. Times are
``time.monotonic()``, the clock the parent reads too."""

import asyncio
import json
import os
import sys
import time

from .traffic import generator


async def _send(host, port, path, body, rec):
    rec["send"] = time.monotonic()
    reader, writer = await asyncio.open_connection(host, port)
    try:
        writer.write(b"POST " + path + b" HTTP/1.1\r\nHost: bench\r\n"
                     b"Content-Type: application/json\r\nContent-Length: "
                     + str(len(body)).encode() + b"\r\nConnection: close"
                     b"\r\n\r\n" + body)
        await writer.drain()
        status = await reader.readline()
        while (await reader.readline()) not in (b"\r\n", b""):
            pass
        code = int(status.split()[1])
        if code != 200:
            rec["error"] = f"{code} {(await reader.read())[:200]!r}"
            return
        while True:
            n = int((await reader.readline()).strip() or b"0", 16)
            if n == 0:
                break
            data = await reader.readexactly(n + 2)
            t = time.monotonic()
            for line in data[:-2].splitlines():
                frame = json.loads(line)
                if "token" in frame:
                    rec["times"].append(t)
                    rec["tokens"].append(frame["token"])
                elif frame.get("done"):
                    rec["done"] = {k: frame.get(k) for k in (
                        "reason", "ttft_s", "prefill_s", "tokens")}
    finally:
        writer.close()


async def _one(host, port, path, req, due, phase, stop, recs):
    rec = {"id": req["id"], "phase": phase, "due": due,
           "prompt_len": int(len(req["prompt"])),
           "max_tokens": req["max_tokens"], "times": [], "tokens": [],
           "done": None, "error": None, "send": None}
    recs.append(rec)
    await asyncio.sleep(max(0.0, due - time.monotonic()))
    if stop.is_set():
        rec["error"] = "not sent"
        return
    body = json.dumps({"tokens": req["prompt"].tolist(),
                       "max_tokens": req["max_tokens"]}).encode()
    try:
        await _send(host, port, path, body, rec)
    except asyncio.CancelledError:
        rec["error"] = "disconnected"
        raise
    except (OSError, ValueError, asyncio.IncompleteReadError) as e:
        rec["error"] = f"{type(e).__name__}: {e}"


def _open_loop(job, gen, send, base, stop):
    """The schedule's requests, each sent at its due time → ``(tasks,
    the window's tasks)``."""
    sched = gen.schedule(job["mix"], job["rate"], job["seed"],
                         job["window_s"], job["vocab"])
    tasks = [asyncio.create_task(send(r, base + r["due"], r["phase"], stop))
             for r in sched]
    return tasks, [t for t, r in zip(tasks, sched)
                   if r["phase"] == "window"]


def _closed_loop(job, gen, send, base, stop):
    """The mix's callers, started over the first half of the lead, each
    sending the sequence's next request when its last has finished, none
    after the window → ``(tasks, tasks)``: a caller ends when its last
    request of the window has."""
    mix = job["mix"]
    reqs = gen.sequence(mix, job["seed"], job["vocab"])
    n, lead = int(mix["clients"]), float(mix["lead_s"])
    w0 = base + lead
    w1 = w0 + float(job["window_s"])

    async def caller(i):
        await asyncio.sleep(max(0.0, base + i * lead / 2 / n
                                - time.monotonic()))
        while not stop.is_set():
            now = time.monotonic()
            if now >= w1:
                return
            await send(next(reqs), now, "window" if now >= w0 else "lead",
                       stop)

    tasks = [asyncio.create_task(caller(i)) for i in range(n)]
    return tasks, tasks


async def run(job):
    mix = job["mix"]
    gen = generator(mix["kind"])
    host, port = job["host"], job["port"]
    path = f"/v1/models/{job['model']}:generate".encode()
    warm_recs, now = [], time.monotonic()
    await asyncio.gather(*(_one(host, port, path, w, now, "warmup",
                                asyncio.Event(), warm_recs)
                           for w in gen.warmup(mix, job["seed"],
                                               job["vocab"])))
    bad = [r for r in warm_recs if r["done"] is None]
    if bad:
        return {"event": "records", "error": f"warm-up failed: "
                f"{bad[0]['error']}", "records": []}
    stop, recs = asyncio.Event(), []

    def send(req, due, phase, stop):
        return _one(host, port, path, req, due, phase, stop, recs)

    base = time.monotonic() + 0.25
    print(json.dumps({"event": "ready", "base": base}), flush=True)
    tasks, counted = (_open_loop if job.get("rate") else _closed_loop)(
        job, gen, send, base, stop)
    close = base + float(mix["lead_s"]) + float(job["window_s"])
    await asyncio.wait(counted, timeout=max(
        0.0, close + float(job["wait_s"]) - time.monotonic()))
    stop.set()
    for t in tasks:
        t.cancel()
    await asyncio.gather(*tasks, return_exceptions=True)
    return {"event": "records", "base": base, "records": recs}


def main():
    cpu = os.environ.get("PORTBENCH_CLIENT_CPU")
    if cpu:
        os.sched_setaffinity(0, {int(cpu)})
    job = json.loads(sys.stdin.read())
    out = asyncio.run(run(job))
    sys.stdout.write(json.dumps(out) + "\n")
    sys.stdout.flush()


if __name__ == "__main__":
    main()
