"""Data pipeline: host numpy batches → tensors on the device or pieces
on a mesh.

Port of ``kubeflow_tpu/compute/data.py``. A background thread keeps
``depth`` batches ahead, so the host→device copy overlaps the step:
batches for the card go through pinned host memory with
``non_blocking`` copies on the current stream, which orders them before
the step that reads them. ``to_device`` moves a batch to one device;
``shard_batch`` (JAX :30) cuts it over a mesh by ``BATCH_SPEC``: dim 0
over ``(data, fsdp)`` in that order, each piece copied to every
position with those coordinates (replicated over the other axes). A
batch that does not divide is refused (JAX pads). The synthetic
sources stay numpy, from a seed, so the port and the JAX package read
the same batches; ``mnist`` (JAX :155) reads a local idx tree, or falls
back to the synthetic source (nothing is downloaded).
"""

import queue
import threading
import time

import numpy as np
import torch

from . import mesh as mesh_lib
from . import sharding as sharding_lib

#: a batch leaf's dim 0 over (data, fsdp), JAX's ``BATCH_SPEC`` (:22)
BATCH_SPEC = ((mesh_lib.DATA, mesh_lib.FSDP),)


def _tensor(x):
    return torch.as_tensor(np.asarray(x)) if not torch.is_tensor(x) else x


def to_device(batch, device):
    """A dict of numpy arrays (or tensors) → the same dict of tensors on
    ``device``; host memory is pinned for a card so the copy can run
    asynchronously."""
    device = torch.device(device)
    out = {}
    for name, x in batch.items():
        t = _tensor(x)
        if device.type == "cuda" and t.device.type == "cpu":
            t = t.pin_memory()
        out[name] = t.to(device, non_blocking=True)
    return out


def batch_sharding(mesh, spec=BATCH_SPEC):
    return sharding_lib.NamedSharding(mesh, tuple(spec))


def shard_batch(batch, mesh, spec=BATCH_SPEC):
    """A dict of host arrays (or tensors) → the same dict of
    ``sharding.Sharded`` leaves on ``mesh``: each position holds a copy
    of its piece. Raises ``ValueError`` naming a leaf that does not
    divide."""
    return {name: sharding_lib.place(_tensor(x), spec, mesh,
                                     f"batch {name!r}")
            for name, x in batch.items()}


class Prefetcher:
    """Wrap a host-batch iterator; overlap host→device transfer with
    compute by staying ``depth`` batches ahead: ``shard_batch`` by
    ``spec`` onto a mesh, ``to_device`` onto a device.

    Supports the context-manager protocol: an abandoned iterator (early
    ``break``, an exception in the training loop) would otherwise leak
    the pump thread blocked forever on its full queue — ``with`` (or an
    explicit :meth:`close`) unblocks and joins it."""

    _DONE = object()

    def __init__(self, iterator, mesh_or_device, spec=BATCH_SPEC,
                 depth=2):
        self._q = queue.Queue(maxsize=depth)
        self._err = None
        self._closed = False
        if isinstance(mesh_or_device, mesh_lib.Mesh):
            def put(item):
                return shard_batch(item, mesh_or_device, spec)
        else:
            def put(item):
                return to_device(item, mesh_or_device)

        def pump():
            try:
                for item in iterator:
                    if self._closed:
                        return
                    self._q.put(put(item))
                    # re-check AFTER the (blocking) put: close() is what
                    # unblocked it, and pulling one more item would
                    # consume a batch from the source
                    if self._closed:
                        return
            except Exception as e:  # surfaced on next()
                self._err = e
            finally:
                # close() keeps draining until this thread exits, so
                # this put cannot wedge even on a full queue
                self._q.put(self._DONE)

        self._thread = threading.Thread(target=pump, daemon=True)
        self._thread.start()

    def __iter__(self):
        return self

    def __next__(self):
        if self._closed:
            raise StopIteration
        item = self._q.get()
        if item is self._DONE:
            if self._err is not None:
                raise self._err
            raise StopIteration
        return item

    def close(self, timeout=5.0):
        """Stop the pump thread: drain the queue to unblock a put on a
        full queue, and join. Idempotent; safe after exhaustion. Don't
        call concurrently with ``next()``.

        ``timeout`` bounds the join: a pump wedged INSIDE the source
        iterator cannot be interrupted, and close() must not hang the
        caller's exit path on it — the daemon thread is abandoned after
        the deadline (it dies with the process)."""
        self._closed = True
        deadline = time.monotonic() + timeout
        while self._thread.is_alive():
            try:
                self._q.get_nowait()
            except queue.Empty:
                pass
            self._thread.join(timeout=0.05)
            if time.monotonic() > deadline:
                break

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False


# ----------------------------------------------------- synthetic sources

def synthetic_lm(batch_size, seq_len, vocab_size, seed=0, steps=None):
    """Deterministic random token stream (bench + tests); the same
    numbers as the JAX package's for one seed."""
    rng = np.random.default_rng(seed)
    i = 0
    while steps is None or i < steps:
        toks = rng.integers(0, vocab_size, (batch_size, seq_len),
                            dtype=np.int32)
        yield {"tokens": toks, "targets": np.roll(toks, -1, axis=1)}
        i += 1


def synthetic_images(batch_size, image_size, n_classes, seed=0,
                     steps=None, channels=3):
    rng = np.random.default_rng(seed)
    i = 0
    while steps is None or i < steps:
        yield {
            "image": rng.standard_normal(
                (batch_size, image_size, image_size, channels),
                dtype=np.float32),
            "label": rng.integers(0, n_classes, (batch_size,),
                                  dtype=np.int32),
        }
        i += 1


def mnist(path=None, split="train"):
    """MNIST from an idx file tree under ``path`` (gzipped
    ``train-``/``t10k-images-idx3-ubyte.gz`` and ``-labels-idx1-ubyte.gz``),
    batches of 128: images ``[B, 28, 28, 1]`` float32 in [0, 1], labels
    int32. Nothing is downloaded: without the tree, the synthetic
    source's batches of the same shapes."""
    import gzip
    import os

    if path is None or not os.path.isdir(path):
        yield from synthetic_images(128, 28, 10, channels=1)
        return
    prefix = "train" if split == "train" else "t10k"
    with gzip.open(os.path.join(
            path, f"{prefix}-images-idx3-ubyte.gz")) as f:
        images = np.frombuffer(f.read(), np.uint8, offset=16)
        images = images.reshape(-1, 28, 28, 1).astype(np.float32) / 255.0
    with gzip.open(os.path.join(
            path, f"{prefix}-labels-idx1-ubyte.gz")) as f:
        labels = np.frombuffer(f.read(), np.uint8, offset=8).astype(
            np.int32)
    for start in range(0, len(images), 128):
        sl = slice(start, start + 128)
        yield {"image": images[sl], "label": labels[sl]}
