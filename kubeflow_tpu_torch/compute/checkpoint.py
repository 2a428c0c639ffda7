"""Checkpoint/resume of a ``TrainState`` — the compute-layer half of the
platform's suspend/resume story.

Port of ``kubeflow_tpu/compute/checkpoint.py``, with ``torch.save`` in
place of orbax: each checkpoint is ``<directory>/<step>/state.pt``,
written into a hidden temporary directory first and renamed into place,
so a crash mid-save never leaves a step that looks complete. The save
copies the state to host memory at once (the only blocking part) and,
with ``async_save``, writes it from a background thread while the next
steps run; one save is in flight at a time. A state on a mesh is saved
as its LOGICAL tensors (each ``Sharded`` leaf gathered to the host), so
the files do not depend on the mesh; restore places each tensor as the
target state's leaf is placed — cut over the target's mesh by its
spec, or on its device — so a checkpoint saved on one mesh restores
onto another or onto one device (orbax's reshard on load, JAX
``checkpoint.py:51-66``).

Layout contract with the platform, as in JAX: checkpoints live under
the workspace PVC at ``<workspace>/checkpoints/<run>/<step>/``.
"""

import os
import shutil
import threading

import torch

from . import sharding as sharding_lib
from .train import TrainState, tree_leaves, tree_map

_FILE = "state.pt"


def _host_copy(state):
    """The state as a plain dict of logical tensors, every one a COPY in
    host memory (the optimizer updates the live tensors in place)."""
    return {"step": int(state.step),
            "params": sharding_lib.gather_tree(state.params),
            "opt_state": sharding_lib.gather_tree(state.opt_state),
            "extra": sharding_lib.gather_tree(state.extra)}


def _like(saved, target):
    """A restored tensor placed as ``target`` is: on its mesh by its
    spec, or on its device."""
    if isinstance(target, sharding_lib.Sharded):
        return sharding_lib.place(saved, target.spec, target.mesh)
    if torch.is_tensor(target):
        return saved.to(target.device)
    return saved


class Checkpointer:
    """Save, list and restore the steps of one run's directory.

    ``save_interval_steps`` and ``max_to_keep`` as orbax's
    ``CheckpointManagerOptions``: a save is taken when the step is a
    multiple of the interval and newer than the latest (``force``
    skips both checks), and only the newest ``max_to_keep`` steps stay
    on disk."""

    def __init__(self, directory, max_to_keep=3, save_interval_steps=1,
                 async_save=True):
        self.directory = os.path.abspath(os.fspath(directory))
        os.makedirs(self.directory, exist_ok=True)
        self.max_to_keep = max_to_keep
        self.save_interval_steps = save_interval_steps
        self.async_save = async_save
        self._thread = None
        self._in_flight = None
        self._error = None

    def _path(self, step):
        return os.path.join(self.directory, str(step))

    def save(self, state, force=False):
        """Save ``state`` at ``state.step`` → True, or False when the
        interval or an equal/newer checkpoint says not to. Raises if the
        step is already saved and ``force`` asks for it again."""
        step = int(state.step)
        if not force:
            latest = self.latest_step()
            if (latest is not None and latest >= step) \
                    or step % self.save_interval_steps:
                return False
        if step in self.all_steps():
            raise ValueError(f"step {step} is already checkpointed in "
                             f"{self.directory}")
        self.wait()
        host = _host_copy(state)
        if self.async_save:
            self._in_flight = step
            self._thread = threading.Thread(
                target=self._write_guarded, args=(step, host), daemon=True)
            self._thread.start()
        else:
            self._write(step, host)
        return True

    def _write_guarded(self, step, host):
        try:
            self._write(step, host)
        except Exception as e:  # surfaced by wait()
            self._error = e

    def _write(self, step, host):
        tmp = os.path.join(self.directory, f".{step}.tmp-{os.getpid()}")
        shutil.rmtree(tmp, ignore_errors=True)
        os.makedirs(tmp)
        torch.save(host, os.path.join(tmp, _FILE))
        os.replace(tmp, self._path(step))
        if self.max_to_keep:
            for old in self._on_disk()[:-self.max_to_keep]:
                shutil.rmtree(self._path(old), ignore_errors=True)

    def _on_disk(self):
        return sorted(int(n) for n in os.listdir(self.directory)
                      if n.isdigit()
                      and os.path.isfile(os.path.join(self._path(n), _FILE)))

    def restore(self, target_state, step=None):
        """The saved state at ``step`` (None → the latest) placed as
        ``target_state`` is (its mesh and specs, or its device), its
        float params requiring grad, or None when there is no
        checkpoint. Raises if the saved tree does not match the target's
        shapes."""
        self.wait()
        if step is None:
            step = self.latest_step()
        if step is None:
            return None
        saved = torch.load(os.path.join(self._path(step), _FILE),
                           map_location="cpu", weights_only=True)
        got = [tuple(t.shape) for t in tree_leaves(saved["params"])]
        want = [tuple(t.shape) for t in tree_leaves(target_state.params)]
        if got != want:
            raise ValueError(f"checkpoint {step} holds params of shapes "
                             f"{got}, the target {want}")

        def restored(name):
            return tree_map(_like, saved[name], getattr(target_state, name))

        params = restored("params")
        for t in sharding_lib.pieces_of(tree_leaves(params)):
            if t.is_floating_point():
                t.requires_grad_(True)
        return TrainState(step=saved["step"], params=params,
                          opt_state=restored("opt_state"),
                          extra=restored("extra"))

    def latest_step(self):
        steps = self.all_steps()
        return steps[-1] if steps else None

    def all_steps(self):
        """Saved steps, oldest first, the one being written included."""
        steps = set(self._on_disk())
        if self._in_flight is not None:
            steps.add(self._in_flight)
        return sorted(steps)

    def wait(self):
        """Block until the pending async save is durable; raise its
        error if it failed."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
            self._in_flight = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    def close(self):
        self.wait()


def restore_or_init(directory, init_fn, **kwargs):
    """The resume idiom for workload entrypoints: returns
    ``(checkpointer, state, resumed_bool)``."""
    ckpt = Checkpointer(directory, **kwargs)
    state = init_fn()
    if ckpt.latest_step() is not None:
        restored = ckpt.restore(state)
        if restored is not None:
            return ckpt, restored, True
    return ckpt, state, False
