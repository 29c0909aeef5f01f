"""Atomic, async checkpoint/restore with auto-resume (``repro.ckpt``).

Fault-tolerance contract:
  * atomicity — state is staged into ``step_N.tmp-<nonce>`` and renamed to
    ``step_N`` only when fully written, the MANIFEST last; a crash mid-write
    never corrupts the latest checkpoint, and half-written temp dirs are
    swept after a write and on restore;
  * snapshot, then async — ``save`` copies every tensor to host memory of
    its own before it returns (on the card a blocking device-to-host copy,
    on the CPU a clone), so an in-place update the caller makes next cannot
    reach the checkpoint; the files are then written on a background
    thread, off the train loop's critical path;
  * auto-resume — ``restore_latest`` picks the newest *valid* step (one
    with a MANIFEST);
  * retention — the ``keep`` most recent checkpoints are kept, older ones
    removed.

A tensor-parallel run (``launch/train.py --mesh-model``) checkpoints per
rank: each model rank's state (its shards, moments and masters) goes to a
directory of its own, written by data rank 0 only (every rank of a data
group holds the same state).  ``layout`` = (world, mesh_model) is recorded
in ``LAYOUT.json`` beside the checkpoints, and a manager opened under
another layout raises and names both; a directory without one holds a
single process's checkpoints, layout (1, 1).

A state is a tree of modules (their parameters, in order), tuples (named
or not), lists, dicts, tensors and Python scalars.  Leaves are stored as
raw ``.npy`` files (bf16 as its bit pattern), so a restore is bit-exact;
restoring rebuilds the tree of ``like`` with each tensor on the device of
its counterpart in ``like`` and each parameter keeping its
``requires_grad``.
"""

from __future__ import annotations

import json
import os
import secrets
import shutil
import threading

import numpy as np
import torch

from repro_torch.optim.adamw import with_leaves

_BITS = {torch.bfloat16: torch.int16}  # dtypes numpy cannot hold -> same-width ints


def _flatten(tree) -> list:
    """The leaves of ``tree`` in a fixed order (tensors and scalars)."""
    if isinstance(tree, torch.nn.Module):
        return list(tree.parameters())
    if isinstance(tree, (tuple, list)):
        return [leaf for x in tree for leaf in _flatten(x)]
    if isinstance(tree, dict):
        return [leaf for k in tree for leaf in _flatten(tree[k])]
    if tree is None:
        return []
    if isinstance(tree, (torch.Tensor, bool, int, float)):
        return [tree]
    raise TypeError(f"cannot checkpoint a {type(tree).__name__}")


def _unflatten(like, it):
    """A tree shaped as ``like`` whose leaves are drawn from ``it`` in
    ``_flatten``'s order."""
    if isinstance(like, torch.nn.Module):
        return with_leaves(like, [next(it) for _ in like.parameters()])
    if isinstance(like, tuple) and hasattr(like, "_fields"):  # a NamedTuple
        return type(like)(*[_unflatten(x, it) for x in like])
    if isinstance(like, (tuple, list)):
        return type(like)(_unflatten(x, it) for x in like)
    if isinstance(like, dict):
        return {k: _unflatten(v, it) for k, v in like.items()}
    if like is None:
        return None
    return next(it)


def _to_host(x) -> np.ndarray:
    """A host copy of one leaf that nothing else writes."""
    if isinstance(x, torch.Tensor):
        t = x.detach()
        t = t.to("cpu") if t.device.type != "cpu" else t.clone()  # blocking copy / own clone
        if t.dtype in _BITS:
            t = t.view(_BITS[t.dtype])
        return t.numpy()
    return np.asarray(x)


def rank_dir(directory: str, layout: tuple, model_rank: int) -> str:
    """Where model rank ``model_rank`` of a run of ``layout`` = (world,
    mesh_model) keeps its checkpoints under ``directory``: the directory
    itself for a single process, ``model<r>`` in it otherwise."""
    return directory if tuple(layout) == (1, 1) else os.path.join(directory, f"model{model_rank}")


def check_layout(directory: str, layout: tuple, write: bool = False) -> None:
    """Raise unless the checkpoints under ``directory`` were made by a run
    of ``layout`` = (world, mesh_model) (or there are none); ``write``
    records the layout when none is recorded yet."""
    layout = tuple(int(x) for x in layout)
    path = os.path.join(directory, "LAYOUT.json")
    if os.path.exists(path):
        with open(path) as f:
            saved = json.load(f)
        saved = (saved["world"], saved["mesh_model"])
    elif any(name.startswith("step_") for name in os.listdir(directory)):
        saved = (1, 1)  # a single process's checkpoints, from before layouts were recorded
    else:
        saved = None
    if saved is not None and saved != layout:
        raise ValueError(f"the checkpoints in {directory} are of world {saved[0]} with "
                         f"--mesh-model {saved[1]}; this run is world {layout[0]} with "
                         f"--mesh-model {layout[1]}: restore them under their own layout")
    if write and saved is None:
        tmp = f"{path}.tmp-{secrets.token_hex(4)}"
        with open(tmp, "w") as f:
            json.dump({"world": layout[0], "mesh_model": layout[1]}, f)
        os.replace(tmp, path)


class CheckpointManager:
    def __init__(self, directory: str, keep: int = 3):
        self.dir = directory
        self.keep = keep
        os.makedirs(directory, exist_ok=True)
        self._thread: threading.Thread | None = None
        self._error: BaseException | None = None  # a background write's failure
        self._lock = threading.Lock()

    # ------------------------------------------------------------------ save
    def save(self, step: int, state, blocking: bool = False) -> None:
        """Snapshot ``state`` at ``step``: the host copy is complete when
        this returns; the files are written now (``blocking``) or on a
        background thread (``wait()`` joins it)."""
        leaves = _flatten(state)
        host = [_to_host(x) for x in leaves]
        dtypes = [str(x.dtype).removeprefix("torch.") if isinstance(x, torch.Tensor)
                  else type(x).__name__ for x in leaves]
        self.wait()
        if blocking:
            self._write(step, host, dtypes)
        else:
            self._thread = threading.Thread(target=self._write_in_background,
                                            args=(step, host, dtypes), daemon=True)
            self._thread.start()

    def wait(self) -> None:
        """Join the background write; raise its error if it failed."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    def _write_in_background(self, step: int, host_leaves: list, dtypes: list) -> None:
        try:
            self._write(step, host_leaves, dtypes)
        except BaseException as e:  # handed to the caller's next wait()
            self._error = e

    def _write(self, step: int, host_leaves: list, dtypes: list) -> None:
        with self._lock:
            final = os.path.join(self.dir, f"step_{step:012d}")
            tmp = f"{final}.tmp-{secrets.token_hex(4)}"
            os.makedirs(tmp, exist_ok=True)
            for i, arr in enumerate(host_leaves):
                np.save(os.path.join(tmp, f"leaf_{i}.npy"), arr)
            manifest = {"step": step, "n_leaves": len(host_leaves), "dtypes": dtypes}
            with open(os.path.join(tmp, "MANIFEST.json"), "w") as f:
                json.dump(manifest, f)
            if os.path.exists(final):
                shutil.rmtree(final)
            os.rename(tmp, final)
            self._gc()

    def _gc(self) -> None:
        steps = self.all_steps()
        for s in steps[: -self.keep] if self.keep else []:
            shutil.rmtree(os.path.join(self.dir, f"step_{s:012d}"), ignore_errors=True)
        self._sweep()

    def _sweep(self) -> None:
        """Remove temp dirs that no write of this manager is filling."""
        for name in os.listdir(self.dir):
            if ".tmp-" in name:
                shutil.rmtree(os.path.join(self.dir, name), ignore_errors=True)

    # --------------------------------------------------------------- restore
    def all_steps(self) -> list[int]:
        steps = []
        for name in sorted(os.listdir(self.dir)):
            if not name.startswith("step_") or ".tmp-" in name:
                continue
            if os.path.exists(os.path.join(self.dir, name, "MANIFEST.json")):
                steps.append(int(name.split("_")[1]))
        return sorted(steps)

    def latest_step(self) -> int | None:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def restore(self, step: int, like):
        """The state saved at ``step``, shaped as ``like``, each tensor on
        the device of its counterpart in ``like``."""
        path = os.path.join(self.dir, f"step_{step:012d}")
        with open(os.path.join(path, "MANIFEST.json")) as f:
            manifest = json.load(f)
        leaves = _flatten(like)
        if manifest["n_leaves"] != len(leaves):
            raise ValueError(f"checkpoint of step {step} holds {manifest['n_leaves']} leaves, "
                             f"the state {len(leaves)}: the tree structure changed")
        out = []
        for i, (want, dtype) in enumerate(zip(leaves, manifest["dtypes"])):
            arr = np.load(os.path.join(path, f"leaf_{i}.npy"))
            if not isinstance(want, torch.Tensor):
                out.append(type(want)(arr.item()))
                continue
            t = torch.from_numpy(arr)
            dt = getattr(torch, dtype)
            t = t.view(dt) if dt in _BITS else t
            out.append(t.to(want.device))
        return _unflatten(like, iter(out))

    def restore_latest(self, like):
        """-> (step, state) from the newest valid checkpoint, or (None, None).
        Half-written temp dirs (a crashed save) are swept first."""
        self.wait()
        self._sweep()
        step = self.latest_step()
        if step is None:
            return None, None
        return step, self.restore(step, like)
