"""Fault-tolerant checkpointing, in the reference's on-disk format.

* Atomic: a save writes ``step_<n>.tmp/`` and then renames it to
  ``step_<n>/``; a crash mid-write never corrupts the latest checkpoint.
* Versioned: ``latest`` is a pointer file, written last; the ``keep``
  newest checkpoints are retained and older ones removed.
* Async: ``save(..., blocking=False)`` copies the tree to the host, then
  writes it on a background thread while the train loop steps on; a failed
  write is retried.
* Self-describing: one ``.npy`` per leaf, unsharded, and a
  ``manifest.json`` with the step and each leaf's path key, file and
  dtype.  bfloat16 (which ``.npy`` cannot hold) is written as its
  ``uint16`` bits and read back through a torch view of the same bits.

A leaf's key is its path in the tree, "/"-joined: dict keys, list and
tuple indices, named-tuple field names.  The port's parameters keep one
block dict per layer (``layers/5/wq``); a checkpoint that the JAX package
wrote keys the reference's stacked tree (``scan/u0_attn/wq``).  Given the
model config, :meth:`CheckpointManager.restore` reads such a checkpoint
through the same unit-to-layer mapping as ``models.params.from_jax_numpy``.
"""

from __future__ import annotations

import json
import os
import shutil
import threading
import time
from typing import Any, Optional

import numpy as np
import torch

from repro_torch.models.params import map_tensors, reference_key


def _items(tree):
    if isinstance(tree, dict):
        return list(tree.items())
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return list(zip(tree._fields, tree))
    if isinstance(tree, (list, tuple)):
        return list(enumerate(tree))
    return None


def _flatten_with_paths(tree, prefix=()):
    items = _items(tree)
    if items is None:
        return [("/".join(prefix), tree)]
    return [kv for k, v in items
            for kv in _flatten_with_paths(v, prefix + (str(k),))]


def _to_host(t: torch.Tensor) -> np.ndarray:
    t = t.detach().to("cpu", copy=True)     # never an alias of the tree
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16)
    return t.numpy()


def _from_host(arr: np.ndarray, dtype_name: str) -> torch.Tensor:
    arr = np.array(arr)                 # an owned, writable copy
    if dtype_name == "bfloat16":
        return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(arr)


class CheckpointManager:
    def __init__(self, directory: str, keep: int = 3):
        self.dir = directory
        self.keep = keep
        os.makedirs(directory, exist_ok=True)
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None
        self.save_failures = 0

    # ------------------------------------------------------------- save --
    def save(self, step: int, tree: Any, blocking: bool = True,
             max_retries: int = 3):
        """Write ``tree`` (tensors in dicts, lists and tuples) as
        checkpoint ``step``.  The device-to-host copy happens here, so the
        caller may update the tree as soon as this returns."""
        host = [(key, leaf.dtype, _to_host(leaf))
                for key, leaf in _flatten_with_paths(tree)]

        def _write():
            for attempt in range(max_retries):
                try:
                    self._write_once(step, host)
                    return
                except OSError:
                    self.save_failures += 1
                    time.sleep(0.01 * (attempt + 1))
            raise RuntimeError(f"checkpoint save failed after "
                               f"{max_retries} retries")

        def _write_async():
            try:
                _write()
            except BaseException as e:   # re-raised by wait()
                self._error = e

        # an async save still running may be writing this very step's tmp
        # dir: serialize with it first
        self.wait()
        if blocking:
            _write()
        else:
            self._thread = threading.Thread(target=_write_async, daemon=True)
            self._thread.start()

    def _write_once(self, step: int, host):
        tmp = os.path.join(self.dir, f"step_{step}.tmp")
        final = os.path.join(self.dir, f"step_{step}")
        if os.path.exists(tmp):
            shutil.rmtree(tmp)
        os.makedirs(tmp)
        manifest = {"step": step, "leaves": []}
        for key, dtype, arr in host:
            fn = key.replace("/", "__") + ".npy"
            np.save(os.path.join(tmp, fn), arr)
            manifest["leaves"].append(
                {"key": key, "file": fn,
                 "dtype": str(dtype).removeprefix("torch.")})
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f)
        if os.path.exists(final):
            shutil.rmtree(final)
        os.replace(tmp, final)
        # pointer file written LAST -> atomic latest
        with open(os.path.join(self.dir, "latest.tmp"), "w") as f:
            f.write(str(step))
        os.replace(os.path.join(self.dir, "latest.tmp"),
                   os.path.join(self.dir, "latest"))
        self._gc()

    def wait(self):
        """Join a running async save; re-raise its failure, if any."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    def _gc(self):
        steps = sorted(self.all_steps())
        for s in steps[:-self.keep]:
            shutil.rmtree(os.path.join(self.dir, f"step_{s}"),
                          ignore_errors=True)

    # ---------------------------------------------------------- restore --
    def all_steps(self):
        out = []
        for d in os.listdir(self.dir):
            if d.startswith("step_") and not d.endswith(".tmp"):
                out.append(int(d.split("_")[1]))
        return sorted(out)

    def latest_step(self) -> Optional[int]:
        p = os.path.join(self.dir, "latest")
        if not os.path.exists(p):
            steps = self.all_steps()
            return steps[-1] if steps else None
        with open(p) as f:
            step = int(f.read().strip())
        if not os.path.exists(os.path.join(self.dir, f"step_{step}")):
            steps = self.all_steps()           # pointer ahead of a crash
            return steps[-1] if steps else None
        return step

    def restore(self, template: Any, step: Optional[int] = None,
                shardings: Any = None, *, cfg=None):
        """Restore into the structure of ``template``: each leaf takes the
        stored dtype and the template leaf's device.  Returns (tree,
        step).  A key the checkpoint lacks is looked up under the
        reference's path when ``cfg`` (the model config) is given, so a
        checkpoint of the JAX package restores into the port's tree.

        ``shardings`` (optional): ``(mesh, placements_tree)``, a torch
        ``DeviceMesh`` and a tree of the template's structure whose leaves
        are DTensor placements (``distributed.sharding.sharding_tree``),
        possibly for another mesh than the one the checkpoint was written
        under: each leaf is placed with ``distribute_tensor`` on the
        mesh's device type, as the reference places it with
        ``jax.device_put`` (the elastic-resharding path)."""
        step = step if step is not None else self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoint in {self.dir}")
        d = os.path.join(self.dir, f"step_{step}")
        with open(os.path.join(d, "manifest.json")) as f:
            manifest = json.load(f)
        by_key = {l["key"]: (l["file"], l["dtype"])
                  for l in manifest["leaves"]}
        leaves = iter(_flatten_with_paths(template))

        def load(leaf, placements=None):
            key, _ = next(leaves)
            unit = None
            if key not in by_key and cfg is not None:
                key, unit = reference_key(key, cfg)
            if key not in by_key:
                raise KeyError(f"checkpoint step {step} has no leaf {key!r}")
            fn, dtype_name = by_key[key]
            arr = np.load(os.path.join(d, fn), mmap_mode="r")
            if unit is not None:
                arr = arr[unit]
            t = _from_host(arr, dtype_name)
            if placements is None:
                return t.to(leaf.device)
            return distribute_tensor(t.to(mesh.device_type), mesh,
                                     placements)

        if shardings is None:
            return map_tensors(load, template), step
        from torch.distributed.tensor import distribute_tensor
        mesh, tree = shardings
        return map_tensors(load, template, tree), step
