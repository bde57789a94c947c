"""Fault-tolerant checkpointing in the JAX package's on-disk format
(``checkpoint/checkpointer.py``), so that a checkpoint one package writes restores in
the other.

* Atomic: write to ``step_XXXXXXXXXX.tmp/`` then ``os.rename`` (crash-safe).
* Layout: one ``leaf_XXXXX.npy`` per leaf, numbered in ``jax.tree``'s order (a dict's
  values by sorted key, tuples and NamedTuples in order), and a ``manifest.json``
  with ``step``, ``n_leaves``, ``leaf_shapes`` and ``extra``.
* Async: ``save_async`` copies the tree to the host, then writes on a worker thread.
* Keep-N GC + latest-step resume + corrupted-checkpoint fallback.

Restoring with mesh shardings (the reference's elastic restart) is not ported yet: it
needs a process per device (ROADMAP item 10).
"""

from __future__ import annotations

import json
import os
import shutil
import threading
from dataclasses import dataclass
from typing import Any, Optional

import numpy as np
import torch

from repro_torch import _tree


def _host(x) -> np.ndarray:
    """A host copy of ``x``, never a view: the caller may go on writing ``x``."""
    if isinstance(x, torch.Tensor):
        return x.detach().to("cpu", copy=True).numpy()
    return np.array(x)


@dataclass
class Checkpointer:
    directory: str
    keep: int = 3

    def __post_init__(self):
        os.makedirs(self.directory, exist_ok=True)
        self._lock = threading.Lock()
        self._pending: Optional[threading.Thread] = None

    # ----------------------------- save ---------------------------------
    def save(self, step: int, tree: Any, extra: Optional[dict] = None):
        self._write(step, _tree.map(_host, tree), extra or {})

    def save_async(self, step: int, tree: Any, extra: Optional[dict] = None):
        self.wait()
        host_tree = _tree.map(_host, tree)  # snapshot now

        def work():
            self._write(step, host_tree, extra or {})

        self._pending = threading.Thread(target=work, daemon=True)
        self._pending.start()

    def wait(self):
        if self._pending is not None:
            self._pending.join()
            self._pending = None

    def _write(self, step: int, host_tree, extra: dict):
        with self._lock:
            final = os.path.join(self.directory, f"step_{step:010d}")
            tmp = final + ".tmp"
            if os.path.exists(tmp):
                shutil.rmtree(tmp)
            os.makedirs(tmp)
            flat = _tree.leaves(host_tree)
            manifest = {
                "step": step,
                "n_leaves": len(flat),
                "leaf_shapes": [list(np.shape(leaf)) for leaf in flat],
                "extra": extra,
            }
            for i, leaf in enumerate(flat):
                np.save(os.path.join(tmp, f"leaf_{i:05d}.npy"), leaf)
            with open(os.path.join(tmp, "manifest.json"), "w") as f:
                json.dump(manifest, f)
            if os.path.exists(final):
                shutil.rmtree(final)
            os.rename(tmp, final)
            self._gc()

    def _gc(self):
        steps = self.all_steps()
        for s in steps[: -self.keep] if self.keep > 0 else []:
            shutil.rmtree(os.path.join(self.directory, f"step_{s:010d}"), ignore_errors=True)

    # ----------------------------- load ---------------------------------
    def all_steps(self) -> list:
        out = []
        for name in os.listdir(self.directory):
            if name.startswith("step_") and not name.endswith(".tmp"):
                if os.path.exists(os.path.join(self.directory, name, "manifest.json")):
                    out.append(int(name[5:]))
        return sorted(out)

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def restore(self, tree_like: Any, step: Optional[int] = None) -> tuple[Any, int, dict]:
        """(tree, step, extra): the checkpoint at ``step`` (None: the latest) as numpy
        arrays in the structure of ``tree_like``, whose leaves only count."""
        if step is None:
            step = self.latest_step()
            if step is None:
                raise FileNotFoundError(f"no checkpoints in {self.directory}")
        d = os.path.join(self.directory, f"step_{step:010d}")
        with open(os.path.join(d, "manifest.json")) as f:
            manifest = json.load(f)
        like, treedef = _tree.flatten(tree_like)
        if manifest["n_leaves"] != len(like):
            raise ValueError(
                f"checkpoint has {manifest['n_leaves']} leaves, model expects {len(like)}"
            )
        leaves = [np.load(os.path.join(d, f"leaf_{i:05d}.npy")) for i in range(len(like))]
        return _tree.unflatten(treedef, leaves), step, manifest.get("extra", {})

    def restore_latest_valid(self, tree_like: Any):
        """Walk checkpoints newest-first, skipping corrupted ones."""
        for step in reversed(self.all_steps()):
            try:
                return self.restore(tree_like, step)
            except Exception:  # a torn or corrupted checkpoint: try the one before
                continue
        raise FileNotFoundError(f"no valid checkpoint in {self.directory}")
