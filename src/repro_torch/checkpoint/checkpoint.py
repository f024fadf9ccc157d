"""Checkpointing with async save — counterpart of
``repro.checkpoint.checkpoint``, in its on-disk format:

    <dir>/step_<k:08d>/
        manifest.json      — step, sorted flat keys, shapes, dtypes (numpy's names)
        0.npz              — the flat arrays, keys joined by "//"

written to ``step_<k>.tmp`` and published with ``os.replace``.  bf16 leaves
are stored as their 16-bit patterns with manifest dtype ``"bfloat16"``, so
either package restores what the other wrote, bit for bit, and neither numpy
nor the port needs ``ml_dtypes``.  Data-pipeline state is just the step
integer (deterministic replay).  ``restore`` puts every leaf on one device;
``runtime.elastic.elastic_restore`` places the params on a mesh, and
``launch.train`` under a mesh gathers its DTensors to full tensors before
``save``, so the format stays mesh-agnostic.
"""
from __future__ import annotations

import json
import os
import threading
from typing import Any, Dict, Optional

import numpy as np
import torch

from ..device import resolve_device

__all__ = ["Checkpointer"]

_SEP = "//"


def _flatten(tree, prefix=()):
    if isinstance(tree, dict):
        out = {}
        for k in sorted(tree):
            out.update(_flatten(tree[k], prefix + (str(k),)))
        return out
    return {_SEP.join(prefix): tree}


def _unflatten(flat: Dict[str, Any]):
    tree: Dict[str, Any] = {}
    for key, v in flat.items():
        parts = key.split(_SEP)
        cur = tree
        for p in parts[:-1]:
            cur = cur.setdefault(p, {})
        cur[parts[-1]] = v
    return tree


def _to_host(v) -> tuple:
    """(array as stored, dtype name): a copy in host memory, taken now."""
    if torch.is_tensor(v):
        t = v.detach()
        if t.dtype == torch.bfloat16:
            t = t.view(torch.int16)
        a = t.to("cpu", copy=True).numpy()
        if v.dtype == torch.bfloat16:
            return a.view(np.uint16), "bfloat16"
        return a, str(a.dtype)
    a = np.array(v)  # a copy: the caller may change its array after save
    return a, str(a.dtype)


def _from_host(a: np.ndarray, dtype: str, device: torch.device) -> torch.Tensor:
    if dtype == "bfloat16":
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16).to(device)
    return torch.from_numpy(a).to(device)


class Checkpointer:
    def __init__(self, directory: str, keep: int = 3):
        self.dir = directory
        self.keep = keep
        os.makedirs(directory, exist_ok=True)
        self._thread: Optional[threading.Thread] = None

    # -- save ---------------------------------------------------------------

    def save(self, step: int, tree: Dict, blocking: bool = True):
        """Copy every leaf to host memory, then write; the write runs on a
        thread when ``blocking=False``, and a step taken after ``save``
        returns does not change what it writes."""
        host, dtypes = {}, {}
        for k, v in _flatten(tree).items():
            host[k], dtypes[k] = _to_host(v)

        def write():
            d = os.path.join(self.dir, f"step_{step:08d}")
            tmp = d + ".tmp"
            os.makedirs(tmp, exist_ok=True)
            np.savez(os.path.join(tmp, "0.npz"), **host)
            manifest = {
                "step": step,
                "keys": sorted(host),
                "shapes": {k: list(v.shape) for k, v in host.items()},
                "dtypes": dtypes,
            }
            with open(os.path.join(tmp, "manifest.json"), "w") as f:
                json.dump(manifest, f)
            os.replace(tmp, d)  # atomic publish
            self._gc()

        if blocking:
            write()
        else:
            self.wait()
            self._thread = threading.Thread(target=write, daemon=True)
            self._thread.start()

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    def _gc(self):
        steps = self.all_steps()
        for s in steps[: -self.keep]:
            d = os.path.join(self.dir, f"step_{s:08d}")
            for root, dirs, files in os.walk(d, topdown=False):
                for fn in files:
                    os.remove(os.path.join(root, fn))
                os.rmdir(root)

    # -- restore ---------------------------------------------------------------

    def all_steps(self):
        out = []
        for name in os.listdir(self.dir):
            if name.startswith("step_") and not name.endswith(".tmp"):
                out.append(int(name.split("_")[1]))
        return sorted(out)

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def restore(self, step: Optional[int] = None, device=None) -> Dict:
        """Load a checkpoint (default: the latest) as a tree of tensors on
        ``device`` (default: the card)."""
        device = resolve_device(device)
        if step is None:
            step = self.latest_step()
            if step is None:
                raise FileNotFoundError(f"no checkpoints in {self.dir}")
        d = os.path.join(self.dir, f"step_{step:08d}")
        with open(os.path.join(d, "manifest.json")) as f:
            manifest = json.load(f)
        with np.load(os.path.join(d, "0.npz")) as data:
            flat = {k: _from_host(data[k], manifest["dtypes"][k], device)
                    for k in manifest["keys"]}
        return _unflatten(flat)
