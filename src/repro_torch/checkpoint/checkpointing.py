"""Versioned checkpointing, the weight channel from trainers to knowledge
makers (paper §3.1); the port of ``repro/checkpoint/checkpointing.py``.

``flatten_params`` turns a nested dict of tensors into ``{path: numpy
array}`` with each leaf's keys joined by ``::`` in JAX's leaf order, a bf16
leaf widened to fp32 (npz cannot store bf16), exactly as the JAX function
writes a pytree; ``unflatten_params`` maps such a dict back onto a
template's structure, dtypes and devices. So an npz checkpoint written by
either package loads in the other.

- ``DiskCheckpointStore``: npz files, written to a temporary name and
  renamed, the oldest pruned past ``keep``.
- ``MemoryCheckpointStore``: in-process and lock-protected; it holds the
  trainer's tensors themselves. The port's trainer updates its parameters
  in place, so a caller that keeps a checkpoint across steps saves a copy.
"""
from __future__ import annotations

import os
import re
import threading
import time
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.tree import SEP, tree_items, tree_map_with_path

# the dtypes npz stores as they are (the JAX function's list)
_NPZ_DTYPES = (np.float32, np.float64, np.int32, np.int64, np.bool_,
               np.uint32, np.int8, np.uint8, np.float16)

__all__ = ["SEP", "DiskCheckpointStore", "MemoryCheckpointStore",
           "flatten_params", "unflatten_params"]


def _to_numpy(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        leaf = leaf.detach()
        if leaf.dtype == torch.bfloat16:
            leaf = leaf.float()
        leaf = leaf.cpu().numpy()
    arr = np.asarray(leaf)
    if arr.dtype not in _NPZ_DTYPES:
        arr = arr.astype(np.float32)     # bf16 etc: npz can't store them
    return arr


def flatten_params(params) -> Dict[str, np.ndarray]:
    return {path: _to_numpy(leaf) for path, leaf in tree_items(params)}


def unflatten_params(template, flat: Dict[str, np.ndarray]):
    """``template``'s tree with each leaf replaced by ``flat[path]`` in
    that leaf's dtype, shape and device."""
    def leaf(path, t):
        arr = flat[path]
        if not isinstance(t, torch.Tensor):
            return arr
        return torch.tensor(np.asarray(arr)).to(
            device=t.device, dtype=t.dtype).reshape(t.shape)
    return tree_map_with_path(leaf, template)


class DiskCheckpointStore:
    """npz checkpoints on disk, the weight channel when trainers and makers
    are separate processes.

    ``template`` (or ``set_template``) binds a parameter tree once so that
    ``load_latest()`` can be called without one, the contract shared with
    ``MemoryCheckpointStore``."""

    def __init__(self, directory: str, keep: int = 3, template: Any = None):
        self.dir = directory
        self.keep = keep
        self.template = template
        os.makedirs(directory, exist_ok=True)

    def set_template(self, template: Any) -> "DiskCheckpointStore":
        self.template = template
        return self

    def _template(self, template):
        if template is None:
            template = self.template
        if template is None:
            raise ValueError("DiskCheckpointStore needs a params template "
                             "(pass one, or bind it via set_template)")
        return template

    def _path(self, step: int) -> str:
        return os.path.join(self.dir, f"ckpt_{step:08d}.npz")

    def save(self, step: int, params) -> str:
        flat = flatten_params(params)
        tmp = self._path(step) + ".tmp.npz"   # .npz suffix: savez won't append
        np.savez(tmp, **flat)
        os.replace(tmp, self._path(step))
        self._prune()
        return self._path(step)

    def _prune(self):
        for s in self.steps()[:-self.keep]:
            try:
                os.remove(self._path(s))
            except FileNotFoundError:
                pass

    def steps(self) -> List[int]:
        out = []
        for f in os.listdir(self.dir):
            m = re.match(r"ckpt_(\d+)\.npz$", f)
            if m:
                out.append(int(m.group(1)))
        return sorted(out)

    def latest_step(self) -> Optional[int]:
        s = self.steps()
        return s[-1] if s else None

    def load(self, step: int, template: Any = None) -> Any:
        with np.load(self._path(step)) as z:
            flat = {k: z[k] for k in z.files}
        return unflatten_params(self._template(template), flat)

    def load_latest(self, template: Any = None) -> Tuple[Optional[int], Any]:
        s = self.latest_step()
        if s is None:
            return None, None
        return s, self.load(s, template)


class MemoryCheckpointStore:
    """Thread-safe in-memory store: it holds the tensors it is given, on
    their device, so makers pick up new trainer weights without a copy."""

    def __init__(self, keep: int = 2):
        self._lock = threading.Lock()
        self._ckpts: Dict[int, Any] = {}
        self.keep = keep
        self.publish_times: Dict[int, float] = {}

    def save(self, step: int, params):
        with self._lock:
            self._ckpts[step] = params
            self.publish_times[step] = time.monotonic()
            for s in sorted(self._ckpts)[:-self.keep]:
                del self._ckpts[s]

    def latest_step(self) -> Optional[int]:
        with self._lock:
            return max(self._ckpts) if self._ckpts else None

    def load_latest(self, template=None) -> Tuple[Optional[int], Any]:
        with self._lock:
            if not self._ckpts:
                return None, None
            s = max(self._ckpts)
            return s, self._ckpts[s]
