"""Cold-tier row stores for the Knowledge Bank's two-tier residency layer.

A copy of ``repro.core.kb_storage`` (numpy only), so that the port runs
without the JAX package. The file format is the same (``row_%010d.npz``,
written as ``.tmp.npz`` and renamed into place), so a disk tier written by
either package can be read by the other.

The engine (``repro_torch.core.kb_engine``) keeps only ``resident_rows``
rows device-resident; everything else lives here as a *full per-row state
record* — embedding row (fp32, or int8 codes + scale/offset), version
counter, gradient caches, norm EMA — so a spill -> fault-in round trip is
bit-identical: the restored row is indistinguishable from one that never
left the device.

Two flavors, one interface (``put`` / ``get`` / ``__contains__`` /
``__len__`` / ``ids`` / ``bytes_stored``):

- ``MemoryColdStore``: host-RAM dict. The default — host memory is the
  usual second tier (device memory is what caps rows-per-device).
- ``DiskColdStore``: one npz per row id, written atomically (write
  ``.tmp.npz``, then ``os.replace``) so a crash mid-spill can never leave
  a torn row behind. Survives process restarts: a bank can fault in rows
  spilled by a previous incarnation.

Stores are engine-private (single-threaded by the engine's own contract);
``DiskColdStore`` is additionally safe against concurrent *readers* thanks
to the atomic rename.
"""
from __future__ import annotations

import os
import re
from typing import Dict, Iterable, Optional

import numpy as np

RowState = Dict[str, np.ndarray]


class MemoryColdStore:
    """Host-RAM cold tier: id -> full row-state record."""

    def __init__(self):
        self._rows: Dict[int, RowState] = {}

    def put(self, gid: int, state: RowState) -> None:
        self._rows[int(gid)] = {k: np.asarray(v) for k, v in state.items()}

    def get(self, gid: int) -> Optional[RowState]:
        return self._rows.get(int(gid))

    def __contains__(self, gid) -> bool:
        return int(gid) in self._rows

    def __len__(self) -> int:
        return len(self._rows)

    def ids(self) -> Iterable[int]:
        return list(self._rows.keys())

    def bytes_stored(self) -> int:
        return sum(sum(a.nbytes for a in st.values())
                   for st in self._rows.values())


class DiskColdStore:
    """Disk cold tier: one ``row_<gid>.npz`` per spilled row, atomic-rename
    writes (the ``DiskCheckpointStore`` idiom). ``get`` leaves the file in
    place — eviction back to disk after a fault-in is just another put."""

    _NAME = re.compile(r"row_(\d+)\.npz$")

    def __init__(self, directory: str):
        self.dir = directory
        os.makedirs(directory, exist_ok=True)

    def _path(self, gid: int) -> str:
        return os.path.join(self.dir, f"row_{int(gid):010d}.npz")

    def put(self, gid: int, state: RowState) -> None:
        path = self._path(gid)
        tmp = path + ".tmp.npz"         # .npz suffix: savez won't append
        np.savez(tmp, **{k: np.asarray(v) for k, v in state.items()})
        os.replace(tmp, path)

    def get(self, gid: int) -> Optional[RowState]:
        path = self._path(gid)
        if not os.path.exists(path):
            return None
        with np.load(path) as z:
            return {k: z[k] for k in z.files}

    def __contains__(self, gid) -> bool:
        return os.path.exists(self._path(gid))

    def __len__(self) -> int:
        return sum(1 for f in os.listdir(self.dir) if self._NAME.match(f))

    def ids(self) -> Iterable[int]:
        return sorted(int(m.group(1)) for f in os.listdir(self.dir)
                      for m in [self._NAME.match(f)] if m)

    def bytes_stored(self) -> int:
        return sum(os.path.getsize(os.path.join(self.dir, f))
                   for f in os.listdir(self.dir) if self._NAME.match(f))


def make_cold_store(cold_dir: Optional[str] = None):
    """Factory: a disk store when a directory is given, else host RAM."""
    return DiskColdStore(cold_dir) if cold_dir else MemoryColdStore()
