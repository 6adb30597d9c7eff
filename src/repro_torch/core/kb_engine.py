"""Pluggable Knowledge-Bank engine: one semantics, three execution backends.

The port of ``repro.core.kb_engine`` for fp32 and int8 storage, exact and
IVF search, on one device:

- ``KBBackend``   : the protocol, ops over the shared ``KBState`` of
                    ``repro_torch.core.knowledge_bank``.
- ``DenseBackend``: the plain PyTorch reference ops (the semantics ground
                    truth), chosen only explicitly.
- ``CudaBackend`` : the serving path and the default, in place of the JAX
                    package's ``PallasBackend`` (``kb_engine.py:189-251``).
                    ``lookup`` runs the fused apply-and-clear kernel
                    (``lookup_q`` its int8 twin), ``lookup(apply_pending=
                    False)`` the row gather, ``flush`` the lazy-apply
                    kernel, ``nn_search`` the exact MIPS kernel, and
                    ``ivf_search`` / ``ivf_search_q`` the IVF stage-2
                    kernels. Writes (update / lazy_grad), the int8 flush,
                    the int8 exact search and IVF stage 1 and re-rank are
                    plain PyTorch, as they are jnp in the JAX package. On
                    CPU tensors each kernel wrapper runs its plain version,
                    which is how the CPU tests drive this backend.
- ``ShardedBackend``: the bank as S logical shards (the owner ranges of
                    ``repro_torch.core.sharded_kb``) on one device, in
                    place of the JAX package's mesh ``ShardedBackend``
                    (``kb_engine.py:120-186``), whose shard count is the
                    mesh's size. The row ops are ``CudaBackend``'s: on one
                    device each id has one owner, so they come out exactly
                    as the dense ones. The searches are per shard: exact
                    top-k over each shard's rows, and IVF through one
                    sub-index per shard (``ShardedIVFIndex``) whose stage 2
                    runs every shard in one launch of the sharded kernel;
                    both merge the shards' lists shard-major.

**State is updated in place.** Every backend op writes into the state's
tensors and returns the same state; the engine keeps one state and never a
copy of it (the bank is 2 GB at ogbn-mag scale).

``KBEngine`` is the stateful host shell the server talks to: numpy in,
numpy out, every batch padded to a power-of-two bucket as the JAX engine
pads it (lookups and updates with a duplicated real entry, lazy_grads
with masked-out entries), so the kernels see the shapes and duplicates
they see there. Two deliberate differences from the JAX engine:

- ``warmup`` runs each op on a small scratch state. The JAX warm-up runs
  lookups on the live state and drops the result, which is harmless only
  because its jitted ops are pure; here a lookup would apply and clear
  row 0's pending gradients.
- ``CudaBackend.nn_search`` with ``exclude_ids`` runs the kernel through
  ``overfetch_exclude_topk``, where ``PallasBackend`` hands exclusion to
  the dense path (``kb_engine.py:246-248``), so no plain version sits on
  the card's path. The result is the same whenever the over-fetched pool
  holds k survivors.

- ``rebuild_ann_index`` takes its snapshot under the lock the caller
  passes (the server's engine lock, which its dispatcher holds per op):
  the JAX engine reads an immutable state from the refresher's thread,
  while here the state is updated in place and a snapshot taken while an
  op runs could tear. On the card the build then runs on a stream of its
  own, and the index is published only once that stream's work is done.

**Ids outside [0, N) are refused.** ``lookup``, ``update``, ``lazy_grad``
and ``nn_search(exclude_ids=)`` (where -1 is the inert padding) check their
ids on the host before any device op and raise ``KBIdError``, one error on
every backend and storage mode, with the state left as it was. The JAX
engine clamps such reads and drops such writes; on the card an index out of
range is a device-side assert that would poison the process's CUDA context,
so the port refuses both (ROADMAP, deliberate differences).

**Tiered residency** (``resident_rows=``, ``cold_after_rows=``,
``cold_dir=``) follows the JAX engine (``kb_engine.py:377-449, 611-723``):
the device state holds ``resident_rows`` slots, every other row's full
state (``ROW_LEAVES``, and scale and offset in int8) lives in a host-RAM
or disk cold store (``repro_torch.core.kb_storage``), and each op's rows
fault into slots before it runs, evicting the oldest-touched rows not in
the batch. The kernels run on slot ids. A fault-in copies each leaf of
the whole batch to the device once (pinned, on the serving stream) and
scatters it into the slots; a spill gathers each leaf on the device and
brings them to the host in one copy. The ids are checked before the
tiering sees them (refused, where the JAX engine clamps them). The
exact search's ``k``, and the over-fetch of ``exclude_ids``, are capped
at the slot count. Tiering refuses the sharded backend and a random
init (``generator=``), as the JAX engine refuses ``key=``.

On the sharded backend the engine keeps one write clock per shard and one
IVF sub-index per shard; ``rebuild_ann_index(shards=)`` re-clusters only
the listed shards, and the others keep their arrays and their clocks.
Sharded int8 storage keeps the fp32 table and quantizes the index
(``QuantizedShardedIVFIndex``), as the JAX engine does.

int8 storage keeps ``state.table`` as (N, D) int8 codes with the (N,) fp32
side-cars ``_qscale`` / ``_qoffset`` beside the state, as the JAX engine
does; lookup, update and flush go through the ``_q`` ops, and an fp32
master copy of up to ``master_rows`` recently pushed rows re-ranks the
winners of a search.

The engine is NOT thread-safe: the server layer serialises access. The
sanctioned exception is the ``IVFRefresher`` thread, which reads the write
counters, snapshots the state under the server's lock and publishes a new
index (``set_ann_index``: index first, clock second).
"""
from __future__ import annotations

import contextlib
from collections import OrderedDict
from typing import Callable, NamedTuple, Optional, Protocol, Tuple

import numpy as np
import torch

from repro_torch.convert import kb_state_from_numpy
from repro_torch.core import knowledge_bank as kbm
from repro_torch.core import sharded_kb as skb
from repro_torch.core.ann_index import (QuantizedIVFIndex,
                                        QuantizedShardedIVFIndex,
                                        ShardedIVFIndex, build_ivf_index,
                                        build_sharded_ivf_index)
from repro_torch.core.kb_storage import make_cold_store
from repro_torch.core.knowledge_bank import KBState
from repro_torch.env import resolve_device
from repro_torch.kernels import nn_search_ivf as ivf
from repro_torch.kernels import ops


class KBIdError(IndexError):
    """An id outside [0, num_entries) sent to ``KBEngine``: refused on the
    host before any device op, with the bank unchanged."""


class KBBackend(Protocol):
    """Ops over a shared ``KBState``, in place. All ids/grads flat."""

    name: str

    def lookup(self, state: KBState, ids, *, lazy_lr: float, zmax: float,
               apply_pending: bool = True
               ) -> Tuple[torch.Tensor, KBState]: ...

    def update(self, state: KBState, ids, values) -> KBState: ...

    def lazy_grad(self, state: KBState, ids, grads, *, zmax: float,
                  mask=None) -> KBState: ...

    def flush(self, state: KBState, *, lazy_lr: float,
              zmax: float) -> KBState: ...

    def nn_search(self, state: KBState, queries, k: int, *,
                  exclude_ids=None) -> Tuple[torch.Tensor, torch.Tensor]: ...

    def lookup_q(self, state: KBState, qscale, qoffset, ids, *,
                 lazy_lr: float, zmax: float
                 ) -> Tuple[torch.Tensor, KBState]: ...

    def ivf_search(self, state: KBState, index, queries, k: int,
                   nprobe: int) -> Tuple[torch.Tensor, torch.Tensor]: ...

    def ivf_search_q(self, state: KBState, qscale, qoffset, index, queries,
                     k: int, nprobe: int
                     ) -> Tuple[torch.Tensor, torch.Tensor]: ...


class DenseBackend:
    """The plain PyTorch reference ops: semantics ground truth."""

    name = "dense"

    def lookup(self, state, ids, *, lazy_lr, zmax, apply_pending=True):
        return kbm.kb_lookup(state, ids, lazy_lr=lazy_lr, zmax=zmax,
                             apply_pending=apply_pending)

    def update(self, state, ids, values):
        return kbm.kb_update(state, ids, values)

    def lazy_grad(self, state, ids, grads, *, zmax, mask=None):
        return kbm.kb_lazy_grad(state, ids, grads, zmax=zmax, mask=mask)

    def flush(self, state, *, lazy_lr, zmax):
        return kbm.kb_flush(state, lazy_lr=lazy_lr, zmax=zmax)

    def nn_search(self, state, queries, k, *, exclude_ids=None):
        return kbm.kb_nn_search(state, queries, k, exclude_ids=exclude_ids)

    def lookup_q(self, state, qscale, qoffset, ids, *, lazy_lr, zmax):
        return kbm.kb_lookup_q(state, qscale, qoffset, ids,
                               lazy_lr=lazy_lr, zmax=zmax)

    def ivf_search(self, state, index, queries, k, nprobe):
        return ivf.ivf_search_ref(state.table, index.centroids,
                                  index.packed_vecs, index.packed_ids,
                                  queries, k, nprobe)

    def ivf_search_q(self, state, qscale, qoffset, index, queries, k,
                     nprobe):
        return ivf.ivf_search_quantized_ref(
            state.table, qscale, qoffset, index.centroids,
            index.packed_codes, index.packed_scale, index.packed_offset,
            index.packed_ids, queries, k, nprobe)


class CudaBackend:
    """The serving path: the read-side ops and the flush go through the
    port's CUDA kernels (``repro_torch.kernels.ops``)."""

    name = "cuda"

    def lookup(self, state, ids, *, lazy_lr, zmax, apply_pending=True):
        flat = ids.reshape(-1).long()
        if not apply_pending:
            return (ops.kb_gather(state.table, flat).reshape(*ids.shape, -1),
                    state)
        # one kernel: the lookup also bumps version, +1 per touched row
        # with pending gradients (the JAX engine's jnp scatter), so the op
        # queues nothing else and never waits on the card
        vals = ops.kb_fused_lookup(state.table, state.grad_sum,
                                   state.grad_cnt, state.grad_sqnorm, flat,
                                   lazy_lr=lazy_lr, zmax=zmax,
                                   version=state.version)
        return vals.reshape(*ids.shape, -1), state

    def update(self, state, ids, values):
        return kbm.kb_update(state, ids, values)

    def lazy_grad(self, state, ids, grads, *, zmax, mask=None):
        return kbm.kb_lazy_grad(state, ids, grads, zmax=zmax, mask=mask)

    def flush(self, state, *, lazy_lr, zmax):
        state.version.add_((state.grad_cnt > 0).to(torch.int32))
        ops.lazy_apply(state.table, state.grad_sum, state.grad_cnt,
                       state.grad_sqnorm, lazy_lr=lazy_lr, zmax=zmax)
        state.step.add_(1)
        return state

    def nn_search(self, state, queries, k, *, exclude_ids=None):
        if exclude_ids is None:
            return ops.nn_search(queries, state.table, k)
        # over-fetch through the kernel, never the plain path (see the
        # module docstring for the difference from PallasBackend)
        return ops.overfetch_exclude_topk(
            lambda kk: ops.nn_search(queries, state.table, kk),
            state.table.shape[0], k, exclude_ids)

    def lookup_q(self, state, qscale, qoffset, ids, *, lazy_lr, zmax):
        flat = ids.reshape(-1).long()
        vals = ops.kb_fused_lookup_q(state.table, qscale, qoffset,
                                     state.grad_sum, state.grad_cnt,
                                     state.grad_sqnorm, flat,
                                     lazy_lr=lazy_lr, zmax=zmax,
                                     version=state.version)
        return vals.reshape(*ids.shape, -1), state

    def ivf_search(self, state, index, queries, k, nprobe):
        probes = ivf.ivf_probes(queries, index.centroids, nprobe)
        _, ids = ops.ivf_stage2(index.packed_vecs, index.packed_ids,
                                index.bucket_occ, queries, probes, k)
        return ivf._rerank_live(state.table, queries, ids)

    def ivf_search_q(self, state, qscale, qoffset, index, queries, k,
                     nprobe):
        probes = ivf.ivf_probes(queries, index.centroids, nprobe)
        _, ids = ops.ivf_stage2_q(index.packed_codes, index.packed_scale,
                                  index.packed_offset, index.packed_ids,
                                  index.bucket_occ, queries, probes, k)
        return ivf._rerank_live_q(state.table, qscale, qoffset, queries,
                                  ids)


class ShardedBackend:
    """The bank as ``n_shards`` logical shards on one device: the row ops
    of ``CudaBackend``, per-shard searches with a shard-major merge
    (``repro_torch.core.sharded_kb``)."""

    name = "sharded"

    def __init__(self, n_shards: int = 1):
        if n_shards < 1:
            raise ValueError(f"n_shards must be >= 1, got {n_shards}")
        self.n_shards = n_shards
        rows = CudaBackend()
        self.lookup, self.update = rows.lookup, rows.update
        self.lazy_grad, self.flush = rows.lazy_grad, rows.flush

    def nn_search(self, state, queries, k, *, exclude_ids=None):
        def search(kk):
            return skb.sharded_kb_nn_search(state.table, queries, kk,
                                            self.n_shards)
        if exclude_ids is None:
            return search(k)
        return ops.overfetch_exclude_topk(search, state.table.shape[0], k,
                                          exclude_ids)

    def ivf_search(self, state, index, queries, k, nprobe):
        """Through a ``ShardedIVFIndex`` (or its int8 twin) whose shard
        count is this backend's."""
        return skb.sharded_kb_nn_search_ivf(state.table, index, queries, k,
                                            nprobe)


def make_backend(name: str, *, n_shards: int = 1) -> KBBackend:
    """Backend factory: ``cuda | dense | sharded`` (``n_shards`` logical
    shards). All satisfy the same contract (tests/test_torch_engine.py and
    tests/test_torch_sharded_ivf.py hold them against each other and
    against the JAX package)."""
    if name == "cuda":
        return CudaBackend()
    if name == "dense":
        return DenseBackend()
    if name == "sharded":
        return ShardedBackend(n_shards)
    raise ValueError(f"unknown KB backend {name!r} "
                     "(want cuda | dense | sharded)")


class KBOps(NamedTuple):
    """Functional facade over one ``KBBackend`` with the lazy-update knobs
    bound, for callers that thread a ``KBState`` themselves:

    - ``lookup(kb, ids)``                          -> (values, kb)
    - ``update(kb, ids, values)``                  -> kb
    - ``lazy_grad(kb, ids, grads)``                -> kb
    - ``nn_search(kb, q, k, *, exclude_ids=None)`` -> (scores, ids)
    - ``flush(kb)``                                -> kb
    """

    lookup: Callable
    update: Callable
    lazy_grad: Callable
    nn_search: Callable
    flush: Callable
    backend_name: str


def make_kb_ops(*, backend="cuda", lazy_lr: float = 0.1, zmax: float = 3.0,
                apply_pending: bool = True) -> KBOps:
    """Select a backend once (an instance or a factory name) and bind the
    lazy-update knobs into a ``KBOps`` bundle."""
    bk = backend if not isinstance(backend, str) else make_backend(backend)
    return KBOps(
        lookup=lambda kb, ids: bk.lookup(kb, ids, lazy_lr=lazy_lr,
                                         zmax=zmax,
                                         apply_pending=apply_pending),
        update=lambda kb, ids, values: bk.update(kb, ids, values),
        lazy_grad=lambda kb, ids, grads: bk.lazy_grad(kb, ids, grads,
                                                      zmax=zmax),
        nn_search=lambda kb, q, k, *, exclude_ids=None: bk.nn_search(
            kb, q, k, exclude_ids=exclude_ids),
        flush=lambda kb: bk.flush(kb, lazy_lr=lazy_lr, zmax=zmax),
        backend_name=bk.name,
    )


_NP_DTYPE = {torch.float32: np.float32, torch.int32: np.int32,
             torch.int8: np.int8}


def _bucket(n: int, minimum: int = 8) -> int:
    """Next power-of-two bucket (>= minimum)."""
    return max(minimum, 1 << max(n - 1, 0).bit_length())


def _pad_repeat(a: np.ndarray, pad: int) -> np.ndarray:
    """``a`` with its last entry repeated ``pad`` more times."""
    return np.concatenate([a, np.repeat(a[-1:], pad, 0)])


class KBEngine:
    """Stateful, host-facing shell around a ``KBBackend``: numpy in, numpy
    out, state on ``device`` updated in place. Single-threaded by
    contract, but for the ``IVFRefresher`` (see the module docstring).
    ``entry_zmax`` clips each lazy gradient at entry (default ``zmax``);
    ``generator`` draws the initial table (``kb_create``), where the JAX
    engine takes ``key``; ``resident_rows`` / ``cold_after_rows`` /
    ``cold_dir`` make it tiered (see the module docstring)."""

    def __init__(self, num_entries: int, dim: int, *, backend="cuda",
                 lazy_lr: float = 0.1, zmax: float = 3.0,
                 entry_zmax: Optional[float] = None,
                 lazy_update: bool = True, search_mode: str = "exact",
                 ann_nlist: int = 64, ann_nprobe: int = 8,
                 ann_stale_rows: Optional[int] = None,
                 generator: Optional[torch.Generator] = None,
                 storage: str = "fp32", master_rows: int = 1024,
                 resident_rows: Optional[int] = None,
                 cold_after_rows: Optional[int] = None,
                 cold_dir: Optional[str] = None, device="cuda"):
        self.backend: KBBackend = (backend if not isinstance(backend, str)
                                   else make_backend(backend))
        if storage not in ("fp32", "int8"):
            raise ValueError(f"unknown storage {storage!r} "
                             "(want fp32 | int8)")
        sharded = isinstance(self.backend, ShardedBackend)
        if storage == "int8" and not lazy_update:
            raise ValueError(
                "storage='int8' requires lazy_update=True: the immediate-"
                "mode ablation scatter-adds into the table, which is not "
                "defined over int8 codes")
        tiered = resident_rows is not None
        if cold_after_rows is not None and not tiered:
            raise ValueError("cold_after_rows needs resident_rows set")
        if tiered and sharded:
            raise ValueError("tiered residency is single-device only "
                             "(cuda | dense backends)")
        if tiered and generator is not None:
            raise ValueError(
                "tiered residency requires generator=None: non-resident "
                "rows materialize as zeros on first touch, so a random "
                "init would make residency observable")
        if tiered and not 0 < resident_rows <= num_entries:
            raise ValueError(f"resident_rows={resident_rows} out of range "
                             f"(1..{num_entries})")
        _check_search_mode(search_mode)
        self.device = resolve_device(device)
        self.num_entries, self.dim = num_entries, dim
        self.lazy_lr, self.zmax, self.lazy_update = lazy_lr, zmax, lazy_update
        # entry-side (per-contribution, against the norm EMA) clip of
        # lazy_grad; defaults to the apply-side zmax, as in the JAX engine
        self.entry_zmax = zmax if entry_zmax is None else entry_zmax
        self.storage = storage
        # int8 quantizes the live table on the single-index backends; the
        # sharded backend keeps its fp32 table and quantizes the IVF
        # snapshot instead (rebuild_ann_index), as the JAX engine does
        self._quantized = storage == "int8" and not sharded
        self.tiered = tiered
        self.master_rows = master_rows
        self.cold_after_rows = cold_after_rows
        # -- ANN (IVF) serving state; see repro_torch.core.ann_index ------
        self.search_mode = search_mode
        self.ann_nlist, self.ann_nprobe = ann_nlist, ann_nprobe
        # exact fallback once this many rows were written since the build;
        # default: the whole bank rewritten
        self.ann_stale_rows = (num_entries if ann_stale_rows is None
                               else ann_stale_rows)
        self.ann_index = None               # published by the refresher
        self.total_write_rows = 0           # monotonic written-row counter
        # one write clock per bank shard drives the per-shard sub-index
        # rebuilds; the single-index backends have exactly one shard
        self.ann_shards = self.backend.n_shards if sharded else 1
        self._owners = skb.OwnerShard(num_entries, self.ann_shards)
        self.shard_write_rows = np.zeros((self.ann_shards,), np.int64)
        self._ann_shard_built_at = np.zeros((self.ann_shards,), np.int64)
        self._build_stream = None
        self.search_stats = {"exact": 0, "ivf": 0}
        self.dispatches = 0         # device calls issued (bench metric)
        # tiered engines size the device state to the resident slots only;
        # every other row lives in the cold store until it is touched
        rows = resident_rows if tiered else num_entries
        self.resident_rows = rows
        st = kbm.kb_create(rows, dim, device=self.device,
                           generator=generator)
        if self._quantized and generator is not None:
            codes, self._qscale, self._qoffset = kbm.quantize_rows(st.table)
            self.state = st._replace(table=codes)
        elif self._quantized:
            # zero rows code as (codes 0, scale 1, offset 0): dequant is
            # exactly 0.0, as the fp32 zero init
            self.state = st._replace(table=torch.zeros(
                (rows, dim), dtype=torch.int8, device=self.device))
            self._qscale = torch.ones((rows,), dtype=torch.float32,
                                      device=self.device)
            self._qoffset = torch.zeros((rows,), dtype=torch.float32,
                                        device=self.device)
        else:
            self.state = st
            self._qscale = self._qoffset = None
        # -- two-tier residency bookkeeping (host-side, O(N) ints), in the
        # JAX engine's types and update order ------------------------------
        if tiered:
            self.cold_store = make_cold_store(cold_dir)
            self._slot_of = np.full((num_entries,), -1, np.int64)
            self._slot_id = np.full((rows,), -1, np.int64)
            self._free_slots = list(range(rows - 1, -1, -1))
            self._touch = np.zeros((num_entries,), np.int64)
            self._gen = 0           # write clock: += distinct rows written
        else:
            self.cold_store = None
        self.tier_faults = 0        # rows restored from the cold store
        self.tier_spills = 0        # rows pushed down to the cold store
        # fp32 master set: exact rows as pushed by update, for the final
        # re-rank in int8 mode; invalidated per id by lazy_grad
        self._masters: "OrderedDict[int, np.ndarray]" = OrderedDict()

    def _tensor(self, a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(a)).to(self.device)

    def check_ids(self, ids, what: str, *, low: int = 0) -> None:
        """Raise ``KBIdError`` unless every id lies in [low, num_entries)
        (``low`` is -1 for exclusion lists, whose -1 entries are inert)."""
        ids = np.asarray(ids)
        if ids.size == 0:
            return
        bad = (ids < low) | (ids >= self.num_entries)
        if bad.any():
            raise KBIdError(
                f"{what}: ids {ids[bad][:8].tolist()} lie outside "
                f"[{low}, {self.num_entries}); the request is refused and "
                "the bank is unchanged")

    # -- embedding ops -----------------------------------------------------

    def lookup(self, ids) -> np.ndarray:
        """Fetch rows (applying pending lazy updates first unless the engine
        is the immediate-update ablation); any id shape. Deterministic under
        duplicate ids and the bucket padding, which repeats a real id."""
        ids = np.asarray(ids)
        flat = ids.reshape(-1).astype(np.int64)
        self.check_ids(flat, "lookup")
        if flat.size == 0:
            return np.zeros((*ids.shape, self.dim), np.float32)
        dev = self._admit(flat)
        padded = self._tensor(_pad_repeat(dev, _bucket(dev.size)
                                          - dev.size))
        if self._quantized:
            vals, self.state = self.backend.lookup_q(
                self.state, self._qscale, self._qoffset, padded,
                lazy_lr=self.lazy_lr, zmax=self.zmax)
        else:
            vals, self.state = self.backend.lookup(
                self.state, padded, lazy_lr=self.lazy_lr, zmax=self.zmax,
                apply_pending=self.lazy_update)
        self.dispatches += 1
        return vals[:flat.size].cpu().numpy().reshape(*ids.shape, -1)

    def update(self, ids, values) -> None:
        """Direct write (maker push); duplicate ids resolve last-writer-wins
        (host-side dedupe: a device scatter's order is unspecified). Each
        distinct row is charged once to the ANN staleness clock."""
        ids = np.asarray(ids).reshape(-1).astype(np.int64)
        self.check_ids(ids, "update")
        if ids.size == 0:
            return
        values = np.asarray(values, np.float32).reshape(ids.size, -1)
        _, keep = np.unique(ids[::-1], return_index=True)
        keep = ids.size - 1 - keep          # last occurrence of each id
        ids, values = ids[keep], values[keep]
        dev = self._admit(ids)
        if self._quantized and self.master_rows > 0:
            self._remember_masters(ids, values)
        pad = _bucket(ids.size) - ids.size
        ids_t = self._tensor(_pad_repeat(dev, pad))
        values_t = self._tensor(_pad_repeat(values, pad))
        if self._quantized:
            kbm.kb_update_q(self.state, self._qscale, self._qoffset, ids_t,
                            values_t)
        else:
            self.state = self.backend.update(self.state, ids_t, values_t)
        self.dispatches += 1
        self._count_writes(ids)
        if self.tiered:
            self._gen += ids.size
            self._spill_cold()

    def _remember_masters(self, ids: np.ndarray, values: np.ndarray) -> None:
        """Keep the pre-quantization rows of the last ``master_rows``
        distinct ids written, oldest evicted first, as the JAX engine's
        insert-and-evict loop does (a write of at least ``master_rows`` rows
        leaves exactly its last ``master_rows``)."""
        if ids.size >= self.master_rows:
            self._masters.clear()
            ids, values = ids[-self.master_rows:], values[-self.master_rows:]
        for g, v in zip(ids.tolist(), values):
            self._masters[g] = v.copy()
            self._masters.move_to_end(g)
            if len(self._masters) > self.master_rows:
                self._masters.popitem(last=False)

    def lazy_grad(self, ids, grads) -> None:
        """Cache gradients (or apply them at once when lazy_update=False).
        Padded entries carry a 0 mask and are inert; cache adds commute, so
        a coalesced multi-client batch equals any serial interleaving. The
        touched rows are charged to the ANN staleness clock: the cached
        gradient will reach the table."""
        ids = np.asarray(ids).reshape(-1).astype(np.int64)
        self.check_ids(ids, "lazy_grad")
        if ids.size == 0:
            return
        grads = np.asarray(grads, np.float32).reshape(ids.size, -1)
        dev = self._admit(ids)
        if self._quantized and self._masters:
            # these rows' live values leave their masters once the cached
            # gradient applies: drop the stale exact copies
            for g in np.unique(ids).tolist():
                self._masters.pop(g, None)
        n = ids.size
        pad = _bucket(n) - n
        ids_t = self._tensor(_pad_repeat(dev, pad))
        grads_t = self._tensor(np.concatenate(
            [grads, np.zeros((pad, grads.shape[1]), np.float32)]))
        mask_t = self._tensor(np.concatenate([np.ones(n, np.float32),
                                              np.zeros(pad, np.float32)]))
        if self.lazy_update:
            # lazy_grad touches only the fp32 caches, never the table, so
            # the fp32 op serves both storage modes
            self.state = self.backend.lazy_grad(
                self.state, ids_t, grads_t, zmax=self.entry_zmax,
                mask=mask_t)
        else:
            # ablation baseline: immediate SGD scatter-add, no cache;
            # duplicates add in occurrence order, without atomics
            kbm.index_add_in_order(
                self.state.table, ids_t,
                -self.lazy_lr * grads_t * mask_t[:, None],
                kbm.occurrence_rounds(ids_t))
        self.dispatches += 1
        self._count_writes(ids)
        if self.tiered:
            self._gen += int(np.unique(ids).size)
            self._spill_cold()

    # -- two-tier residency (resident device slots + host/disk cold store) -

    def _admit(self, flat: np.ndarray) -> np.ndarray:
        """Tiered engines: fault this batch's rows into device slots and
        translate global ids to slots (identity otherwise). Eviction is
        oldest-touch-first among the resident rows NOT in the batch; a
        batch with more distinct rows than there are slots is refused
        before any row moves. The ids were checked, so none is clamped."""
        if not self.tiered:
            return flat
        uniq = np.unique(flat)
        miss = uniq[self._slot_of[uniq] < 0]
        if miss.size:
            short = miss.size - len(self._free_slots)
            if short > 0:
                res = np.flatnonzero(self._slot_id >= 0)
                cand = res[~np.isin(self._slot_id[res], uniq)]
                if cand.size < short:
                    raise ValueError(
                        f"batch touches {uniq.size} distinct rows but only "
                        f"{self.resident_rows} device slots exist")
                order = np.argsort(self._touch[self._slot_id[cand]],
                                   kind="stable")
                self._spill_slots(cand[order[:short]])
            self._fault_in(miss)
        self._touch[uniq] = self._gen
        return self._slot_of[flat]

    def _leaves(self) -> dict:
        """The per-row device leaves by export name (``ROW_LEAVES``, and
        ``scale`` / ``offset`` on an int8 engine)."""
        out = {leaf: getattr(self.state, leaf) for leaf in self.ROW_LEAVES}
        if self._quantized:
            out["scale"], out["offset"] = self._qscale, self._qoffset
        return out

    def _host(self, a: np.ndarray) -> torch.Tensor:
        """``a`` on the engine's device. On the card the copy is queued
        from a pinned copy of ``a`` that the caching host allocator keeps
        until the copy has run, so no host sync is added."""
        a = np.ascontiguousarray(a)
        # torch shares no read-only memory (a JAX export's arrays are)
        t = torch.from_numpy(a if a.flags.writeable else a.copy())
        if self.device.type != "cuda":
            return t
        return t.pin_memory().to(self.device, non_blocking=True)

    def _rows_to_host(self, idx: torch.Tensor) -> dict:
        """Every leaf's rows ``idx`` as numpy, raw dtypes: one gather per
        leaf on the device, packed into one byte matrix, so one
        device-to-host copy (one host sync on the card) brings them all.
        The arrays are views of that matrix."""
        leaves = self._leaves()
        # widest dtypes first, so that every view of the matrix is aligned
        names = sorted(leaves, key=lambda f: -leaves[f].element_size())
        parts = [leaves[f].index_select(0, idx) for f in names]
        packed = torch.cat([(p if p.dim() == 2 else p[:, None]).view(
            torch.uint8) for p in parts], 1).cpu().numpy()
        out, col = {}, 0
        for f, p in zip(names, parts):
            width = (p.shape[1] if p.dim() == 2 else 1) * p.element_size()
            a = packed[:, col:col + width].view(_NP_DTYPE[p.dtype])
            out[f] = a if p.dim() == 2 else a[:, 0]
            col += width
        return {f: out[f] for f in leaves}

    def _fault_in(self, gids: np.ndarray) -> None:
        """Restore rows from the cold store (or materialize zero rows on
        first-ever touch) into free slots: the FULL per-row state, so the
        round trip is bit-identical. One host array and one copy per leaf
        for the whole batch, scattered into the slots on the serving
        stream. Slot contents changing under a built IVF index is row
        churn, so faults charge the staleness clock."""
        n = gids.size
        slots = np.array(self._free_slots[:-n - 1:-1], np.int64)
        del self._free_slots[-n:]
        host = {f: np.zeros((n, *t.shape[1:]), _NP_DTYPE[t.dtype])
                for f, t in self._leaves().items()}
        if self._quantized:
            host["scale"][:] = 1.0
        for i, g in enumerate(gids.tolist()):
            rec = self.cold_store.get(g)
            if rec is None:
                continue                        # first touch: zero row
            self.tier_faults += 1
            for f, a in host.items():
                a[i] = rec[f]
        idx = self._host(slots)
        for f, t in self._leaves().items():
            t.index_copy_(0, idx, self._host(host[f]))
        self._slot_of[gids] = slots
        self._slot_id[slots] = gids
        self._count_writes(gids)

    def _spill_slots(self, slots: np.ndarray) -> None:
        """Push resident slots down to the cold store (full per-row state,
        one record a row) and free them. The freed slots keep their stale
        device contents: ``_slot_id`` = -1 masks them out of nn_search and
        the next fault-in overwrites every leaf."""
        if slots.size == 0:
            return
        rows = self._rows_to_host(self._host(slots))
        gids = self._slot_id[slots]
        for i, g in enumerate(gids.tolist()):
            self.cold_store.put(g, {f: a[i] for f, a in rows.items()})
        self._slot_of[gids] = -1
        self._slot_id[slots] = -1
        self._free_slots.extend(slots.tolist())
        self.tier_spills += int(slots.size)

    def _spill_cold(self) -> None:
        """Proactive spill after a write op: rows untouched for at least
        ``cold_after_rows`` write generations leave the device. An
        O(resident) scan that never walks the full id space."""
        if self.cold_after_rows is None:
            return
        res = np.flatnonzero(self._slot_id >= 0)
        if res.size == 0:
            return
        age = self._gen - self._touch[self._slot_id[res]]
        self._spill_slots(res[age >= self.cold_after_rows])

    def _count_writes(self, ids: np.ndarray) -> None:
        """Charge written rows to the global and the per-shard staleness
        clocks (shard = owner range). The ids were checked, so none needs
        clipping, as the JAX engine's do."""
        self.total_write_rows += ids.size
        self.shard_write_rows += self._owners.count(ids)

    def flush(self) -> None:
        """Expiration path: apply every pending cached gradient now."""
        if self._quantized:
            kbm.kb_flush_q(self.state, self._qscale, self._qoffset,
                           lazy_lr=self.lazy_lr, zmax=self.zmax)
        else:
            self.state = self.backend.flush(self.state, lazy_lr=self.lazy_lr,
                                            zmax=self.zmax)
        self.dispatches += 1

    def nn_search(self, queries, k: int, *, mode: Optional[str] = None,
                  exclude_ids=None) -> Tuple[np.ndarray, np.ndarray]:
        """Top-k MIPS over the bank. ``mode`` overrides ``search_mode`` per
        request; ``"ivf"`` falls back to the exact path when the index is
        absent or past ``ann_stale_rows`` (the winners are re-scored
        against the live table, so the scores returned are exact for the
        ids returned). ``exclude_ids`` (B, E), -1 = no-op, bans rows per
        query: the engine over-fetches ``k + E`` through whichever path is
        live and masks host-side, as the JAX engine does. Deterministic for
        a fixed state and index, so the server may merge same-(k, mode, E)
        requests into one call and slice the results."""
        queries = np.asarray(queries, np.float32)
        B = queries.shape[0]
        if exclude_ids is not None:
            excl = np.asarray(exclude_ids, np.int64).reshape(B, -1)
            self.check_ids(excl, "nn_search exclude_ids", low=-1)
            # capped at the rows searched: the bank's, or a tiered
            # engine's slots
            scores, ids = self.nn_search(
                queries, min(k + excl.shape[1], self.resident_rows),
                mode=mode)
            banned = ((ids[:, :, None] == excl[:, None, :])
                      & (excl[:, None, :] >= 0)).any(-1)
            scores = np.where(banned, -np.inf, scores)
            ids = np.where(banned, -1, ids)
            order = np.argsort(-scores, axis=1, kind="stable")[:, :k]
            return (np.take_along_axis(scores, order, 1),
                    np.take_along_axis(ids, order, 1))
        mode = self.search_mode if mode is None else mode
        _check_search_mode(mode)
        q = self._tensor(np.concatenate(
            [queries, np.zeros((_bucket(B) - B, self.dim), np.float32)]))
        idx = self.ann_index
        if (mode == "ivf" and idx is not None
                and getattr(idx, "n_shards", 1) == self.ann_shards
                and self.ann_staleness_rows <= self.ann_stale_rows):
            nprobe = min(self.ann_nprobe, idx.nlist)
            if self._quantized:
                # over-retrieve 4x so the fp32 master re-rank can recover
                # near-ties the int8 shortlist mis-ordered
                pool = int(idx.bucket_cap) * nprobe
                kq = max(k, min(4 * k, pool))
                scores, ids = self.backend.ivf_search_q(
                    self.state, self._qscale, self._qoffset, idx, q, kq,
                    nprobe)
            else:
                scores, ids = self.backend.ivf_search(self.state, idx, q, k,
                                                      nprobe)
            self.search_stats["ivf"] += 1
        else:
            kk = min(k, self.resident_rows) if self.tiered else k
            if self._quantized:
                scores, ids = kbm.kb_nn_search_q(
                    self.state, self._qscale, self._qoffset, q, kk)
            else:
                scores, ids = self.backend.nn_search(self.state, q, kk)
            self.search_stats["exact"] += 1
        self.dispatches += 1
        scores, ids = scores[:B].cpu().numpy(), ids[:B].cpu().numpy()
        if self.tiered:
            scores, ids = self._tier_translate(scores, ids)
        if self._quantized and self._masters:
            scores, ids = self._master_rerank(queries, scores, ids)
        return scores[:, :k], ids[:, :k]

    def _tier_translate(self, scores: np.ndarray, ids: np.ndarray):
        """The search ran over device SLOTS; map the winners back to global
        ids. Slots that are empty (never occupied, or spilled: their device
        rows are stale) become (-inf, -1) and re-sort to the tail."""
        scores, ids = scores.copy(), ids.copy()
        valid = ids >= 0
        gids = np.full_like(ids, -1)
        gids[valid] = self._slot_id[ids[valid]]
        scores[gids < 0] = -np.inf
        order = np.argsort(-scores, axis=1, kind="stable")
        return (np.take_along_axis(scores, order, 1),
                np.take_along_axis(gids, order, 1))

    def _master_rerank(self, queries: np.ndarray, scores: np.ndarray,
                       ids: np.ndarray):
        """int8 final-score repair: winners that still have an fp32 master
        (pushed by update, not touched by lazy_grad since) are re-scored
        against it, then each row re-sorts."""
        scores, ids = scores.copy(), ids.copy()
        for b in range(scores.shape[0]):
            hit = False
            for j in range(scores.shape[1]):
                m = self._masters.get(int(ids[b, j]))
                if m is not None:
                    scores[b, j] = float(queries[b] @ m)
                    hit = True
            if hit:
                order = np.argsort(-scores[b], kind="stable")
                scores[b] = scores[b][order]
                ids[b] = ids[b][order]
        return scores, ids

    # -- ANN index lifecycle (built off the serving path; see ann_index) ---

    @property
    def ann_staleness_rows(self) -> float:
        """Rows written since the current index was built (inf if none);
        on the sharded backend the WORST shard's, which the exact fallback
        gates on."""
        if self.ann_index is None:
            return float("inf")
        return int((self.shard_write_rows - self._ann_shard_built_at).max())

    @property
    def ann_shard_staleness_rows(self) -> np.ndarray:
        """Rows written to each shard since its sub-index was built,
        (ann_shards,) float64, +inf everywhere while no index exists: the
        refresher's per-shard trigger."""
        if self.ann_index is None:
            return np.full((self.ann_shards,), np.inf)
        return (self.shard_write_rows - self._ann_shard_built_at).astype(
            np.float64)

    def set_ann_index(self, index, *, built_at_shard_writes=None) -> None:
        """Publish a built index. Index first, clock second: a reader that
        pairs the OLD index with the NEW clock would understate staleness;
        this order can only overstate it (a spurious, safe exact
        fallback). ``built_at_shard_writes``: the per-shard write clock
        when the build took its snapshot; without it, the index counts as
        fresh now."""
        if built_at_shard_writes is None:
            built_at_shard_writes = self.shard_write_rows.copy()
        self.ann_index = index
        self._ann_shard_built_at = np.asarray(built_at_shard_writes,
                                              np.int64)

    def _build_index(self, snap, iters: int, shards, base):
        """The new index of ``snap``: one ``IVFIndex`` (or its int8 twin),
        or on the sharded backend the sub-indexes of ``shards`` rebuilt
        from ``base`` (every shard without one), quantized for int8
        storage; ``base`` itself when ``shards`` is empty."""
        if self.ann_shards == 1:
            index = build_ivf_index(snap, nlist=self.ann_nlist, iters=iters)
            return QuantizedIVFIndex(index) if self.storage == "int8" \
                else index
        index = build_sharded_ivf_index(snap, self.ann_shards,
                                        nlist=self.ann_nlist, iters=iters,
                                        base=base, shards=shards)
        if index is base or self.storage != "int8":
            return index
        return QuantizedShardedIVFIndex(index)

    def rebuild_ann_index(self, *, iters: int = 8, shards=None,
                          lock=None) -> int:
        """Snapshot -> cluster -> pack -> publish; safe to call from a
        background thread. The snapshot (a copy of the table, or of its
        dequantization for an int8 table), the write clocks and the
        current index are taken under ``lock``, which the server's
        dispatcher holds for every op, so no in-place op is halfway
        through. On the card the snapshot is queued on the serving
        stream, the build runs on a stream of its own after it, and the
        index is published only when that stream's work is done.

        ``shards`` (sharded backend): re-cluster only those shards'
        sub-indexes; the others keep their arrays and their clocks. A
        capacity overflow repacks every shard and counts as a full
        rebuild; an empty list builds nothing. The single-index backends
        ignore ``shards``. Returns the number of sub-indexes re-clustered
        (the refresher's ``shard_rebuilds``)."""
        with lock if lock is not None else contextlib.nullcontext():
            built_at = self.shard_write_rows.copy()
            prev = self.ann_index
            if self._quantized:
                snap = kbm.dequantize_rows(self.state.table, self._qscale,
                                           self._qoffset)
            else:
                snap = self.state.table.clone()
            if self.device.type == "cuda":
                serving = torch.cuda.current_stream(self.device)
                ready = serving.record_event()
        base = getattr(prev, "base", prev)
        if not isinstance(base, ShardedIVFIndex):
            base = None
        if self.device.type == "cuda":
            if self._build_stream is None:
                self._build_stream = torch.cuda.Stream(self.device)
            stream = self._build_stream
            stream.wait_event(ready)
            with torch.cuda.stream(stream):
                index = self._build_index(snap, iters, shards, base)
            stream.synchronize()
            for t in index.tensors():
                t.record_stream(serving)   # freed only after serving's use
        else:
            index = self._build_index(snap, iters, shards, base)
        if base is not None and getattr(index, "base", index) is base:
            return 0                        # empty shard list: no-op
        if (base is None or shards is None
                or index.bucket_cap != base.bucket_cap):
            self.set_ann_index(index, built_at_shard_writes=built_at)
            return self.ann_shards              # a full (re)build
        # a partial rebuild: the untouched shards keep their clocks
        listed = sorted({int(s) for s in shards})
        clocks = self._ann_shard_built_at.copy()
        clocks[listed] = built_at[listed]
        self.set_ann_index(index, built_at_shard_writes=clocks)
        return len(listed)

    def warmup(self, max_batch: int = 256) -> None:
        """Run every op once at the ``max_batch`` bucket on a small scratch
        state, so that the first request finds each kernel built and
        loaded. The live state is never touched. (The int8 flush and exact
        search are plain PyTorch; the IVF kernels are built at the first
        search through an index.)"""
        bk, S = self.backend, self.ann_shards
        rows = max(S, min(self.num_entries, 64) // S * S)  # S divides it
        scratch = kbm.kb_create(rows, self.dim, device=self.device)
        b = _bucket(max_batch)
        ids = torch.arange(b, device=self.device) % rows
        ones = torch.ones((b, self.dim), device=self.device)
        bk.lazy_grad(scratch, ids, ones, zmax=self.zmax,
                     mask=torch.ones((b,), device=self.device))
        if self._quantized:
            qs = torch.ones((rows,), device=self.device)
            qo = torch.zeros((rows,), device=self.device)
            scratch = scratch._replace(table=torch.zeros(
                (rows, self.dim), dtype=torch.int8, device=self.device))
            bk.lookup_q(scratch, qs, qo, ids, lazy_lr=self.lazy_lr,
                        zmax=self.zmax)
            return
        bk.lookup(scratch, ids, lazy_lr=self.lazy_lr, zmax=self.zmax,
                  apply_pending=self.lazy_update)
        bk.nn_search(scratch, ones[:8], min(8, rows))
        bk.flush(scratch, lazy_lr=self.lazy_lr, zmax=self.zmax)

    # -- state and introspection ------------------------------------------

    def load_state(self, leaves: dict) -> None:
        """Replace the state with copies of numpy ``leaves`` keyed by the
        ``KBState`` field names (``repro_torch.convert``); an int8 engine
        takes int8 codes as ``table`` and its side-cars as ``scale`` and
        ``offset``. A tiered engine refuses: its rows are split between
        slots and the cold store."""
        if self.tiered:
            raise ValueError("load_state: a tiered engine's rows live in "
                             "device slots and the cold store; load an "
                             "untiered engine instead")
        state = kb_state_from_numpy(leaves, self.device)
        want = torch.int8 if self._quantized else torch.float32
        if (tuple(state.table.shape) != (self.num_entries, self.dim)
                or state.table.dtype != want):
            raise ValueError(f"state table {tuple(state.table.shape)} "
                             f"{state.table.dtype} does not match the "
                             f"engine's ({self.num_entries}, {self.dim}) "
                             f"{want}")
        if self._quantized:
            self._qscale, self._qoffset = (
                torch.tensor(np.asarray(leaves[f], np.float32),
                             device=self.device)
                for f in ("scale", "offset"))
        self.state = state

    def _cold_rows(self):
        """The global ids held only by the cold store (not resident), in
        the store's order, and their records."""
        gids = [g for g in self.cold_store.ids() if self._slot_of[g] < 0]
        return gids, [self.cold_store.get(g) for g in gids]

    def _full_space(self, resident: np.ndarray, cold: np.ndarray,
                    gids) -> np.ndarray:
        """Rows of the full id space from the slots' ``resident`` and the
        cold rows ``cold`` of ``gids``; never-touched rows are zeros."""
        out = np.zeros((self.num_entries, *resident.shape[1:]),
                       resident.dtype)
        res = np.flatnonzero(self._slot_id >= 0)
        out[self._slot_id[res]] = resident[res]
        if len(gids):
            out[np.asarray(gids, np.int64)] = cold
        return out

    def table_snapshot(self) -> np.ndarray:
        """Host copy of the live table, (num_entries, D) fp32 (an int8 bank
        dequantized); pending gradients not applied. A tiered engine
        splices the slots and the cold store's rows into the full id
        space (never-touched rows read as zeros), dequantizing the cold
        rows with the slots' arithmetic."""
        if self._quantized:
            tbl = kbm.dequantize_rows(self.state.table, self._qscale,
                                      self._qoffset).cpu().numpy()
        else:
            tbl = self.state.table.to("cpu", copy=True).numpy()
        if not self.tiered:
            return tbl
        gids, recs = self._cold_rows()
        cold = np.zeros((len(gids), self.dim), np.float32)
        if recs and self._quantized:
            cold = kbm.dequantize_rows(*(
                torch.from_numpy(np.stack([r[f] for r in recs]))
                for f in ("table", "scale", "offset"))).numpy()
        elif recs:
            cold = np.stack([r["table"] for r in recs])
        return self._full_space(tbl, cold, gids)

    def version_snapshot(self) -> np.ndarray:
        """Host copy of the per-row version counters; a tiered engine
        splices the cold store's versions into the full id space."""
        ver = self.state.version.to("cpu", copy=True).numpy()
        if not self.tiered:
            return ver
        gids, recs = self._cold_rows()
        cold = np.array([r["version"] for r in recs], np.int32)
        return self._full_space(ver, cold, gids)

    def storage_stats(self) -> dict:
        """Memory-residency accounting, in the JAX engine's keys: a row
        costs D * 4 bytes in fp32 and D codes plus 8 bytes of scale and
        offset in int8; ``resident_rows`` device rows (a tiered engine's
        slots) plus the fp32 masters; ``cold_rows`` records in the cold
        store and the tier's fault and spill counts."""
        bpr = (self.dim * self.state.table.element_size()
               + (8 if self._quantized else 0))
        master_bytes = sum(m.nbytes for m in self._masters.values())
        return {"mode": self.storage, "bytes_per_row": bpr,
                "resident_rows": self.resident_rows,
                "total_rows": self.num_entries,
                "cold_rows": len(self.cold_store) if self.tiered else 0,
                "bytes_resident": bpr * self.resident_rows + master_bytes,
                "master_rows": len(self._masters),
                "tier_faults": int(self.tier_faults),
                "tier_spills": int(self.tier_spills)}

    # every per-row leaf a row owns, in one canonical order: the contract
    # behind replica warm-fill and resharding row streams. export -> import
    # round-trips bit-identically, pending lazy gradients and the clip EMA
    # included
    ROW_LEAVES = ("table", "version", "grad_sum", "grad_cnt",
                  "grad_sqnorm", "norm_ema")

    def _row_ids(self, ids, what: str) -> np.ndarray:
        """``ids`` as int64 after the refusals of the JAX engine: tiered
        and sharded engines, ids outside [0, num_entries)."""
        if self.tiered:
            raise ValueError(f"{what}: tiered engines hold row state "
                             "across device slots + the cold store; "
                             "row-range transfer is not supported")
        if isinstance(self.backend, ShardedBackend):
            raise ValueError(f"{what}: sharded backends are not supported "
                             "(owner-masked row state)")
        return np.asarray(ids).reshape(-1).astype(np.int64)

    def _check_range(self, ids: np.ndarray, what: str) -> None:
        if ids.size and (ids.min() < 0 or ids.max() >= self.num_entries):
            raise ValueError(f"{what}: ids out of range "
                             f"(0..{self.num_entries - 1})")

    def export_rows(self, ids) -> dict:
        """Full per-row state for ``ids`` as ``{leaf: np.ndarray}``:
        ``ROW_LEAVES`` plus the ``scale`` / ``offset`` side-cars on int8
        engines. Values are raw (int8 codes stay codes), so ``import_rows``
        on a same-config engine, of either package, reproduces the rows
        bit-identically, pending lazy gradients and the norm EMA
        included. Tiered and sharded engines refuse."""
        ids = self._row_ids(ids, "export_rows")
        self._check_range(ids, "export_rows")
        rows = self._rows_to_host(self._host(ids))
        return {f: np.ascontiguousarray(a) for f, a in rows.items()}

    def import_rows(self, ids, leaves: dict) -> None:
        """Scatter ``export_rows`` output into this engine's rows: the
        receiving half of replica warm-fill and reshard streaming. The
        leaf set must match this engine's storage. Imported rows count as
        writes (ANN staleness) and drop the fp32 masters of the touched
        ids (a master was exact for the OLD row value)."""
        ids = self._row_ids(ids, "import_rows")
        want = set(self.ROW_LEAVES) | (
            {"scale", "offset"} if self._quantized else set())
        if set(leaves) != want:
            raise ValueError(f"import_rows: leaf set {sorted(leaves)} != "
                             f"expected {sorted(want)} (storage mismatch?)")
        if ids.size == 0:
            return
        self._check_range(ids, "import_rows")
        idx = self._host(ids)
        for f, t in self._leaves().items():
            t.index_copy_(0, idx, self._host(np.asarray(
                leaves[f], _NP_DTYPE[t.dtype]).reshape(ids.size,
                                                       *t.shape[1:])))
        if self._quantized and self._masters:
            for g in np.unique(ids).tolist():
                self._masters.pop(g, None)
        self._count_writes(ids)


def _check_search_mode(mode: str) -> None:
    if mode not in ("exact", "ivf"):
        raise ValueError(f"unknown search mode {mode!r} (want exact | ivf)")
