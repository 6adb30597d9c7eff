"""Pluggable Knowledge-Bank engine: one semantics, two execution backends.

The port of ``repro.core.kb_engine`` for fp32 storage and exact search:

- ``KBBackend``   : the protocol, ops over the shared ``KBState`` of
                    ``repro_torch.core.knowledge_bank``.
- ``DenseBackend``: the plain PyTorch reference ops (the semantics ground
                    truth), chosen only explicitly.
- ``CudaBackend`` : the serving path and the default, in place of the JAX
                    package's ``PallasBackend`` (``kb_engine.py:189-251``).
                    ``lookup`` runs the fused apply-and-clear kernel,
                    ``lookup(apply_pending=False)`` the row gather,
                    ``flush`` the lazy-apply kernel, ``nn_search`` the exact
                    MIPS kernel. Writes (update / lazy_grad) are plain
                    scatters with nothing to fuse and stay plain PyTorch.
                    On CPU tensors each kernel wrapper runs its plain
                    version, which is how the CPU tests drive this backend.

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

Options this slice does not port raise ``NotImplementedError`` naming the
ROADMAP item that holds them: ``storage="int8"``, ``resident_rows``,
``search_mode="ivf"`` and the sharded backend.

The engine is NOT thread-safe: the server layer serialises access.
"""
from __future__ import annotations

from typing import Callable, NamedTuple, Optional, Protocol, Tuple

import numpy as np
import torch

from repro_torch.convert import kb_state_from_numpy
from repro_torch.core import knowledge_bank as kbm
from repro_torch.core.knowledge_bank import KBState
from repro_torch.env import resolve_device
from repro_torch.kernels import ops


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


class CudaBackend:
    """The serving path: the read-side ops and the flush go through the
    port's CUDA kernels (``repro_torch.kernels.ops``)."""

    name = "cuda"

    def lookup(self, state, ids, *, lazy_lr, zmax, apply_pending=True):
        flat = ids.reshape(-1).long()
        if not apply_pending:
            return (ops.kb_gather(state.table, flat).reshape(*ids.shape, -1),
                    state)
        # version is (N,) metadata: +1 per touched row with pending
        # gradients, read before the kernel clears grad_cnt (duplicates
        # write equal values)
        rows = flat[(flat >= 0) & (flat < state.table.shape[0])]
        state.version[rows] = (state.version[rows]
                               + (state.grad_cnt[rows] > 0).to(torch.int32))
        vals = ops.kb_fused_lookup(state.table, state.grad_sum,
                                   state.grad_cnt, state.grad_sqnorm, flat,
                                   lazy_lr=lazy_lr, zmax=zmax)
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


def make_backend(name: str) -> KBBackend:
    """Backend factory: ``cuda | dense``. Both satisfy the same contract
    (tests/test_torch_engine.py holds them against each other and against
    the JAX package)."""
    if name == "cuda":
        return CudaBackend()
    if name == "dense":
        return DenseBackend()
    if name == "sharded":
        raise NotImplementedError(
            "the sharded backend is not ported yet (ROADMAP Q1 item 9)")
    raise ValueError(f"unknown KB backend {name!r} (want cuda | dense)")


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


def _bucket(n: int, minimum: int = 8) -> int:
    """Next power-of-two bucket (>= minimum)."""
    return max(minimum, 1 << max(n - 1, 0).bit_length())


def _pad_repeat(a: np.ndarray, pad: int) -> np.ndarray:
    """``a`` with its last entry repeated ``pad`` more times."""
    return np.concatenate([a, np.repeat(a[-1:], pad, 0)])


class KBEngine:
    """Stateful, host-facing shell around a ``KBBackend``: numpy in, numpy
    out, state on ``device`` updated in place. Single-threaded by
    contract."""

    def __init__(self, num_entries: int, dim: int, *, backend="cuda",
                 lazy_lr: float = 0.1, zmax: float = 3.0,
                 lazy_update: bool = True, search_mode: str = "exact",
                 storage: str = "fp32",
                 resident_rows: Optional[int] = None, device="cuda"):
        if storage == "int8":
            raise NotImplementedError(
                "storage='int8' is not ported yet (ROADMAP Q2 item 6, the "
                "int8 twins)")
        if storage != "fp32":
            raise ValueError(f"unknown storage {storage!r} (want fp32)")
        if resident_rows is not None:
            raise NotImplementedError(
                "tiered residency (resident_rows) is not ported yet "
                "(ROADMAP Q1 item 3)")
        _check_search_mode(search_mode)
        self.device = resolve_device(device)
        self.backend: KBBackend = (backend if not isinstance(backend, str)
                                   else make_backend(backend))
        self.num_entries, self.dim = num_entries, dim
        # one zmax clips both at entry (lazy_grad, against the norm EMA)
        # and at apply time, as the JAX engine's default entry_zmax does
        self.lazy_lr, self.zmax, self.lazy_update = lazy_lr, zmax, lazy_update
        self.search_mode = search_mode
        self.storage = storage
        self.search_stats = {"exact": 0, "ivf": 0}
        self.dispatches = 0         # device calls issued (bench metric)
        self.state = kbm.kb_create(num_entries, dim, device=self.device)

    def _tensor(self, a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(a)).to(self.device)

    # -- embedding ops -----------------------------------------------------

    def lookup(self, ids) -> np.ndarray:
        """Fetch rows (applying pending lazy updates first unless the engine
        is the immediate-update ablation); any id shape. Deterministic under
        duplicate ids and the bucket padding, which repeats a real id."""
        ids = np.asarray(ids)
        flat = ids.reshape(-1).astype(np.int64)
        if flat.size == 0:
            return np.zeros((*ids.shape, self.dim), np.float32)
        padded = _pad_repeat(flat, _bucket(flat.size) - flat.size)
        vals, self.state = self.backend.lookup(
            self.state, self._tensor(padded), lazy_lr=self.lazy_lr,
            zmax=self.zmax, apply_pending=self.lazy_update)
        self.dispatches += 1
        return vals[:flat.size].cpu().numpy().reshape(*ids.shape, -1)

    def update(self, ids, values) -> None:
        """Direct write (maker push); duplicate ids resolve last-writer-wins
        (host-side dedupe: a device scatter's order is unspecified)."""
        ids = np.asarray(ids).reshape(-1).astype(np.int64)
        if ids.size == 0:
            return
        values = np.asarray(values, np.float32).reshape(ids.size, -1)
        _, keep = np.unique(ids[::-1], return_index=True)
        keep = ids.size - 1 - keep          # last occurrence of each id
        ids, values = ids[keep], values[keep]
        pad = _bucket(ids.size) - ids.size
        self.state = self.backend.update(
            self.state, self._tensor(_pad_repeat(ids, pad)),
            self._tensor(_pad_repeat(values, pad)))
        self.dispatches += 1

    def lazy_grad(self, ids, grads) -> None:
        """Cache gradients (or apply them at once when lazy_update=False).
        Padded entries carry a 0 mask and are inert; cache adds commute, so
        a coalesced multi-client batch equals any serial interleaving."""
        ids = np.asarray(ids).reshape(-1).astype(np.int64)
        if ids.size == 0:
            return
        grads = np.asarray(grads, np.float32).reshape(ids.size, -1)
        n = ids.size
        pad = _bucket(n) - n
        ids_t = self._tensor(_pad_repeat(ids, pad))
        grads_t = self._tensor(np.concatenate(
            [grads, np.zeros((pad, grads.shape[1]), np.float32)]))
        mask_t = self._tensor(np.concatenate([np.ones(n, np.float32),
                                              np.zeros(pad, np.float32)]))
        if self.lazy_update:
            self.state = self.backend.lazy_grad(
                self.state, ids_t, grads_t, zmax=self.zmax, mask=mask_t)
        else:
            # ablation baseline: immediate SGD scatter-add, no cache;
            # duplicates add in occurrence order, without atomics
            kbm.index_add_in_order(
                self.state.table, ids_t,
                -self.lazy_lr * grads_t * mask_t[:, None],
                kbm.occurrence_rounds(ids_t))
        self.dispatches += 1

    def flush(self) -> None:
        """Expiration path: apply every pending cached gradient now."""
        self.state = self.backend.flush(self.state, lazy_lr=self.lazy_lr,
                                        zmax=self.zmax)
        self.dispatches += 1

    def nn_search(self, queries, k: int, *, mode: Optional[str] = None,
                  exclude_ids=None) -> Tuple[np.ndarray, np.ndarray]:
        """Exact top-k MIPS over the bank. ``exclude_ids`` (B, E), -1 =
        no-op, bans rows per query: the engine over-fetches ``k + E`` and
        masks host-side, as the JAX engine does. Deterministic for a fixed
        state, so the server may merge same-(k, mode, E) requests into one
        call and slice the results."""
        queries = np.asarray(queries, np.float32)
        B = queries.shape[0]
        if exclude_ids is not None:
            excl = np.asarray(exclude_ids, np.int64).reshape(B, -1)
            scores, ids = self.nn_search(
                queries, min(k + excl.shape[1], self.num_entries), mode=mode)
            banned = ((ids[:, :, None] == excl[:, None, :])
                      & (excl[:, None, :] >= 0)).any(-1)
            scores = np.where(banned, -np.inf, scores)
            ids = np.where(banned, -1, ids)
            order = np.argsort(-scores, axis=1, kind="stable")[:, :k]
            return (np.take_along_axis(scores, order, 1),
                    np.take_along_axis(ids, order, 1))
        _check_search_mode(self.search_mode if mode is None else mode)
        q = np.concatenate([queries, np.zeros((_bucket(B) - B, self.dim),
                                              np.float32)])
        scores, ids = self.backend.nn_search(self.state, self._tensor(q), k)
        self.search_stats["exact"] += 1
        self.dispatches += 1
        return scores[:B].cpu().numpy(), ids[:B].cpu().numpy()

    def warmup(self, max_batch: int = 256) -> None:
        """Run every op once at the ``max_batch`` bucket on a small scratch
        state, so that the first request finds each kernel built and
        loaded. The live state is never touched."""
        bk, rows = self.backend, min(self.num_entries, 64)
        scratch = kbm.kb_create(rows, self.dim, device=self.device)
        b = _bucket(max_batch)
        ids = torch.arange(b, device=self.device) % rows
        ones = torch.ones((b, self.dim), device=self.device)
        bk.lazy_grad(scratch, ids, ones, zmax=self.zmax,
                     mask=torch.ones((b,), device=self.device))
        bk.lookup(scratch, ids, lazy_lr=self.lazy_lr, zmax=self.zmax,
                  apply_pending=self.lazy_update)
        bk.nn_search(scratch, ones[:8], min(8, rows))
        bk.flush(scratch, lazy_lr=self.lazy_lr, zmax=self.zmax)

    # -- state and introspection ------------------------------------------

    def load_state(self, leaves: dict) -> None:
        """Replace the state with copies of numpy ``leaves`` keyed by the
        ``KBState`` field names (``repro_torch.convert``)."""
        state = kb_state_from_numpy(leaves, self.device)
        if tuple(state.table.shape) != (self.num_entries, self.dim):
            raise ValueError(f"state table {tuple(state.table.shape)} does "
                             f"not match the engine's "
                             f"({self.num_entries}, {self.dim})")
        self.state = state

    def table_snapshot(self) -> np.ndarray:
        """Host copy of the live table (pending gradients not applied)."""
        return self.state.table.to("cpu", copy=True).numpy()

    def version_snapshot(self) -> np.ndarray:
        """Host copy of the per-row version counters."""
        return self.state.version.to("cpu", copy=True).numpy()

    def storage_stats(self) -> dict:
        """Memory-residency accounting, in the JAX engine's keys: every row
        is a resident fp32 row here."""
        bpr = self.dim * self.state.table.element_size()
        return {"mode": self.storage, "bytes_per_row": bpr,
                "resident_rows": self.num_entries,
                "total_rows": self.num_entries, "cold_rows": 0,
                "bytes_resident": bpr * self.num_entries, "master_rows": 0,
                "tier_faults": 0, "tier_spills": 0}


def _check_search_mode(mode: str) -> None:
    if mode == "ivf":
        raise NotImplementedError(
            "search_mode='ivf' is not ported yet (ROADMAP Q1 item 4, Q2 "
            "item 5)")
    if mode != "exact":
        raise ValueError(f"unknown search mode {mode!r} (want exact)")
