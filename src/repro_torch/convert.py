"""State and indexes carried between the JAX package and the port, as numpy.

A bank state is a dict keyed by the JAX ``KBState`` field names
(``repro/core/knowledge_bank.py:43-50``): ``table``, ``version``,
``grad_sum``, ``grad_cnt``, ``grad_sqnorm``, ``norm_ema``, ``step``. The
``table`` of an int8 bank holds its int8 codes, and the dict then carries
the engine's side-cars as ``scale`` and ``offset``, as the JAX engine's
``export_rows`` names them. The tests start both packages from one such
dict; ``KBEngine.load_state`` takes one too.

``lm_params_from_numpy`` turns the JAX ``LM.init`` pytree, flattened to
numpy arrays under ``::``-joined key paths (as
``repro.checkpoint.checkpointing.flatten_params`` writes them), into the
port's nested parameter dicts; ``lm_params_to_numpy`` is its inverse (a
bf16 leaf widened to fp32, which narrows back exactly).
``adamw_state_from_numpy`` and ``adamw_state_to_numpy`` carry an AdamW
state (its ``count`` and its two moment trees, flattened the same way), so
that both packages can start a step from one state and be compared after
it.

``ivf_index_from`` turns an IVF index of either package (any object with
the index's array attributes, read through ``np.asarray``, so a JAX
``IVFIndex`` or ``QuantizedIVFIndex`` converts without this module
importing JAX) into the port's, so that one index can be searched by both;
``sharded_ivf_index_from`` does the same for a ``ShardedIVFIndex`` or
``QuantizedShardedIVFIndex``.
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from repro_torch.core.ann_index import (IVFIndex, QuantizedIVFIndex,
                                        QuantizedShardedIVFIndex,
                                        ShardedIVFIndex)
from repro_torch.checkpoint.checkpointing import flatten_params
from repro_torch.core.knowledge_bank import KBState
from repro_torch.env import resolve_device
from repro_torch.optim import AdamWState
from repro_torch.tree import SEP

_DTYPES = {"table": np.float32, "version": np.int32, "grad_sum": np.float32,
           "grad_cnt": np.float32, "grad_sqnorm": np.float32,
           "norm_ema": np.float32, "step": np.int32}


def kb_state_from_numpy(leaves: Dict[str, np.ndarray],
                        device="cuda") -> KBState:
    """A ``KBState`` on ``device`` holding copies of ``leaves``; an int8
    ``table`` stays int8 (the codes of a quantized bank)."""
    device = resolve_device(device)
    missing = set(KBState._fields) - set(leaves)
    if missing:
        raise ValueError(f"state leaves missing: {sorted(missing)}")

    def dtype(f):
        if f == "table" and np.asarray(leaves[f]).dtype == np.int8:
            return np.int8
        return _DTYPES[f]

    return KBState(**{
        f: torch.tensor(np.asarray(leaves[f], dtype=dtype(f)),
                        device=device)
        for f in KBState._fields})


# the fp32 leaves of an LM, as ``repro.models`` makes them: the norm
# scales (whisper's cross-attention norm ``ln_ca`` and its encoder's
# ``ln1``, ``ln2`` and ``ln_out`` among them, repro/models/model.py:84 and
# repro/models/transformer.py:157-161), RWKV6's per-head bonus ``u``,
# decay base ``dec_0`` and group-norm scale ``ln_x``
# (repro/models/ssm.py:203-206), and Mamba's ``a_log`` and ``d_skip``
# (repro/models/ssm.py:75-76); every other leaf, RWKV6's ``mu`` and
# Mamba's ``dt_bias`` included, is cfg.dtype
LM_FP32_LEAVES = ("ln1", "ln2", "final_norm", "ln_ca", "ln_out", "u",
                  "dec_0", "ln_x", "a_log", "d_skip")


def _nest(flat: Dict[str, np.ndarray], dtype_of, device) -> dict:
    """Nested dicts on ``device`` from ``{"a::b::c": array}``, each leaf
    in ``dtype_of(its last key)`` (through fp32, so a bf16 leaf widened
    to fp32 narrows back exactly)."""
    device = resolve_device(device)
    tree: dict = {}
    for key, arr in flat.items():
        *path, leaf = key.split(SEP)
        node = tree
        for part in path:
            node = node.setdefault(part, {})
        node[leaf] = torch.tensor(np.asarray(arr, np.float32),
                                  device=device).to(dtype_of(leaf))
    return tree


def lm_params_from_numpy(flat: Dict[str, np.ndarray], cfg,
                         device="cuda") -> dict:
    """The port's LM parameters on ``device`` from ``{"a::b::c": array}``:
    the leaves of ``LM_FP32_LEAVES`` in fp32, every other leaf in
    ``cfg.dtype`` (a bf16 leaf that was widened to fp32 to be stored in
    numpy narrows back exactly). Arrays may also be bf16 arrays of
    ``ml_dtypes``."""
    dtype = getattr(torch, cfg.dtype)
    return _nest(flat, lambda leaf: torch.float32
                 if leaf in LM_FP32_LEAVES else dtype, device)


def lm_params_to_numpy(params) -> Dict[str, np.ndarray]:
    """``{"a::b::c": array}`` host copies of the port's LM parameters, bf16
    leaves widened to fp32: what the JAX ``flatten_params`` gives for the
    same tree."""
    return flatten_params(params)




def adamw_state_from_numpy(state: Dict, *, moments_dtype="float32",
                           device="cuda") -> AdamWState:
    """An ``AdamWState`` on ``device`` from ``{"count": int, "mu": flat,
    "nu": flat}``, each moment leaf in ``moments_dtype``."""
    device = resolve_device(device)
    dtype = getattr(torch, moments_dtype)
    return AdamWState(
        count=torch.tensor(int(state["count"]), dtype=torch.int32,
                           device=device),
        mu=_nest(state["mu"], lambda _: dtype, device),
        nu=_nest(state["nu"], lambda _: dtype, device))


def adamw_state_to_numpy(state: AdamWState) -> Dict:
    """``{"count": int, "mu": flat, "nu": flat}`` host copies of
    ``state``, bf16 moments widened to fp32."""
    return {"count": int(state.count), "mu": flatten_params(state.mu),
            "nu": flatten_params(state.nu)}


def kb_state_to_numpy(state: KBState) -> Dict[str, np.ndarray]:
    """Host copies of every leaf of ``state``."""
    return {f: getattr(state, f).detach().to("cpu", copy=True).numpy()
            for f in KBState._fields}


def ivf_index_from(src, device="cuda"):
    """The port's ``IVFIndex`` (or ``QuantizedIVFIndex``, when ``src`` has
    ``packed_codes``) holding copies of ``src``'s arrays on ``device``."""
    device = resolve_device(device)

    def t(name, dtype):
        return torch.tensor(np.asarray(getattr(src, name), dtype=dtype),
                            device=device)

    quantized = hasattr(src, "packed_codes")
    rows = np.asarray(src.packed_ids).shape[0]
    base = IVFIndex(
        t("centroids", np.float32),
        None if quantized else t("packed_vecs", np.float32),
        t("packed_ids", np.int32), nlist=int(src.nlist),
        bucket_cap=int(src.bucket_cap), n_rows=int(src.n_rows),
        bucket_occ=t("bucket_occ", np.int32))
    if rows != base.nlist * base.bucket_cap:
        raise ValueError(f"{rows} packed slots != nlist {base.nlist} x cap "
                         f"{base.bucket_cap}")
    if not quantized:
        return base
    return QuantizedIVFIndex(base, quantized=(
        t("packed_codes", np.int8), t("packed_scale", np.float32),
        t("packed_offset", np.float32)))


def sharded_ivf_index_from(src, device="cuda"):
    """The port's ``ShardedIVFIndex`` (or ``QuantizedShardedIVFIndex``,
    with its fp32 ``base``, when ``src`` has ``packed_codes``) holding
    copies of ``src``'s arrays on ``device``."""
    device = resolve_device(device)

    def copy(obj, name, dtype):
        return torch.tensor(np.asarray(getattr(obj, name), dtype=dtype),
                            device=device)

    quantized = hasattr(src, "packed_codes")
    b = src.base if quantized else src
    base = ShardedIVFIndex(
        copy(b, "centroids", np.float32), copy(b, "packed_vecs", np.float32),
        copy(b, "packed_ids", np.int32), n_shards=int(src.n_shards),
        nlist=int(src.nlist), bucket_cap=int(src.bucket_cap),
        n_rows=int(src.n_rows), bucket_occ=copy(b, "bucket_occ", np.int32))
    slots = base.n_shards * base.nlist * base.bucket_cap
    if base.packed_ids.shape[0] != slots:
        raise ValueError(f"{base.packed_ids.shape[0]} packed slots != "
                         f"{base.n_shards} shards x nlist {base.nlist} x "
                         f"cap {base.bucket_cap}")
    if not quantized:
        return base
    return QuantizedShardedIVFIndex(base, quantized=(
        copy(src, "packed_codes", np.int8),
        copy(src, "packed_scale", np.float32),
        copy(src, "packed_offset", np.float32)))
