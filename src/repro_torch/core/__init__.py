"""CARLS core of the port: Knowledge Bank, Knowledge Makers, Model Trainer
glue and the asynchronous host runtime.

The package re-exports the public API of its submodules, the names of
``repro.core``'s ``__all__`` that the port has, in that order. The names
of slices not ported yet are absent: the ``shard_map`` ops of
``core/sharded_kb.py`` (``kb_axes``, ``kb_pspecs`` and the sharded row
ops), ``PallasBackend`` (the port's kernel backend is ``CudaBackend``),
and the wire protocol, transport and router.

The names are looked up at first use (a module ``__getattr__``), so that
importing one submodule does not import them all: ``kernels.ops``
imports ``core.knowledge_bank``, which runs this file first, and
``core.kb_engine`` imports ``kernels.ops`` in turn.
"""
from __future__ import annotations

import importlib

_SOURCES = (
    ("knowledge_bank", (
        "FeatureStore", "KBState", "feature_store_create",
        "fs_lookup_neighbors", "fs_update_labels", "fs_update_neighbors",
        "kb_create", "kb_flush", "kb_lazy_grad", "kb_lookup", "kb_nn_search",
        "kb_update", "dequantize_rows", "kb_flush_q", "kb_lookup_q",
        "kb_nn_search_q", "kb_update_q", "quantize_rows",
        "quantized_scores")),
    ("kb_storage", ("DiskColdStore", "MemoryColdStore", "make_cold_store")),
    ("sharded_kb", ("sharded_kb_nn_search", "sharded_kb_nn_search_ivf")),
    ("kb_engine", ("DenseBackend", "KBBackend", "KBEngine", "KBOps",
                   "ShardedBackend", "make_backend", "make_kb_ops")),
    ("ann_index", ("IVFIndex", "IVFRefresher", "QuantizedIVFIndex",
                   "QuantizedShardedIVFIndex", "ShardedIVFIndex",
                   "build_ivf_index", "build_sharded_ivf_index", "kmeans")),
    ("trainer", ("make_async_train_fns", "make_carls_train_step",
                 "make_inline_baseline_step", "model_loss")),
    ("knowledge_maker", ("graph_agreement_labels", "make_embed_fn",
                         "make_embedding_refresh", "make_graph_builder",
                         "make_label_mining", "vote_agreement_labels")),
    ("async_runtime", ("AsyncRunResult", "KBServerClosedError",
                       "KnowledgeBankServer", "MakerJob", "MakerRuntime",
                       "SharedFeatureStore", "format_maker_stats",
                       "run_async_training")),
)
_MODULE_OF = {name: mod for mod, names in _SOURCES for name in names}

__all__ = [name for _, names in _SOURCES for name in names]


def __getattr__(name: str):
    mod = _MODULE_OF.get(name)
    if mod is None:
        raise AttributeError(f"module {__name__!r} has no attribute "
                             f"{name!r}")
    value = getattr(importlib.import_module(f"{__name__}.{mod}"), name)
    globals()[name] = value
    return value


def __dir__():
    return sorted(set(globals()) | set(__all__))
