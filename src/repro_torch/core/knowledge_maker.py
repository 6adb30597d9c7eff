"""Knowledge makers (paper §3.1): programs that load the trainer's latest
parameters and write knowledge into the bank; the port of the two makers
of ``repro/core/knowledge_maker.py`` that the in-graph training loop runs.

- ``make_embedding_refresh``: re-encode a slice of nodes and push their
  embeddings (§4.1 graph regularisation); the push discards the rows'
  pending gradients, which were computed against the old values.
- ``make_embed_fn``: the encoder alone.

Both run without autograd. Every bank write goes through a ``KBOps``
bundle (the kernel backend by default). The label-mining,
graph-agreement and graph-builder makers need the ``FeatureStore`` and
the maker runtime (ROADMAP Q1 item 2).
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core.kb_engine import KBOps, make_kb_ops
from repro_torch.models.losses import masked_mean_pool
from repro_torch.models.model import LM


def make_embed_fn(model: LM):
    """embed(params, node_tokens (B, S)) -> (B, D) fp32 unit-norm mean
    pool of the final hidden states."""
    @torch.no_grad()
    def embed(params, node_tokens):
        h, _, _ = model.hidden(params, node_tokens)
        mask = torch.ones(node_tokens.shape, device=h.device)
        return masked_mean_pool(h, mask)
    return embed


def make_embedding_refresh(model: LM, *, kb_ops: Optional[KBOps] = None):
    """(params, kb, node_ids, node_tokens) -> kb with fresh rows, updated
    in place."""
    ops = kb_ops if kb_ops is not None else make_kb_ops(backend="cuda")
    embed = make_embed_fn(model)

    @torch.no_grad()
    def maker_step(params, kb, node_ids, node_tokens):
        return ops.update(kb, node_ids, embed(params, node_tokens))

    return maker_step
