"""Knowledge makers (paper §3.1): programs that load the trainer's latest
parameters and write knowledge into the bank; the port of
``repro/core/knowledge_maker.py``.

- ``make_embedding_refresh``: re-encode a slice of nodes and push their
  embeddings (§4.1 graph regularisation); the push discards the rows'
  pending gradients, which were computed against the old values.
- ``make_embed_fn``: the encoder alone.
- ``make_label_mining``: re-infer class labels with confidence gating
  (§4.2.1 online label mining for noisy labels).
- ``graph_agreement_labels`` / ``vote_agreement_labels``: labels of nodes
  from the weighted vote of their nearest labeled neighbours in embedding
  space (§4.2.2).
- ``make_graph_builder``: rebuild the neighbourhood graph from the current
  embeddings by a nearest-neighbour search of the bank.

All run without autograd and take no ``dist`` argument (one device runs
them). Every bank op goes through a ``KBOps`` bundle (the kernel backend
by default): on the card a search is the ``nn_search`` kernel, at the
model's width. The asynchronous maker runtime that drives them as
threads is ``repro_torch.core.async_runtime.MakerRuntime``.
"""
from __future__ import annotations

from typing import Callable, Optional, Tuple

import torch

from repro_torch.core import knowledge_bank as kbm
from repro_torch.core.kb_engine import KBOps, make_kb_ops
from repro_torch.models.losses import masked_mean_pool
from repro_torch.models.model import LM


def _ops(kb_ops: Optional[KBOps]) -> KBOps:
    """The makers' one backend-dispatch point."""
    return kb_ops if kb_ops is not None else make_kb_ops(backend="cuda")


def make_embed_fn(model: LM):
    """embed(params, node_tokens (B, S)) -> (B, D) fp32 unit-norm mean
    pool of the final hidden states."""
    @torch.no_grad()
    def embed(params, node_tokens):
        h, prefix = model.hidden(params, node_tokens, {})[:2]
        h = h[:, prefix:]
        mask = torch.ones(node_tokens.shape, device=h.device)
        return masked_mean_pool(h, mask)
    return embed


def make_embedding_refresh(model: LM, *, kb_ops: Optional[KBOps] = None):
    """(params, kb, node_ids, node_tokens) -> kb with fresh rows, updated
    in place."""
    ops = _ops(kb_ops)
    embed = make_embed_fn(model)

    @torch.no_grad()
    def maker_step(params, kb, node_ids, node_tokens):
        return ops.update(kb, node_ids, embed(params, node_tokens))

    return maker_step


def make_label_mining(model: LM, *, num_classes: int,
                      conf_threshold: float = 0.6):
    """§4.2.1: labels from the model's own predictions, written only where
    the prediction's confidence reaches ``conf_threshold`` and beats the
    stored label's (``fs_update_labels`` is gated). Returns
    maker_step(params, fs, node_ids, node_tokens, class_readout) -> (fs,
    (pred, conf)), with ``class_readout(params, h, emb) -> (B,
    num_classes)`` logits."""
    @torch.no_grad()
    def maker_step(params, fs: kbm.FeatureStore, node_ids, node_tokens,
                   class_readout: Callable):
        h, prefix = model.hidden(params, node_tokens, {})[:2]
        mask = torch.ones(node_tokens.shape, device=h.device)
        emb = masked_mean_pool(h[:, prefix:], mask)
        probs = torch.softmax(class_readout(params, h, emb), dim=-1)
        conf, pred = probs.max(-1)
        conf = torch.where(conf >= conf_threshold, conf,
                           torch.zeros_like(conf))
        pred = pred.to(torch.int32)
        return kbm.fs_update_labels(fs, node_ids, pred, conf), (pred, conf)

    return maker_step


@torch.no_grad()
def graph_agreement_labels(kb: kbm.KBState, fs: kbm.FeatureStore,
                           query_emb, query_ids, *, k: int = 8,
                           num_classes: int,
                           kb_ops: Optional[KBOps] = None):
    """§4.2.2 graph agreement: each query's label is the weighted vote of
    its k nearest LABELED neighbours in the current embedding space. The
    unlabeled rows are zeroed before the search (their scores tie at 0 and
    the vote masks them), and the querying node is excluded from its own
    electorate."""
    ops = _ops(kb_ops)
    labeled = fs.labels >= 0
    masked = torch.where(labeled[:, None], kb.table,
                         torch.zeros((), dtype=kb.table.dtype,
                                     device=kb.table.device))
    scores, ids = ops.nn_search(kb._replace(table=masked), query_emb, k,
                                exclude_ids=query_ids[:, None])
    return vote_agreement_labels(scores, ids, fs.labels[ids.long()],
                                 num_classes=num_classes)


def vote_agreement_labels(scores, nbr_ids, nbr_labels, *, num_classes: int,
                          self_ids=None) -> Tuple[torch.Tensor,
                                                  torch.Tensor]:
    """The voting half of graph agreement, over a candidate set already
    fetched (the asynchronous maker gets it from the server's nn_search
    and the labels from the shared feature store). Unlabeled candidates
    (label < 0), and the querying node itself when ``self_ids`` is given,
    get no weight; a query with no labeled candidate gets confidence 0,
    so its gated write does nothing. Takes tensors or numpy arrays;
    returns (labels (B,) int32, confidence (B,) f32) on the scores'
    device."""
    scores = torch.as_tensor(scores, dtype=torch.float32)
    nbr_ids = torch.as_tensor(nbr_ids, device=scores.device)
    nbr_labels = torch.as_tensor(nbr_labels, device=scores.device)
    ok = nbr_labels >= 0
    if self_ids is not None:
        ok = ok & (nbr_ids != torch.as_tensor(
            self_ids, device=scores.device)[:, None])
    w = torch.softmax(torch.where(ok, scores, -torch.inf), dim=-1)
    w = torch.where(ok.any(-1, keepdim=True), w, torch.zeros_like(w))
    onehot = torch.nn.functional.one_hot(
        nbr_labels.long().clamp(min=0), num_classes).to(torch.float32) * \
        ok[..., None]
    tally = torch.einsum("bk,bkc->bc", w, onehot)
    conf, pred = tally.max(-1)
    return pred.to(torch.int32), conf


def make_graph_builder(*, k: int, kb_ops: Optional[KBOps] = None):
    """Dynamic graph discovery: a node's neighbours are the k rows of the
    bank most similar to its own, itself excluded (the backend's
    ``exclude_ids`` path). Returns maker_step(kb, fs, node_ids) -> fs,
    updated in place."""
    ops = _ops(kb_ops)

    @torch.no_grad()
    def maker_step(kb: kbm.KBState, fs: kbm.FeatureStore, node_ids):
        q = kb.table[node_ids.long()].to(torch.float32)
        scores, ids = ops.nn_search(kb, q, k, exclude_ids=node_ids[:, None])
        return kbm.fs_update_neighbors(fs, node_ids, ids,
                                       torch.clamp(scores, min=0.0))

    return maker_step
