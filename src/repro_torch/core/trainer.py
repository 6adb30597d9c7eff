"""Model trainer (paper §3.3): the training step and the trainer's traffic
with the Knowledge Bank; the port of ``repro/core/trainer.py``.

Three step builders, as in JAX:

- ``make_carls_train_step``: cross-entropy (+ MoE aux) + the graph
  regulariser on neighbour embeddings fetched from the bank. The gradient
  with respect to the fetched rows goes into the bank's lazy-update cache,
  and the trainer pushes its pooled sample embeddings ("synchronous maker"
  mode).
- ``make_inline_baseline_step``: the paper's comparison point, the K
  neighbours encoded inside the trainer every step.
- ``make_async_train_fns``: the core for a host runtime that fetches the
  neighbour rows outside the step and pushes their gradient afterwards.

All bank traffic goes through a ``KBOps`` bundle (``repro_torch.core.
kb_engine.make_kb_ops``), by default on the kernel backend: on the card a
lookup is one launch of the fused-lookup kernel.

Differences of form from JAX:

- **No ``dist`` argument.** The port has no ``DistContext``; one device
  runs the step, and the multi-card slice brings a process group.
- **In place.** The step updates the ``KBState``, the parameters and the
  optimizer state in place and returns the same objects, as every op of
  the port does.
- ``argnums=(0, 1)`` becomes two kinds of autograd leaf: a detached view
  of each parameter and the looked-up rows, each requiring grad. The
  parameters themselves never require grad, and the autograd graph is
  gone once the gradients are taken.
- ``pooled`` is detached before the trainer push.

The bank traffic and the optimizer run under ``torch.profiler.
record_function`` ranges (``carls.lookup``, ``carls.kb_push``,
``carls.optimizer``), so a profile can give each its device time; the
forward and backward are the rest of the step (autograd runs the
backward on a thread of its own, outside any range of the step's).

On the card the model's forward under grad reaches the sequence kernels
(flash attention from seq² >= 2048², the WKV recurrence, the Mamba scan)
through their ``autograd.Function``s, whose backwards are kernels too
(``repro_torch.kernels.ops``), so every ported architecture trains there.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch
from torch.profiler import record_function

from repro_torch.core.kb_engine import KBOps, make_kb_ops
from repro_torch.models.losses import (chunked_xent, graph_reg_loss,
                                       masked_mean_pool)
from repro_torch.models.model import LM
from repro_torch.optim import AdamW
from repro_torch.tree import tree_items, tree_map_with_path


# the batch key of each front-end's input
FRONTEND_KEYS = {"vision": "patch_embs", "audio": "frames"}


def extra_from_batch(batch: Dict) -> Dict:
    """The front-ends' inputs a batch carries, as JAX's
    ``_extra_from_batch``."""
    return {k: batch[k] for k in FRONTEND_KEYS.values() if k in batch}


def model_loss(model: LM, params, batch, nbr_emb=None,
               reg_weight: float = 0.0, xent_chunk: int = 512):
    """Shared loss: LM cross-entropy (+ 0.01 MoE aux) (+ the CARLS graph
    regulariser), on the text positions (past the vision prefix). Returns
    (loss, (metrics, pooled))."""
    h, prefix, aux, _ = model.hidden(params, batch["tokens"],
                                     extra_from_batch(batch))
    h = h[:, prefix:]
    out_emb = model.out_embed(params)
    ce, metrics = chunked_xent(h, out_emb, batch["labels"], batch["mask"],
                               chunk=xent_chunk)
    pooled = masked_mean_pool(h, batch["mask"])
    loss = ce + 0.01 * aux
    metrics = dict(metrics, ce=ce, aux=aux)
    if nbr_emb is not None and reg_weight > 0:
        reg = graph_reg_loss(pooled, nbr_emb, batch["neighbor_weights"])
        loss = loss + reg_weight * reg
        metrics["graph_reg"] = reg
    return loss, (metrics, pooled)


def _grad_leaves(params):
    """A tree of detached views of ``params`` that require grad."""
    return tree_map_with_path(lambda _, p: p.detach().requires_grad_(),
                              params)


def _value_and_grad(loss_fn, params, *extra):
    """(loss, aux, grads of params as a tree, grads of each ``extra``)
    of ``loss_fn(leaves, *extra_leaves) -> (loss, aux)``; a leaf the loss
    does not reach gets a zero gradient, as in JAX."""
    leaves = _grad_leaves(params)
    extra = [e.detach().requires_grad_(True) for e in extra]
    loss, aux = loss_fn(leaves, *extra)
    items = tree_items(leaves)
    wrt = [p for _, p in items] + extra
    grads = torch.autograd.grad(loss, wrt, allow_unused=True)
    grads = [torch.zeros_like(w) if g is None else g
             for w, g in zip(wrt, grads)]
    by_path = dict(zip((k for k, _ in items), grads))
    gp = tree_map_with_path(lambda path, _: by_path[path], params)
    return loss.detach(), aux, gp, grads[len(items):]


def _detached(metrics: Dict) -> Dict:
    return {k: v.detach() if isinstance(v, torch.Tensor) else v
            for k, v in metrics.items()}


def make_carls_train_step(model: LM, optimizer: AdamW, *,
                          trainer_push: bool = True, xent_chunk: int = 512,
                          kb_ops: Optional[KBOps] = None):
    """Returns step(params, opt_state, kb, batch) -> (params, opt_state,
    kb, metrics), each updated in place. ``batch`` holds tensors on the
    step's device (``SyntheticGraphCorpus.batch``'s fields). The bank is
    threaded through the step; all its traffic goes through ``kb_ops``
    (the kernel backend with the config's lazy-update knobs when not
    given)."""
    cc = model.cfg.carls
    ops = kb_ops if kb_ops is not None else make_kb_ops(
        backend="cuda", lazy_lr=cc.lazy_lr, zmax=cc.outlier_zmax,
        apply_pending=cc.lazy_update)

    def loss_fn(p, nbr, batch):
        return model_loss(model, p, batch, nbr_emb=nbr,
                          reg_weight=cc.reg_weight, xent_chunk=xent_chunk)

    def step(params, opt_state, kb, batch):
        nbr_ids = batch["neighbor_ids"]
        with record_function("carls.lookup"), torch.no_grad():
            nbr_emb, kb = ops.lookup(kb, nbr_ids)
        loss, (metrics, pooled), gp, (gn,) = _value_and_grad(
            lambda p, nbr: loss_fn(p, nbr, batch), params, nbr_emb)
        with record_function("carls.kb_push"), torch.no_grad():
            # DynamicEmbedding-style: embedding grads go to the lazy cache
            kb = ops.lazy_grad(kb, nbr_ids, gn)
            if trainer_push:
                kb = ops.update(kb, batch["sample_ids"], pooled.detach())
        with record_function("carls.optimizer"):
            params, opt_state, gnorm = optimizer.update(gp, opt_state,
                                                        params)
        metrics = dict(_detached(metrics), loss=loss, grad_norm=gnorm,
                       kb_pending=kb.grad_cnt.sum())
        return params, opt_state, kb, metrics

    return step


def make_inline_baseline_step(model: LM, optimizer: AdamW, *,
                              num_neighbors: int, xent_chunk: int = 512):
    """The paper's baseline: the K neighbours encoded inside the trainer
    (``batch["neighbor_tokens"]``: (B, K, S)), so the work grows linearly
    with K. Their embeddings take no gradient (JAX's stop_gradient), so
    they are encoded without autograd."""
    cc = model.cfg.carls

    def step(params, opt_state, batch):
        nt = batch["neighbor_tokens"][:, :num_neighbors]
        B, K, S = nt.shape
        with torch.no_grad():
            nh, npre = model.hidden(params, nt.reshape(B * K, S), {})[:2]
            nh = nh[:, npre:]
            nmask = torch.ones((B * K, S), device=nh.device)
            nbr = masked_mean_pool(nh, nmask).reshape(B, K, -1)

        def loss_fn(p):
            return model_loss(model, p, batch, nbr_emb=nbr,
                              reg_weight=cc.reg_weight,
                              xent_chunk=xent_chunk)

        loss, (metrics, _), gp, _ = _value_and_grad(loss_fn, params)
        params, opt_state, gnorm = optimizer.update(gp, opt_state, params)
        return params, opt_state, dict(_detached(metrics), loss=loss,
                                       grad_norm=gnorm)

    return step


def make_async_train_fns(model: LM, optimizer: AdamW, *,
                         reg_weight: Optional[float] = None,
                         xent_chunk: int = 512):
    """For a host runtime: ``train_core(params, opt_state, batch,
    nbr_emb) -> (params, opt_state, pooled, nbr_grad, metrics)`` takes the
    neighbour embeddings as an input (fetched between steps) and returns
    their gradient (pushed to the bank's lazy cache afterwards);
    ``embed_fn(params, tokens) -> pooled`` encodes without autograd."""
    rw = model.cfg.carls.reg_weight if reg_weight is None else reg_weight

    def train_core(params, opt_state, batch, nbr_emb):
        def loss_fn(p, nbr):
            return model_loss(model, p, batch, nbr_emb=nbr, reg_weight=rw,
                              xent_chunk=xent_chunk)

        loss, (metrics, pooled), gp, (gn,) = _value_and_grad(
            loss_fn, params, nbr_emb)
        params, opt_state, gnorm = optimizer.update(gp, opt_state, params)
        return params, opt_state, pooled.detach(), gn, dict(
            _detached(metrics), loss=loss, grad_norm=gnorm)

    @torch.no_grad()
    def embed_fn(params, tokens):
        h, prefix = model.hidden(params, tokens, {})[:2]
        h = h[:, prefix:]
        mask = torch.ones(tokens.shape, device=h.device)
        return masked_mean_pool(h, mask)

    return train_core, embed_fn
