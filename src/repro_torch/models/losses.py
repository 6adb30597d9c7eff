"""Losses of the training path; the port of ``repro/models/losses.py``.

Sequence-chunked softmax cross-entropy with a z-loss, the masked mean
pool that gives a sequence its embedding, the CARLS graph regulariser
over neighbour embeddings served by the bank, and the two-tower
contrastive loss (paper §4.3). Each function is the JAX function term for
term, and autograd differentiates it.

``chunked_xent`` never holds the (B, S, V) logits: each chunk of
``chunk`` positions runs under ``torch.utils.checkpoint`` (the JAX
function's ``jax.checkpoint(..., nothing_saveable)`` per chunk), so the
forward keeps only the chunk's four sums and the backward recomputes the
chunk's (B, chunk, V) block, one at a time.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint


def _chunk_sums(h_c, out_embed, l_c, m_c):
    """The summed nll, z-loss, token count and hits of one chunk."""
    logits = (h_c @ out_embed.T).float()                    # (B, c, V)
    logz = torch.logsumexp(logits, dim=-1)
    ll = torch.take_along_dim(logits, l_c[..., None].long(), dim=-1)[..., 0]
    nll = (logz - ll) * m_c
    zl = torch.square(logz) * m_c
    acc = (torch.argmax(logits, dim=-1) == l_c).float() * m_c
    return nll.sum(), zl.sum(), m_c.sum(), acc.sum()


def chunked_xent(hidden, out_embed, labels, mask, *, chunk: int = 512,
                 z_loss: float = 1e-4):
    """hidden: (B, S, D); out_embed: (V, D); labels/mask: (B, S).
    Returns (mean nll over masked tokens + z_loss times the mean squared
    log-partition, metrics {"nll", "acc", "tokens"})."""
    B, S, D = hidden.shape
    chunk = min(chunk, S)
    mask = mask.float()
    if S % chunk != 0:  # pad to a multiple (mask handles correctness)
        pad = chunk - S % chunk
        hidden = F.pad(hidden, (0, 0, 0, pad))
        labels = F.pad(labels, (0, pad))
        mask = F.pad(mask, (0, pad))
        S += pad
    zero = torch.zeros((), device=hidden.device)
    nll, zl, n, acc = zero, zero, zero, zero
    for c in range(S // chunk):
        sl = slice(c * chunk, (c + 1) * chunk)
        parts = checkpoint(_chunk_sums, hidden[:, sl], out_embed,
                           labels[:, sl], mask[:, sl], use_reentrant=False)
        nll, zl, n, acc = (a + b for a, b in zip((nll, zl, n, acc), parts))
    n = torch.clamp(n, min=1.0)
    loss = nll / n + z_loss * zl / n
    return loss, {"nll": nll / n, "acc": acc / n, "tokens": n}


def masked_mean_pool(hidden, mask):
    """hidden: (B, S, D); mask: (B, S) -> (B, D) fp32, l2-normalized."""
    m = mask.float()
    s = torch.einsum("bsd,bs->bd", hidden.float(), m)
    emb = s / torch.clamp(m.sum(-1, keepdim=True), min=1.0)
    return emb / torch.clamp(torch.linalg.norm(emb, dim=-1, keepdim=True),
                             min=1e-6)


def graph_reg_loss(pooled, nbr_emb, nbr_weights):
    """Paper §4.1 graph regulariser: the weighted squared distance between
    a node's embedding and its (bank-served) neighbour embeddings.

    pooled: (B, D); nbr_emb: (B, K, D); nbr_weights: (B, K) (0 = missing)."""
    d = pooled[:, None, :] - nbr_emb.float()
    dist = torch.sum(torch.square(d), dim=-1)                 # (B, K)
    w = nbr_weights.float()
    return torch.sum(dist * w) / torch.clamp(torch.sum(w), min=1.0)


def contrastive_loss(emb_a, emb_b, temperature: float = 0.07,
                     extra_negatives=None):
    """Symmetric InfoNCE over in-batch pairs plus an optional bank-served
    pool of negatives (paper §4.3).

    emb_a/emb_b: (B, D) l2-normalized; extra_negatives: (N, D)."""
    logits = emb_a @ emb_b.T / temperature                    # (B, B)
    if extra_negatives is not None:
        neg = emb_a @ extra_negatives.T / temperature         # (B, N)
        logits_a = torch.cat([logits, neg], dim=1)
    else:
        logits_a = logits
    labels = torch.arange(emb_a.shape[0], device=emb_a.device)[:, None]
    la = -torch.take_along_dim(torch.log_softmax(logits_a, -1), labels,
                               1).mean()
    lb = -torch.take_along_dim(torch.log_softmax(logits.T, -1), labels,
                               1).mean()
    return 0.5 * (la + lb)
