"""The port's losses (repro_torch.models.losses) held against the JAX
package's (repro.models.losses) on the same numpy inputs: values and
their gradients (autograd against ``jax.grad``).

Bounds: values atol 1e-5 + rtol 1e-5, the reduced LM's (the logsumexp
and the pooled sums run in another order); gradients of these fp32
inputs atol 1e-6 (they are of order 1e-3 to 1e-1, so that is a few fp32
ulps of the largest); the accuracy and token count exactly.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import losses as JL
from repro_torch.models import losses as TL

ATOL, RTOL, GRAD_ATOL = 1e-5, 1e-5, 1e-6


def _t(a):
    return torch.from_numpy(np.array(a)).requires_grad_(
        np.asarray(a).dtype == np.float32)


def _close(got, want, label, atol=ATOL, rtol=RTOL):
    if isinstance(got, torch.Tensor):
        got = got.detach()
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               atol=atol, rtol=rtol, err_msg=label)


@pytest.mark.parametrize("S,chunk", [(16, 8), (13, 5), (7, 512)])
def test_chunked_xent_matches_jax(S, chunk):
    rng = np.random.default_rng(S)
    B, D, V = 3, 16, 40
    h = rng.standard_normal((B, S, D)).astype(np.float32)
    emb = (rng.standard_normal((V, D)) * 0.3).astype(np.float32)
    labels = rng.integers(0, V, (B, S)).astype(np.int32)
    mask = (rng.random((B, S)) > 0.2).astype(np.float32)
    # a few sure hits, so acc is not 0
    labels[0, :3] = np.argmax(h[0, :3] @ emb.T, -1)

    def jloss(h, e):
        return JL.chunked_xent(h, e, labels, mask, chunk=chunk)

    (jl, jm), (jgh, jge) = jax.value_and_grad(jloss, argnums=(0, 1),
                                              has_aux=True)(h, emb)
    th, te = _t(h), _t(emb)
    tl, tm = TL.chunked_xent(th, te, torch.from_numpy(labels),
                             torch.from_numpy(mask), chunk=chunk)
    gh, ge = torch.autograd.grad(tl, (th, te))
    _close(tl, jl, "loss")
    _close(tm["nll"], jm["nll"], "nll")
    assert float(tm["tokens"]) == float(jm["tokens"])
    assert float(tm["acc"]) == float(jm["acc"]) > 0
    _close(gh, jgh, "d hidden", atol=GRAD_ATOL, rtol=0)
    _close(ge, jge, "d out_embed", atol=GRAD_ATOL, rtol=0)


def test_chunked_xent_keeps_one_chunk_of_logits():
    """Under the checkpoint the forward saves no (B, chunk, V) block."""
    B, S, D, V, chunk = 2, 32, 8, 1000, 8
    h = torch.randn(B, S, D, requires_grad=True)
    e = torch.randn(V, D, requires_grad=True)
    saved = []
    with torch.autograd.graph.saved_tensors_hooks(
            lambda x: saved.append(x.numel()) or x, lambda x: x):
        loss, _ = TL.chunked_xent(h, e, torch.zeros(B, S, dtype=torch.int64),
                                  torch.ones(B, S), chunk=chunk)
    assert max(saved) < B * chunk * V
    loss.backward()
    assert h.grad.shape == h.shape


def test_pool_and_graph_reg_match_jax():
    rng = np.random.default_rng(1)
    B, S, D, K = 4, 9, 16, 3
    h = rng.standard_normal((B, S, D)).astype(np.float32)
    mask = (rng.random((B, S)) > 0.3).astype(np.float32)
    mask[2] = 0.0                                   # an empty row
    nbr = (rng.standard_normal((B, K, D)) * 0.3).astype(np.float32)
    w = (rng.random((B, K)) > 0.3).astype(np.float32)

    def jfn(h, nbr):
        pooled = JL.masked_mean_pool(h, mask)
        return JL.graph_reg_loss(pooled, nbr, w), pooled

    (jr, jp), (jgh, jgn) = jax.value_and_grad(jfn, argnums=(0, 1),
                                              has_aux=True)(h, nbr)
    th, tn = _t(h), _t(nbr)
    tp = TL.masked_mean_pool(th, torch.from_numpy(mask))
    tr = TL.graph_reg_loss(tp, tn, torch.from_numpy(w))
    gh, gn = torch.autograd.grad(tr, (th, tn))
    _close(tp, jp, "pooled")
    _close(tr, jr, "graph_reg")
    # the empty row pools to 0, where the norm's derivative is 0/0: JAX's
    # is NaN, torch's 0 (a deliberate difference, ROADMAP); the trainer's
    # masks are all ones
    jgh = np.asarray(jgh)
    assert np.isnan(jgh[2]).all() and not np.isnan(np.delete(jgh, 2, 0)).any()
    assert not gh[2].any()
    _close(np.delete(gh.numpy(), 2, 0), np.delete(jgh, 2, 0), "d hidden",
           atol=GRAD_ATOL, rtol=0)
    _close(gn, jgn, "d nbr", atol=GRAD_ATOL, rtol=0)


@pytest.mark.parametrize("negatives", [0, 5])
def test_contrastive_loss_matches_jax(negatives):
    rng = np.random.default_rng(2 + negatives)

    def unit(n):
        x = rng.standard_normal((n, 8)).astype(np.float32)
        return x / np.linalg.norm(x, axis=-1, keepdims=True)

    a, b = unit(6), unit(6)
    neg = unit(negatives) if negatives else None
    args = (a, b) + ((neg,) if negatives else ())

    def jfn(*xs):
        return JL.contrastive_loss(xs[0], xs[1], 0.07,
                                   xs[2] if negatives else None)

    jl, jg = jax.value_and_grad(jfn, argnums=tuple(range(len(args))))(*args)
    ts = [_t(x) for x in args]
    tl = TL.contrastive_loss(ts[0], ts[1], 0.07,
                             ts[2] if negatives else None)
    tg = torch.autograd.grad(tl, ts)
    _close(tl, jl, "loss")
    for i, (g, w) in enumerate(zip(tg, jg)):
        _close(g, w, f"d input {i}", atol=GRAD_ATOL, rtol=0)
