"""``cfg.remat`` on the port: each scan group checkpointed under grad
(``torch.utils.checkpoint``, non-reentrant), policy ``nothing`` (the
group's input alone is kept) or ``dots`` (the outputs of its unbatched
matrix products too), as JAX's ``jax.checkpoint`` of its scan body with
``nothing_saveable`` or ``dots_with_no_batch_dims_saveable``.

On the reduced yi-6b (2 groups of one attention layer) and jamba (one
group of 7 Mamba layers and an attention layer, MoE on the odd
positions), fp32 on the CPU:

- a CARLS step with remat is bit-identical to the same step without
  (metrics, parameters, moments, bank): the recompute runs the same
  fp32 operations on the same inputs, and the backward the same graph;
- it matches JAX's step with the same remat at the trainer tests'
  bounds (tests/_torch_train_parity.py);
- the forward runs twice a group (once, and once more in the backward),
  the scan kernel's Function forward twice a Mamba layer and its
  backward once (the sequence kernels' launches a step on the card);
- the bytes that autograd's saved-tensor hooks pack during the forward
  fall: a checkpointed group keeps no activation for the backward.

Outside grad (serving) remat changes nothing: the prefill's cache is
bit-identical with and without it.
"""
import numpy as np
import pytest
import torch

from _torch_train_parity import (bank_leaves, check_against_jax, configs,
                                 jax_params, jax_step, make_batch, port_step)
from repro_torch.kernels import mamba_scan, ops, ref
from repro_torch.models import build_model
from repro_torch.models import model as model_mod
from repro_torch.tree import tree_items

JAMBA = "jamba-1.5-large-398b"
POLICIES = ("nothing", "dots")


def remat_step_case(arch, policy, with_gn=True):
    """One CARLS step of the reduced ``arch`` with remat ``policy``:
    bit-identical to the port's step without remat, and against JAX's
    step with the same remat (its neighbour gradient too with
    ``with_gn``; else the bank's lazy cache holds it summed by row)."""
    jcfg, tcfg = configs(arch)
    batch = make_batch(jcfg)
    leaves = bank_leaves(jcfg.carls.kb_entries, jcfg.d_model)
    p0 = jax_params(jcfg)
    jr, tr = configs(arch, remat=True, remat_policy=policy)
    got = port_step(tr, p0, batch, leaves)
    _equal_steps(got, port_step(tcfg, p0, batch, leaves))
    check_against_jax(got, jax_step(jr, batch, leaves, with_gn=with_gn))


def _equal_steps(a, b):
    for k, v in a["met"].items():
        assert torch.equal(v, b["met"][k]), k
    for x, y in ((a["p"], b["p"]), (a["st"].mu, b["st"].mu),
                 (a["st"].nu, b["st"].nu)):
        for (k, u), (_, w) in zip(tree_items(x), tree_items(y)):
            assert torch.equal(u, w), k
    for f, u in a["kb"]._asdict().items():
        assert torch.equal(u, getattr(b["kb"], f)), f
    assert torch.equal(a["gn"], b["gn"])


@pytest.mark.parametrize("policy", POLICIES)
def test_remat_step_is_bit_identical_and_matches_jax(policy):
    """The reduced yi-6b; jamba's: tests/test_torch_remat_jamba.py."""
    remat_step_case("yi-6b", policy)


def _forward_counts(tcfg, monkeypatch):
    """Calls of the group body and the scan Function's forward and
    backward over one forward and backward of ``tcfg``'s loss, the
    scan's launches replaced by its plain versions (as on the card, the
    Function runs), and the bytes the saved-tensor hooks packed."""
    calls = {"group": 0, "scan": 0, "scan_bwd": 0}
    group = model_mod.LM._group

    def counted_group(self, *a, **kw):
        calls["group"] += 1
        return group(self, *a, **kw)

    def scan_fwd(delta, bm, cm, x, A, prof, checkpoints=False):
        calls["scan"] += 1
        return (*ref.mamba_scan_ref(delta, bm, cm, x, A), None)

    def scan_bwd(delta, bm, cm, x, A, ckpt, dy, dh):
        calls["scan_bwd"] += 1
        return ref.mamba_scan_bwd_ref(delta, bm, cm, x, A, dy, dh)

    monkeypatch.setattr(model_mod.LM, "_group", counted_group)
    monkeypatch.setattr(mamba_scan, "require_cuda", lambda *a: None)
    monkeypatch.setattr(mamba_scan, "_launch", scan_fwd)
    monkeypatch.setattr(mamba_scan, "mamba_scan_bwd_cuda", scan_bwd)
    monkeypatch.setattr(ops, "mamba_scan", mamba_scan.mamba_scan_cuda)
    model = build_model(tcfg)
    params = model.init(torch.Generator().manual_seed(0))
    leaves = [p.requires_grad_() for _, p in tree_items(params)]
    toks = torch.from_numpy(np.random.default_rng(0).integers(
        0, tcfg.vocab_size, (2, 16)))
    packed = [0]

    def pack(t):
        packed[0] += t.numel() * t.element_size()
        return t

    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        h, _, aux, _ = model.hidden(params, toks)
        loss = (h ** 2).mean() + aux
    torch.autograd.grad(loss, leaves, allow_unused=True)
    monkeypatch.undo()
    return calls, packed[0]


def test_remat_recomputes_each_group_once_and_keeps_less(monkeypatch):
    _, base = configs(JAMBA)
    groups, mamba = base.num_groups(), 7          # one group: 7 Mamba
    counts = {}
    for remat, policy in ((False, "nothing"), (True, "nothing"),
                          (True, "dots")):
        cfg = base.replace(remat=remat, remat_policy=policy)
        counts[(remat, policy)] = _forward_counts(cfg, monkeypatch)
    calls, kept = counts[(False, "nothing")]
    assert calls == {"group": groups, "scan": mamba, "scan_bwd": mamba}
    for policy in POLICIES:
        calls_r, kept_r = counts[(True, policy)]
        assert calls_r == {"group": 2 * groups, "scan": 2 * mamba,
                           "scan_bwd": mamba}, policy
        assert kept_r < kept / 2, (policy, kept_r, kept)


def test_remat_changes_nothing_outside_grad():
    _, base = configs("yi-6b")
    toks = torch.from_numpy(np.random.default_rng(3).integers(
        0, base.vocab_size, (2, 12)))
    caches = []
    for remat in (False, True):
        model = build_model(base.replace(remat=remat))
        params = model.init(torch.Generator().manual_seed(0))
        with torch.inference_mode():
            cache, h = model.prefill(params, toks)
            logits, cache = model.decode_step(params, cache, toks[:, :1])
        caches.append((cache, h, logits))
    (c0, h0, l0), (c1, h1, l1) = caches
    assert torch.equal(h0, h1) and torch.equal(l0, l1)
    for (k, a), (_, b) in zip(tree_items(c0["groups"]),
                              tree_items(c1["groups"])):
        assert torch.equal(a, b), k
