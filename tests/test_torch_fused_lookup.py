"""The fused lookups' version bump and the sequence kernels' grad refusal,
on the CPU.

The plain versions of the two fused lookups (repro_torch.kernels.ref),
which the CUDA kernels are held to on the card, take the version bump
that the JAX engine makes beside its lookup kernel
(repro/core/kb_engine.py:219-224, 470-474). Here they are held against
the JAX engine's lookup on the same numpy bank, for fp32 and int8 rows:
the kernel backend ("pallas", its kernels in interpret mode) and the
dense one. CudaBackend's lookups, which now hand the bump to the kernel,
must leave the state that the eager bump left. And the flash, WKV and
scan wrappers, whose kernels have no backward yet, must refuse to run
where autograd would record them (the device check set aside, as in
tests/test_torch_kernels.py).

Tolerances (tests/test_kb_engine.py's): versions, counts and int8 codes
exact; returned rows atol 1e-5; fp32 leaves atol 1e-6; int8 scale and
offset rtol 1e-6 / atol 1e-6 (tests/test_kb_quantized.py:61-62).
"""
import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import KBEngine as JaxEngine
from repro.core import knowledge_bank as jkb
from repro_torch import env
from repro_torch.core import knowledge_bank as tkb
from repro_torch.core.kb_engine import CudaBackend
from repro_torch.kernels import kb_fused_lookup as lookup_mod
from repro_torch.kernels import kb_fused_lookup_q as lookup_q_mod
from repro_torch.kernels import ops, ref

N, D = 257, 32
LAZY_LR, ZMAX = 0.2, 2.0


def bank_leaves(seed, int8):
    """Numpy leaves of a bank (KBState's fields, plus scale and offset for
    int8 rows) with two fifths of its rows holding pending gradients, some
    past the outlier clip, and versions already apart from zero."""
    rng = np.random.default_rng(seed)
    rows = rng.standard_normal((N, D)).astype(np.float32)
    rows[1] = 3.25                        # a constant row: scale 1
    pending = rng.random(N) < 0.4
    cnt = np.where(pending, rng.integers(1, 4, N), 0).astype(np.float32)
    gsum = (0.1 * rng.standard_normal((N, D)) * cnt[:, None]).astype(
        np.float32)
    gsq = ((gsum.astype(np.float64) ** 2).sum(1) / np.maximum(cnt, 1)
           * rng.uniform(0.02, 2.0, N)).astype(np.float32)
    out = {"table": rows, "version": rng.integers(0, 5, N).astype(np.int32),
           "grad_sum": gsum, "grad_cnt": cnt, "grad_sqnorm": gsq,
           "norm_ema": np.zeros(N, np.float32),
           "step": np.zeros((), np.int32)}
    if int8:
        codes, s, o = map(np.asarray, jkb.quantize_rows(jnp.asarray(rows)))
        out.update(table=codes, scale=s, offset=o)
    return out


def batch(case, leaves):
    """The ids of a case: ``pending`` mixes rows with and without pending
    gradients and repeats some; ``across_blocks`` is 40 ids whose
    duplicates sit in other blocks of the kernels' launch (8 slots a
    block at D 32), one of them three times; ``one`` is a single pending
    row."""
    pend = np.flatnonzero(leaves["grad_cnt"] > 0)
    idle = np.flatnonzero(leaves["grad_cnt"] == 0)
    if case == "pending":
        return np.array([pend[0], idle[0], pend[1], pend[0], 1, idle[0],
                         pend[2], 256, 0])
    if case == "across_blocks":
        ids = np.concatenate([pend[:24], idle[:16]])
        assert env.fused_lookup_block(ids.size, D) == 8
        ids[33], ids[17], ids[39] = ids[0], ids[3], ids[0]
        return ids
    return pend[5:6]


def jax_engine(backend, leaves, int8):
    eng = JaxEngine(N, D, backend=backend, lazy_lr=LAZY_LR, zmax=ZMAX,
                    storage="int8" if int8 else "fp32")
    eng.state = jkb.KBState(**{f: jnp.asarray(leaves[f])
                               for f in jkb.KBState._fields})
    if int8:
        eng._qscale = jnp.asarray(leaves["scale"])
        eng._qoffset = jnp.asarray(leaves["offset"])
    return eng


def torch_leaves(leaves, int8):
    names = (("table", "scale", "offset") if int8 else ("table",)) + (
        "grad_sum", "grad_cnt", "grad_sqnorm")
    return [torch.from_numpy(leaves[f].copy()) for f in names], \
        torch.from_numpy(leaves["version"].copy())


@pytest.mark.parametrize("int8", [False, True], ids=["fp32", "int8"])
@pytest.mark.parametrize("case", ["pending", "across_blocks", "one"])
@pytest.mark.parametrize("backend", ["pallas", "dense"])
def test_plain_lookups_with_version_match_the_jax_engine(backend, case,
                                                          int8):
    leaves = bank_leaves(7, int8)
    ids = batch(case, leaves)
    eng = jax_engine(backend, leaves, int8)
    want_vals = eng.lookup(ids)
    got, version = torch_leaves(leaves, int8)
    plain = ref.kb_fused_lookup_q_ref if int8 else ref.kb_fused_lookup_ref
    vals = plain(*got, torch.from_numpy(ids), lazy_lr=LAZY_LR, zmax=ZMAX,
                 version=version)
    np.testing.assert_allclose(vals.numpy(), want_vals, atol=1e-5)
    st = eng.state
    np.testing.assert_array_equal(version.numpy(), np.asarray(st.version))
    bumped = version.numpy() - leaves["version"]
    assert bumped.max() == 1 and bumped.sum() == int(
        (leaves["grad_cnt"][np.unique(ids)] > 0).sum())
    if int8:
        codes, scale, offset = got[:3]
        np.testing.assert_array_equal(codes.numpy(), np.asarray(st.table))
        for g, w in ((scale, eng._qscale), (offset, eng._qoffset)):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6,
                                       atol=1e-6)
    else:
        np.testing.assert_allclose(got[0].numpy(), np.asarray(st.table),
                                   atol=1e-6)
    gsum, cnt, gsq = got[-3:]
    np.testing.assert_allclose(gsum.numpy(), np.asarray(st.grad_sum),
                               atol=1e-6)
    np.testing.assert_array_equal(cnt.numpy(), np.asarray(st.grad_cnt))
    np.testing.assert_allclose(gsq.numpy(), np.asarray(st.grad_sqnorm),
                               atol=1e-6)


def _eager_bump_lookup(int8, state, ids, qs=None, qo=None):
    """CudaBackend's lookups as they stood before the kernels took the
    version bump: the eager bump, then the plain version without it."""
    flat = ids.reshape(-1).long()
    rows = flat[(flat >= 0) & (flat < state.table.shape[0])]
    state.version[rows] = (state.version[rows]
                           + (state.grad_cnt[rows] > 0).to(torch.int32))
    if int8:
        return ref.kb_fused_lookup_q_ref(
            state.table, qs, qo, state.grad_sum, state.grad_cnt,
            state.grad_sqnorm, flat, lazy_lr=LAZY_LR, zmax=ZMAX)
    return ref.kb_fused_lookup_ref(state.table, state.grad_sum,
                                   state.grad_cnt, state.grad_sqnorm, flat,
                                   lazy_lr=LAZY_LR, zmax=ZMAX)


@pytest.mark.parametrize("int8", [False, True], ids=["fp32", "int8"])
def test_cuda_backend_lookup_on_the_cpu_leaves_the_state_it_left(int8):
    """Every leaf bit for bit, over two lookups (the second finds the
    first's rows without pending gradients)."""
    leaves = bank_leaves(3, int8)
    ids = torch.from_numpy(batch("across_blocks", leaves)).reshape(5, 8)
    states = []
    for _ in range(2):
        st = tkb.KBState(**{f: torch.from_numpy(np.array(leaves[f]))
                            for f in tkb.KBState._fields})
        qs, qo = (torch.from_numpy(leaves["scale"].copy()),
                  torch.from_numpy(leaves["offset"].copy())) if int8 \
            else (None, None)
        states.append((st, qs, qo))
    (new, nqs, nqo), (old, oqs, oqo) = states
    bk = CudaBackend()
    for _ in range(2):
        if int8:
            vals, new = bk.lookup_q(new, nqs, nqo, ids, lazy_lr=LAZY_LR,
                                    zmax=ZMAX)
        else:
            vals, new = bk.lookup(new, ids, lazy_lr=LAZY_LR, zmax=ZMAX)
        want = _eager_bump_lookup(int8, old, ids, oqs, oqo)
        assert vals.shape == (5, 8, D)
        assert torch.equal(vals.reshape(-1, D), want)
        for f in tkb.KBState._fields:
            assert torch.equal(getattr(new, f), getattr(old, f)), f
        if int8:
            assert torch.equal(nqs, oqs) and torch.equal(nqo, oqo)
    assert int((new.version - torch.from_numpy(leaves["version"])).sum()) \
        > 0


@pytest.mark.parametrize("int8", [False, True], ids=["fp32", "int8"])
def test_fused_lookup_launchers_take_a_matching_version(int8, monkeypatch):
    """The launcher passes the version's pointer (null without one) and
    whether the block stages the ids, counts its one launch, and refuses
    a version of another dtype or length before it launches. The device
    checks and the launch are stood in for so that CPU tensors reach
    them."""
    mod = lookup_q_mod if int8 else lookup_mod

    def require_dtype(t, what, dtype, ndim):    # require_cuda less device
        if t.dtype != dtype or t.dim() != ndim:
            raise ValueError(f"{what} must be a {ndim}-d {dtype} tensor")
    for m in (lookup_mod, mod):
        monkeypatch.setattr(m, "require_cuda", require_dtype)
    monkeypatch.setattr(lookup_mod, "require_bank", lambda *a: None)
    calls = []
    monkeypatch.setattr(mod, "launch", lambda *a: calls.append(a))
    got, version = torch_leaves(bank_leaves(1, int8), int8)
    ids = torch.arange(40)
    name = "kb_fused_lookup_q" if int8 else "kb_fused_lookup"
    fn = ops.LAUNCHERS[name]
    before = ops.launch_counts()
    fn(*got, ids, lazy_lr=LAZY_LR, zmax=ZMAX, version=version)
    fn(*got, ids, lazy_lr=LAZY_LR, zmax=ZMAX)
    n_ptrs = 8 if int8 else 6
    assert [c[4 + n_ptrs - 2] for c in calls] == [version.data_ptr(), None]
    # rows per block, then the staging flag: 40 ids beside 8 warps' two
    # 32-wide tiles fit 227 KB
    assert [c[4 + n_ptrs + 5:4 + n_ptrs + 7] for c in calls] == [(8, 1)] * 2
    assert ops.launch_counts()[name] == before[name] + 2
    for bad in (version.long(), version[:-1]):
        with pytest.raises(ValueError, match="version"):
            fn(*got, ids, lazy_lr=LAZY_LR, zmax=ZMAX, version=bad)
    assert len(calls) == 2


def test_lookup_blocks_stage_the_ids_where_they_fit():
    """Two (D,) fp32 tiles a warp; the ids staged only beside them."""
    assert env.fused_lookup_block(32, 128) == 8
    assert env.stage_lookup_ids(32, 128, 8)
    assert env.stage_lookup_ids(1024, 128, 8)
    assert env.stage_lookup_ids(28_000, 128, 8)
    assert not env.stage_lookup_ids(30_000, 128, 8)
    assert env.stage_lookup_ids(100, 16384, 1)
    assert not env.stage_lookup_ids(13_000, 16384, 1)


# ---------------------------------------------------------------------------
# the sequence kernels under autograd run their Function, whose backward is
# a kernel
# ---------------------------------------------------------------------------

def _sequence_inputs(kernel):
    g = torch.Generator().manual_seed(0)
    if kernel == "flash_attention":
        return [torch.randn((1, 8, 2, 32), generator=g) for _ in range(3)]
    if kernel == "rwkv_wkv":
        r, k, v = (torch.randn((1, 4, 2, 32), generator=g) for _ in range(3))
        w = torch.rand((1, 4, 2, 32), generator=g)
        return [r, k, v, w, torch.randn((2, 32), generator=g)]
    delta = torch.rand((1, 4, 16), generator=g)
    bm, cm = (torch.randn((1, 4, 16), generator=g) for _ in range(2))
    x = torch.randn((1, 4, 16), generator=g)
    return [delta, bm, cm, x, -torch.rand((16, 16), generator=g)]


@pytest.mark.parametrize("kernel", ["flash_attention", "rwkv_wkv",
                                    "mamba_scan"])
@pytest.mark.parametrize("mode", ["grad", "no_grad", "inference_mode",
                                  "no_input_requires_grad"])
def test_sequence_kernels_refuse_what_autograd_would_record(kernel, mode,
                                                            monkeypatch):
    """With an input that requires grad and grad mode on, the launcher
    runs its autograd Function: the output carries the Function's
    ``grad_fn``, the forward launches once, and ``.backward()`` launches
    the backward launcher once (where it once raised, the kernel having no
    backward). Under ``no_grad`` or ``inference_mode`` (the serve paths),
    or with no input that requires grad, it launches the forward once and
    records nothing."""
    mod = importlib.import_module(f"repro_torch.kernels.{kernel}")
    monkeypatch.setattr(mod, "require_cuda", lambda *a: None)
    calls = []
    monkeypatch.setattr(mod, "launch", lambda *a: calls.append(a))
    args = _sequence_inputs(kernel)
    if mode != "no_input_requires_grad":
        args[0].requires_grad_(True)
    before = ops.launch_counts()
    bwd = f"{kernel}_bwd"
    if mode == "grad":
        out = ops.LAUNCHERS[kernel](*args)
        out = out[0] if isinstance(out, tuple) else out
        fn = {"flash_attention": "FlashAttentionFn", "rwkv_wkv": "RwkvWkvFn",
              "mamba_scan": "MambaScanFn"}[kernel]
        assert out.grad_fn._forward_cls is getattr(mod, fn)
        assert [c[0] for c in calls] == [kernel]
        assert ops.launch_counts()[kernel] == before[kernel] + 1
        assert ops.launch_counts()[bwd] == before[bwd]
        out.sum().backward()
        assert [c[0] for c in calls] == [kernel, bwd]
        assert ops.launch_counts()[bwd] == before[bwd] + 1
        assert args[0].grad is not None
        assert args[0].grad.shape == args[0].shape
        return
    ctx = {"no_grad": torch.no_grad, "inference_mode": torch.inference_mode,
           "no_input_requires_grad": torch.enable_grad}[mode]
    with ctx():
        out = ops.LAUNCHERS[kernel](*args)
    out = out[0] if isinstance(out, tuple) else out
    assert out.grad_fn is None
    assert len(calls) == 1 and ops.launch_counts()[kernel] == \
        before[kernel] + 1
