"""The port's four kernel modules, on the CPU: each plain version
(repro_torch.kernels.ref) held against the Pallas kernel it replaces, run
in interpret mode as tests/test_kernels.py runs it, on the same numpy
inputs; the wrappers' dispatch (plain version only for CPU tensors); the
build's refusal to fall back. tests/test_torch_cuda_kernels.py holds each
CUDA kernel against its plain version on a card.

Tolerances: ids, versions and counts exact; rows and state leaves atol
1e-6; lookup values and nn scores atol 1e-5 (tests/test_kb_engine.py).
"""
import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import knowledge_bank as jkb
from repro.kernels.kb_fused_lookup import kb_fused_lookup_pallas
from repro.kernels.kb_gather import kb_gather_pallas
from repro.kernels.lazy_apply import lazy_apply_pallas
from repro.kernels.nn_search import nn_search_pallas
from repro.kernels.nn_search import overfetch_exclude_topk as jax_overfetch
from repro_torch import env
from repro_torch.kernels import _build, ops, ref
from repro_torch.kernels import mamba_scan as mamba_scan_mod
from repro_torch.kernels.mamba_scan import mamba_scan_cycles
from repro_torch.kernels.nn_search import KMAX, tile_plan
from repro_torch.kernels.rwkv_wkv import rwkv_wkv_cycles

LAZY_LR, ZMAX = 0.2, 2.0


def bank(rng, n, d, pending_share=0.4, grad_scale=0.1):
    """(table, grad_sum, grad_cnt, grad_sqnorm) as numpy: a share of rows
    with pending gradients, some of them past the outlier clip."""
    pending = rng.random(n) < pending_share
    cnt = np.where(pending, rng.integers(1, 4, n), 0).astype(np.float32)
    gsum = (grad_scale * rng.standard_normal((n, d))
            * cnt[:, None]).astype(np.float32)
    gsq = ((gsum.astype(np.float64) ** 2).sum(1) / np.maximum(cnt, 1)
           * rng.uniform(0.02, 2.0, n)).astype(np.float32)
    return (rng.standard_normal((n, d)).astype(np.float32), gsum, cnt, gsq)


def torch_copy(arrays):
    return [torch.from_numpy(a.copy()) for a in arrays]


# ---------------------------------------------------------------------------
# kb_fused_lookup
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n,d,b", [(300, 16, 1), (300, 16, 7), (257, 32, 32),
                                   (64, 8, 40)])
def test_fused_lookup_plain_matches_pallas(n, d, b):
    """N not a multiple of any block; duplicates and -1 padding ids."""
    rng = np.random.default_rng(n + b)
    leaves = bank(rng, n, d)
    ids = rng.integers(0, n, b)
    ids[b // 2:] = ids[:b - b // 2]
    ids[-1] = -1
    want = kb_fused_lookup_pallas(*map(jnp.asarray, leaves),
                                  jnp.asarray(ids, jnp.int32),
                                  lazy_lr=LAZY_LR, zmax=ZMAX, interpret=True)
    got_leaves = torch_copy(leaves)
    vals = ref.kb_fused_lookup_ref(*got_leaves, torch.from_numpy(ids),
                                   lazy_lr=LAZY_LR, zmax=ZMAX)
    np.testing.assert_allclose(vals.numpy(), np.asarray(want[0]), atol=1e-5)
    assert not vals.numpy()[ids < 0].any()
    for name, g, w in zip(("table", "grad_sum", "grad_cnt", "grad_sqnorm"),
                          got_leaves, want[1:]):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-6,
                                   err_msg=name)
    # every occurrence of a duplicate reads the same updated row
    for i in np.unique(ids[ids >= 0]):
        rows = vals.numpy()[ids == i]
        assert (rows == rows[0]).all()


def test_fused_lookup_plain_equals_kb_lookup_without_version():
    rng = np.random.default_rng(1)
    leaves = bank(rng, 128, 16)
    ids = np.array([5, 9, 5, 127, 0, 9])
    st = jkb.KBState(*map(jnp.asarray, leaves[:1]),
                     version=jnp.zeros(128, jnp.int32),
                     grad_sum=jnp.asarray(leaves[1]),
                     grad_cnt=jnp.asarray(leaves[2]),
                     grad_sqnorm=jnp.asarray(leaves[3]),
                     norm_ema=jnp.zeros(128), step=jnp.int32(0))
    want_vals, want = jkb.kb_lookup(st, jnp.asarray(ids), lazy_lr=LAZY_LR,
                                    zmax=ZMAX)
    got = torch_copy(leaves)
    vals = ref.kb_fused_lookup_ref(*got, torch.from_numpy(ids),
                                   lazy_lr=LAZY_LR, zmax=ZMAX)
    np.testing.assert_allclose(vals.numpy(), np.asarray(want_vals),
                               atol=1e-5)
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want.table),
                               atol=1e-6)


# ---------------------------------------------------------------------------
# kb_gather
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n,d,b", [(300, 16, 5), (509, 32, 64), (10, 4, 3)])
def test_gather_plain_matches_pallas(n, d, b):
    rng = np.random.default_rng(n)
    table = rng.standard_normal((n, d)).astype(np.float32)
    ids = rng.integers(-1, n, b)
    ids[0] = -1
    want = kb_gather_pallas(jnp.asarray(table), jnp.asarray(ids, jnp.int32),
                            interpret=True)
    got = ref.kb_gather_ref(torch.from_numpy(table), torch.from_numpy(ids))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6)
    assert not got.numpy()[ids < 0].any()


# ---------------------------------------------------------------------------
# lazy_apply
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n,d", [(300, 16), (500, 32)])
def test_lazy_apply_plain_matches_pallas(n, d):
    rng = np.random.default_rng(d)
    leaves = bank(rng, n, d)
    want = lazy_apply_pallas(*map(jnp.asarray, leaves), lazy_lr=LAZY_LR,
                             zmax=ZMAX, interpret=True)
    got = torch_copy(leaves)
    ref.lazy_apply_ref(*got, lazy_lr=LAZY_LR, zmax=ZMAX)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-6)
    assert not any(t.any() for t in got[1:])


def test_lazy_apply_tiny_norm_boundary():
    """The kernel's norm is sqrt(max(sum(avg^2), 1e-24)); pending_delta's is
    max(sqrt(sum(avg^2)), 1e-12). Rows whose sum of squares straddles 1e-24,
    with a zmax below 1 so that the floor decides the clip, and zero table
    rows so that the tiny deltas are the whole result: the plain version,
    the Pallas kernel and kb_flush agree to the last bits that matter."""
    rng = np.random.default_rng(9)
    n, d = 96, 16
    mags = np.repeat([1e-15, 1e-13, 2.5e-13, 1e-12, 4e-12, 1e-9], 16)
    gsum = (rng.standard_normal((n, d)) * mags[:, None]).astype(np.float32)
    cnt = np.ones(n, np.float32)
    gsq = np.full(n, 1e-30, np.float32)            # rms under the floor
    table = np.zeros((n, d), np.float32)
    kw = dict(lazy_lr=1.0, zmax=0.5)
    want = lazy_apply_pallas(*map(jnp.asarray, (table, gsum, cnt, gsq)),
                             interpret=True, **kw)
    got = torch_copy((table, gsum, cnt, gsq))
    ref.lazy_apply_ref(*got, **kw)
    flushed = jkb.kb_flush(jkb.KBState(
        jnp.asarray(table), jnp.zeros(n, jnp.int32), jnp.asarray(gsum),
        jnp.asarray(cnt), jnp.asarray(gsq), jnp.zeros(n), jnp.int32(0)),
        **kw)
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]),
                               rtol=1e-6, atol=0)
    np.testing.assert_allclose(got[0].numpy(), np.asarray(flushed.table),
                               rtol=1e-6, atol=0)
    assert np.abs(got[0].numpy()).max() > 0       # the deltas did apply


# ---------------------------------------------------------------------------
# nn_search
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("b,n,d,k", [(7, 100, 16, 4), (3, 509, 32, 8),
                                     (16, 300, 8, 1)])
def test_nn_search_plain_matches_pallas(b, n, d, k):
    rng = np.random.default_rng(b * n)
    q = rng.standard_normal((b, d)).astype(np.float32)
    bank_ = rng.standard_normal((n, d)).astype(np.float32)
    ws, wi = nn_search_pallas(jnp.asarray(q), jnp.asarray(bank_), k,
                              interpret=True)
    gs, gi = ref.nn_search_ref(torch.from_numpy(q), torch.from_numpy(bank_),
                               k + 1)
    np.testing.assert_allclose(gs[:, :k].numpy(), np.asarray(ws), atol=1e-5)
    decided = (gs[:, k - 1] - gs[:, k]).numpy() > 1e-4
    np.testing.assert_array_equal(gi[decided, :k].numpy(),
                                  np.asarray(wi)[decided])


def test_nn_search_ties_go_to_the_lowest_id():
    """Exact ties (repeated bank rows, a zero query) resolve to the lowest
    id, as _merge_topk does."""
    rng = np.random.default_rng(4)
    base = rng.standard_normal((10, 16)).astype(np.float32)
    bank_ = np.concatenate([base, base, base[:5]])      # rows repeat
    q = np.concatenate([rng.standard_normal((3, 16)),
                        np.zeros((1, 16))]).astype(np.float32)
    ws, wi = nn_search_pallas(jnp.asarray(q), jnp.asarray(bank_), 6,
                              interpret=True)
    gs, gi = ref.nn_search_ref(torch.from_numpy(q), torch.from_numpy(bank_),
                               6)
    np.testing.assert_array_equal(gi.numpy(), np.asarray(wi))
    np.testing.assert_allclose(gs.numpy(), np.asarray(ws), atol=1e-5)
    np.testing.assert_array_equal(gi[3].numpy(), np.arange(6))


def test_overfetch_exclude_matches_jax():
    rng = np.random.default_rng(8)
    q = rng.standard_normal((6, 16)).astype(np.float32)
    bank_ = rng.standard_normal((200, 16)).astype(np.float32)
    full = np.argsort(-(q @ bank_.T), 1, kind="stable")
    excl = np.stack([full[:, 0], full[:, 3], np.full(6, -1)], 1)
    ws, wi = jax_overfetch(
        lambda kk: nn_search_pallas(jnp.asarray(q), jnp.asarray(bank_), kk,
                                    interpret=True),
        200, 5, jnp.asarray(excl, jnp.int32))
    gs, gi = ops.overfetch_exclude_topk(
        lambda kk: ref.nn_search_ref(torch.from_numpy(q),
                                     torch.from_numpy(bank_), kk),
        200, 5, torch.from_numpy(excl))
    np.testing.assert_array_equal(gi.numpy(), np.asarray(wi))
    np.testing.assert_allclose(gs.numpy(), np.asarray(ws), atol=1e-5)
    for row, banned in zip(gi.numpy(), excl):
        assert not np.isin(row, banned[banned >= 0]).any()


# ---------------------------------------------------------------------------
# wrappers, build, block sizes
# ---------------------------------------------------------------------------

def test_wrappers_take_the_plain_version_only_on_the_cpu():
    """CPU tensors run the plain version and launch nothing; a tensor on
    any other device goes to the kernel's launcher, which refuses it."""
    ops.reset_launch_counts()
    rng = np.random.default_rng(0)
    leaves = torch_copy(bank(rng, 64, 8))
    ids = torch.tensor([1, 2, 2])
    q = torch.from_numpy(rng.standard_normal((2, 8)).astype(np.float32))
    ops.kb_fused_lookup(*leaves, ids, lazy_lr=0.1, zmax=3.0)
    ops.kb_gather(leaves[0], ids)
    ops.nn_search(q, leaves[0], 3)
    ops.lazy_apply(*leaves, lazy_lr=0.1, zmax=3.0)
    assert ops.launch_counts() == dict.fromkeys(ops.LAUNCHERS, 0)
    meta = [t.to("meta") for t in leaves]
    with pytest.raises(ValueError, match="CUDA"):
        ops.kb_fused_lookup(*meta, ids.to("meta"), lazy_lr=0.1, zmax=3.0)
    with pytest.raises(ValueError, match="CUDA"):
        ops.kb_gather(meta[0], ids.to("meta"))
    with pytest.raises(ValueError, match="CUDA"):
        ops.lazy_apply(*meta, lazy_lr=0.1, zmax=3.0)
    with pytest.raises(ValueError, match="CUDA"):
        ops.nn_search(q.to("meta"), meta[0], 3)
    assert ops.launch_counts() == dict.fromkeys(ops.LAUNCHERS, 0)


def _wkv_tensors(B, S, H, d, dtype=torch.float32, device="cpu"):
    rng = np.random.default_rng(B + S + H + d)
    r, k, v = (torch.from_numpy(0.5 * rng.standard_normal(
        (B, S, H, d)).astype(np.float32)).to(dtype) for _ in range(3))
    w = torch.from_numpy(rng.uniform(0.5, 1.0, (B, S, H, d)).astype(
        np.float32))
    u = torch.from_numpy(0.1 * rng.standard_normal((H, d)).astype(
        np.float32))
    return [t.to(device) for t in (r, k, v, w, u)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_rwkv_wkv_wrapper_takes_the_plain_version_only_on_the_cpu(dtype):
    """CPU tensors run the plain version (every d, none of them launched);
    a tensor on any other device goes to the kernel's launcher, which
    refuses it before it builds anything."""
    ops.reset_launch_counts()
    for d in (16, 64, 128):
        args = _wkv_tensors(2, 7, 3, d, dtype)
        y, s_fin = ops.rwkv_wkv(*args)
        want_y, want_s = ref.rwkv_wkv_ref(*args)
        assert torch.equal(y, want_y) and torch.equal(s_fin, want_s)
    assert ops.launch_counts() == dict.fromkeys(ops.LAUNCHERS, 0)
    meta = _wkv_tensors(2, 7, 3, 64, dtype, device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        ops.rwkv_wkv(*meta)
    with pytest.raises(ValueError, match="CUDA"):
        ops.LAUNCHERS["rwkv_wkv"](*meta)
    assert ops.launch_counts() == dict.fromkeys(ops.LAUNCHERS, 0)


@pytest.mark.parametrize("d", [8, 48, 128])
def test_rwkv_wkv_kernel_refuses_head_dims_it_cannot_take(d):
    meta = _wkv_tensors(1, 4, 2, d, device="meta")
    with pytest.raises(ValueError, match="head dim"):
        ops.rwkv_wkv(*meta)


def test_rwkv_wkv_kernel_refuses_other_dtypes_and_shapes():
    r, k, v, w, u = _wkv_tensors(1, 4, 2, 32, device="meta")
    with pytest.raises(ValueError, match="fp32 or bf16"):
        ops.rwkv_wkv(r.half(), k.half(), v.half(), w, u)
    with pytest.raises(ValueError, match="shape"):
        ops.rwkv_wkv(r, k, v[:, :3], w, u)
    with pytest.raises(ValueError, match=r"\(H, d\)"):
        ops.rwkv_wkv(r, k, v, w, u[:1])
    assert ops.launch_counts()["rwkv_wkv"] == 0


def _scan_tensors(B, S, di, ds, x_dtype=torch.float32, device="cpu"):
    rng = np.random.default_rng(B + S + di + ds)
    delta = torch.from_numpy(rng.uniform(0.001, 1.0, (B, S, di)).astype(
        np.float32))
    bm, cm = (torch.from_numpy(0.5 * rng.standard_normal(
        (B, S, ds)).astype(np.float32)) for _ in range(2))
    x = torch.from_numpy(0.5 * rng.standard_normal((B, S, di)).astype(
        np.float32)).to(x_dtype)
    A = -torch.from_numpy(np.exp(0.3 * rng.standard_normal(
        (di, ds))).astype(np.float32))
    return [t.to(device) for t in (delta, bm, cm, x, A)]


@pytest.mark.parametrize("x_dtype", [torch.float32, torch.bfloat16])
def test_mamba_scan_wrapper_takes_the_plain_version_only_on_the_cpu(
        x_dtype):
    """CPU tensors run the plain version (every ds, none of them
    launched); a tensor on any other device goes to the kernel's launcher,
    which refuses it before it builds anything."""
    ops.reset_launch_counts()
    for ds in (3, 16, 64):
        args = _scan_tensors(2, 7, 5, ds, x_dtype)
        y, h_fin = ops.mamba_scan(*args)
        want_y, want_h = ref.mamba_scan_ref(*args)
        assert torch.equal(y, want_y) and torch.equal(h_fin, want_h)
        assert y.shape == (2, 7, 5) and h_fin.shape == (2, 5, ds)
    assert ops.launch_counts() == dict.fromkeys(ops.LAUNCHERS, 0)
    meta = _scan_tensors(2, 7, 5, 16, x_dtype, device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        ops.mamba_scan(*meta)
    with pytest.raises(ValueError, match="CUDA"):
        ops.LAUNCHERS["mamba_scan"](*meta)
    assert ops.launch_counts() == dict.fromkeys(ops.LAUNCHERS, 0)


@pytest.mark.parametrize("ds", [2, 12, 64])
def test_mamba_scan_kernel_refuses_state_dims_it_cannot_take(ds):
    meta = _scan_tensors(1, 4, 8, ds, device="meta")
    with pytest.raises(ValueError, match="state dim"):
        ops.mamba_scan(*meta)


def test_mamba_scan_kernel_refuses_other_dtypes_and_shapes():
    delta, bm, cm, x, A = _scan_tensors(1, 4, 8, 16, device="meta")
    with pytest.raises(ValueError, match="fp32 or bf16"):
        ops.mamba_scan(delta, bm, cm, x.half(), A)
    with pytest.raises(ValueError, match="delta's shape"):
        ops.mamba_scan(delta, bm, cm, x[:, :3], A)
    with pytest.raises(ValueError, match=r"\(B, S, ds\)"):
        ops.mamba_scan(delta, bm[:, :3], cm, x, A)
    with pytest.raises(ValueError, match=r"\(di, ds\)"):
        ops.mamba_scan(delta, bm, cm, x, A[:3])
    assert ops.launch_counts()["mamba_scan"] == 0


def _off_boundary(t):
    """``t``'s values in a tensor that starts one element past a 16-byte
    boundary."""
    flat = torch.zeros(t.numel() + 16 // t.element_size(), dtype=t.dtype)
    out = flat[1:1 + t.numel()].view(t.shape)
    out.copy_(t)
    assert out.data_ptr() % 16
    return out


@pytest.mark.parametrize("kernel, name", [
    ("rwkv_wkv", "r"), ("rwkv_wkv", "k"), ("rwkv_wkv", "v"),
    ("rwkv_wkv", "w"), ("rwkv_wkv", "u"),
    ("mamba_scan", "delta"), ("mamba_scan", "bm"), ("mamba_scan", "cm"),
    ("mamba_scan", "x")])
def test_recurrence_launchers_refuse_inputs_off_a_16_byte_boundary(
        kernel, name, monkeypatch):
    """The WKV and scan kernels read their inputs by TMA (u as float4s),
    which takes 16-byte aligned starts: the launcher names the input that
    is off that boundary and launches nothing. The device check is set
    aside so that CPU tensors reach the alignment check."""
    mod = importlib.import_module(f"repro_torch.kernels.{kernel}")
    monkeypatch.setattr(mod, "require_cuda", lambda *a: None)

    def no_launch(*a):
        raise AssertionError("launched an off-boundary input")
    monkeypatch.setattr(mod, "launch", no_launch)
    if kernel == "rwkv_wkv":
        names = ("r", "k", "v", "w", "u")
        args = _wkv_tensors(1, 4, 2, 32, torch.bfloat16)
    else:
        names = ("delta", "bm", "cm", "x", "A")
        args = _scan_tensors(1, 4, 16, 16, torch.bfloat16)
    i = names.index(name)
    args[i] = _off_boundary(args[i])
    before = ops.launch_counts()[kernel]
    with pytest.raises(ValueError, match=f"^{name} must start on a 16-byte"):
        ops.LAUNCHERS[kernel](*args)
    assert ops.launch_counts()[kernel] == before


@pytest.mark.parametrize("kernel, shape, launched", [
    ("rwkv_wkv", (1, 0, 2, 32), False), ("rwkv_wkv", (0, 4, 2, 32), False),
    ("rwkv_wkv", (1, 4, 2, 32), True),
    ("mamba_scan", (1, 0, 16, 16), False), ("mamba_scan", (1, 4, 0, 16), False),
    ("mamba_scan", (1, 4, 16, 16), True), ("mamba_scan", (1, 4, 37, 8), True)])
def test_recurrence_launchers_count_only_their_launches(kernel, shape,
                                                        launched,
                                                        monkeypatch):
    """A launcher adds one to its count where it launches its kernel and
    nowhere else: a call with no step (S, B or di 0) launches nothing and
    counts nothing, and a scan whose channels are padded counts its one
    launch once. The device check and the launch are stood in for so that
    CPU tensors reach them."""
    mod = importlib.import_module(f"repro_torch.kernels.{kernel}")
    monkeypatch.setattr(mod, "require_cuda", lambda *a: None)
    calls = []
    monkeypatch.setattr(mod, "launch", lambda *a: calls.append(a))
    make = _wkv_tensors if kernel == "rwkv_wkv" else _scan_tensors
    before = ops.launch_counts()
    ops.LAUNCHERS[kernel](*make(*shape, torch.bfloat16))
    assert len(calls) == int(launched)
    assert ops.launch_counts() == {**before,
                                   kernel: before[kernel] + int(launched)}


def _bwd_launcher(kernel, monkeypatch):
    """The backward launcher of ``kernel`` with the device check and the
    launch stood in for, so that CPU tensors reach its shape checks; the
    list the launches' arguments go to."""
    mod = importlib.import_module(f"repro_torch.kernels.{kernel}")
    monkeypatch.setattr(mod, "require_cuda", lambda *a: None)
    calls = []
    monkeypatch.setattr(mod, "launch", lambda *a: calls.append(a))
    return ops.LAUNCHERS[f"{kernel}_bwd"], calls


@pytest.mark.parametrize("B, S, H, d", [(2, 7, 3, 16), (1, 33, 2, 32),
                                        (2, 17, 2, 64)])
def test_wkv_bwd_launcher_checks_and_launches_once(B, S, H, d, monkeypatch):
    """The WKV backward's launcher takes the forward's checkpoints, one
    (d, d) state per chunk of CHUNK steps, and the gradients of y and
    S_fin in their shapes; it refuses any other shape before it launches,
    and a good call launches the kernel once (its cluster of d / 16 blocks
    per (b, h) and du's sum are one launch call) with du's scratch of one
    (H, d) partial per batch, and counts one launch."""
    from repro_torch.kernels.rwkv_wkv import CHUNK
    kern, calls = _bwd_launcher("rwkv_wkv", monkeypatch)
    args = _wkv_tensors(B, S, H, d, torch.bfloat16)
    ckpt = torch.zeros((B, H, -(-S // CHUNK), d, d))
    dy, ds = torch.zeros((B, S, H, d)), torch.zeros((B, H, d, d))
    before = ops.launch_counts()["rwkv_wkv_bwd"]
    with pytest.raises(ValueError, match="ckpt"):
        kern(*args, ckpt[:, :, :1] if S > CHUNK else ckpt[..., :1], dy, ds)
    with pytest.raises(ValueError, match="dy"):
        kern(*args, ckpt, dy[:, :1], ds)
    with pytest.raises(ValueError, match="ds_fin"):
        kern(*args, ckpt, dy, ds[..., :1])
    assert calls == [] and ops.launch_counts()["rwkv_wkv_bwd"] == before
    dr, dk, dv, dw, du = kern(*args, ckpt, dy, ds)
    # (B, S, H, d, bf16, no profile): the main path's launch is unprofiled
    assert len(calls) == 1 and calls[0][-6:] == (B, S, H, d, 1, None)
    assert ops.launch_counts()["rwkv_wkv_bwd"] == before + 1
    assert all(t.shape == (B, S, H, d) for t in (dr, dk, dv, dw))
    assert du.shape == (H, d)


@pytest.mark.parametrize("B, S, di, ds, blocks", [
    (2, 9, 8, 4, 1), (1, 20, 136, 16, 2), (2, 3, 256, 8, 2),
    (1, 5, 72, 32, 3), (1, 5, 64, 32, 2)])
def test_scan_bwd_scratch_is_one_partial_per_block(B, S, di, ds, blocks):
    """The scan backward's scratch: dA per batch, and dB, dC as one
    partial per block of BWD_CHANNELS[ds] channels (128; 32 at ds 32)
    and step, which the second pass adds in a fixed order."""
    da_part, bc_part = mamba_scan_mod.bwd_scratch(B, S, di, ds, "cpu")
    assert -(-di // mamba_scan_mod.BWD_CHANNELS[ds]) == blocks
    assert da_part.shape == (B, di, ds)
    assert bc_part.shape == (B, blocks, S, 2 * ds)
    assert da_part.dtype == bc_part.dtype == torch.float32


@pytest.mark.parametrize("ds", [4, 8, 16, 32])
def test_scan_bwd_launcher_checks_and_launches_once(ds, monkeypatch):
    """The scan backward's launcher takes di padded to a multiple of 8,
    the forward's checkpoints (one (di, ds) state per chunk) and the
    gradients of y and h_fin in their shapes; it refuses any other before
    it launches, and a good call launches once and counts once."""
    from repro_torch.kernels.mamba_scan import CHUNK
    kern, calls = _bwd_launcher("mamba_scan", monkeypatch)
    B, S, di = 2, 19, 40
    args = _scan_tensors(B, S, di, ds, torch.bfloat16)
    ckpt = torch.zeros((B, -(-S // CHUNK), di, ds))
    dy, dh = torch.zeros((B, S, di)), torch.zeros((B, di, ds))
    before = ops.launch_counts()["mamba_scan_bwd"]
    with pytest.raises(ValueError, match="multiple of 8"):
        odd = _scan_tensors(B, S, 37, ds, torch.bfloat16)
        kern(*odd, ckpt[:, :, :37], dy[..., :37], dh[:, :37])
    with pytest.raises(ValueError, match="ckpt"):
        kern(*args, ckpt[:, :1], dy, dh)
    with pytest.raises(ValueError, match="dy"):
        kern(*args, ckpt, dy[:, :1], dh)
    assert calls == [] and ops.launch_counts()["mamba_scan_bwd"] == before
    grads = kern(*args, ckpt, dy, dh)
    assert len(calls) == 1 and calls[0][-6:] == (B, S, di, ds, 1, None)
    assert ops.launch_counts()["mamba_scan_bwd"] == before + 1
    assert [tuple(g.shape) for g in grads] == [
        (B, S, di), (B, S, ds), (B, S, ds), (B, S, di), (di, ds)]


def test_backward_profilers_refuse_cpu_tensors():
    """``rwkv_wkv_bwd_cycles`` and ``mamba_scan_bwd_cycles`` time the
    backward kernels on the card: CPU tensors are refused before any
    launch, and no count moves."""
    from repro_torch.kernels.mamba_scan import mamba_scan_bwd_cycles
    from repro_torch.kernels.rwkv_wkv import CHUNK, rwkv_wkv_bwd_cycles
    ops.reset_launch_counts()
    B, S, H, d = 1, 4, 2, 32
    with pytest.raises(ValueError, match="CUDA"):
        rwkv_wkv_bwd_cycles(*_wkv_tensors(B, S, H, d),
                            torch.zeros((B, H, 1, d, d)),
                            torch.zeros((B, S, H, d)),
                            torch.zeros((B, H, d, d)))
    B, S, di, ds = 1, 4, 16, 16
    with pytest.raises(ValueError, match="CUDA"):
        mamba_scan_bwd_cycles(*_scan_tensors(B, S, di, ds),
                              torch.zeros((B, -(-S // CHUNK), di, ds)),
                              torch.zeros((B, S, di)),
                              torch.zeros((B, di, ds)))
    assert ops.launch_counts() == dict.fromkeys(ops.LAUNCHERS, 0)


def test_recurrence_profilers_refuse_cpu_tensors():
    """``rwkv_wkv_cycles`` and ``mamba_scan_cycles`` time the kernel on the
    card: CPU tensors are refused, never run on the plain version, and no
    count moves."""
    ops.reset_launch_counts()
    with pytest.raises(ValueError, match="CUDA"):
        rwkv_wkv_cycles(*_wkv_tensors(1, 4, 2, 32))
    with pytest.raises(ValueError, match="CUDA"):
        mamba_scan_cycles(*_scan_tensors(1, 4, 16, 16))
    assert ops.launch_counts() == dict.fromkeys(ops.LAUNCHERS, 0)


@pytest.mark.parametrize("di", [1, 5, 8, 37, 200])
def test_mamba_scan_pads_channels_to_the_kernels_multiple(di):
    """The launcher pads di with zero channels up to a multiple of 8 (TMA's
    16-byte rows) and cuts them off again: the padded widths, zeros in the
    added channels, and the plain version on the padded inputs equal to it
    on the originals, with y and h exactly 0 in the added channels."""
    delta, bm, cm, x, A = _scan_tensors(2, 9, di, 8, torch.bfloat16)
    pd, px, pA = mamba_scan_mod.pad_channels(delta, x, A)
    width = -(-di // mamba_scan_mod.DI_MULTIPLE) * mamba_scan_mod.DI_MULTIPLE
    assert pd.shape == px.shape == (2, 9, width) and pA.shape == (width, 8)
    assert px.dtype == x.dtype
    if width == di:
        assert pd is delta and px is x and pA is A
    assert torch.equal(pd[..., :di], delta) and torch.equal(px[..., :di], x)
    assert torch.equal(pA[:di], A)
    assert not pd[..., di:].any() and not px[..., di:].any()
    assert not pA[di:].any()
    y, h = ref.mamba_scan_ref(pd, bm, cm, px, pA)
    want_y, want_h = ref.mamba_scan_ref(delta, bm, cm, x, A)
    assert not y[..., di:].any() and not h[:, di:].any()
    torch.testing.assert_close(y[..., :di], want_y, atol=1e-6, rtol=1e-6)
    torch.testing.assert_close(h[:, :di], want_h, atol=1e-6, rtol=1e-6)


def test_build_raises_without_nvcc(tmp_path, monkeypatch):
    """A missing compiler is an error, never a quiet switch to the plain
    version."""
    monkeypatch.setattr(_build.shutil, "which", lambda name: None)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "no-cuda"))
    monkeypatch.setattr(_build, "BUILD_ROOT", tmp_path / "build")
    with pytest.raises(RuntimeError, match="nvcc"):
        _build.build(["kb_gather"])
    with pytest.raises(ValueError, match="unknown kernel source"):
        _build.build(["no_such_kernel"])


def test_build_dir_follows_the_sources(tmp_path, monkeypatch):
    csrc = tmp_path / "csrc"
    csrc.mkdir()
    for path in _build.CSRC.iterdir():
        (csrc / path.name).write_bytes(path.read_bytes())
    monkeypatch.setattr(_build, "CSRC", csrc)
    before = _build.build_dir()
    assert before == _build.build_dir()
    with open(csrc / "kb_gather.cu", "a") as f:
        f.write("\n// edited\n")
    assert _build.build_dir() != before
    assert before.parent == _build.BUILD_ROOT


def test_block_sizes_fit_shared_memory():
    assert env.fit_block_rows(128) == 128
    assert env.fit_block_rows(128, want=8) == 8
    # 227 KB / (4 arrays x 4096 x 4 B) = 3.5 rows -> 2
    assert env.fit_block_rows(4096, n_arrays=4) == 2
    with pytest.raises(ValueError):
        env.fit_block_rows(128, fixed_bytes=env.SMEM_BYTES)
    assert env.fused_lookup_block(32, 128) == 8
    assert env.fused_lookup_block(3, 128) == 2
    # two 16384-wide fp32 tiles a warp (128 KB) leave room for one row
    assert env.fused_lookup_block(1024, 16384) == 1
    # nn_search: (bank rows per tile, stages in its ring) at any D, the
    # queries riding the ring; a small bank takes smaller tiles
    assert tile_plan(8, n_rows=1_939_743) == (512, 4)
    assert tile_plan(KMAX, n_rows=1_939_743) == (512, 4)
    assert tile_plan(9, n_rows=2048) == (64, 4)


def test_ivf_stage2_shared_memory():
    """The stage-2 partial pass's shared memory (ivf_stage2.cuh mirrors
    it): two blocks an SM at the serve shapes, the largest k in one; and
    the plan's scratch, 16-byte aligned items after the pairs' counts."""
    from repro_torch.kernels import ivf_stage2 as s2
    assert s2.tile_rows(True) == 1024 and s2.tile_rows(False) == 512
    half = (env.SMEM_BYTES + 1024) // 2 - 1024 - 512
    assert s2.smem_bytes(128, 8, 2, False) == 95_488 <= half
    assert s2.smem_bytes(128, 32, 2, True) == 111_872 <= half
    assert s2.smem_bytes(128, 128, 4, True) <= s2.SMEM_BUDGET
    # a side buffer for each tile whose ids may be in flight: at D 16 a
    # tile is one stage, so two stages hold two tiles' ids (and int8
    # scales and offsets)
    assert s2.smem_bytes(16, 8, 2, True) - s2.smem_bytes(16, 8, 2, False) \
        == 2 * 1024 * 12 - 2 * 512 * 4
    assert s2.scratch_ints(64, 264, 32) == 132 + 4 * 328 + 2 * 32
    assert s2.scratch_ints(3, 10, 0) % 4 == 0


@pytest.mark.parametrize("bad,match", [
    (dict(k=0), "k <= 128"), (dict(k=129), "k <= 128"),
    (dict(dim=66), "D % 4"), (dict(pointers=[16, 8]), "aligned"),
    (dict(rows=4 * 6), "multiple of 4"), (dict(rows=2**31), "2\\*\\*31"),
    (dict(dim=2050, k=128), "D % 4")])
def test_ivf_stage2_refusals(bad, match):
    """What every stage-2 entry refuses beyond device, type and shape."""
    from repro_torch.kernels.ivf_stage2 import check_stage2
    args = dict(name="ivf_stage2", rows=4 * 8, dim=64, C=4, k=8, align=4,
                int8=False, pointers=[0, 256])
    check_stage2(**args)
    with pytest.raises(ValueError, match=match):
        check_stage2(**{**args, **bad})


def test_resolve_device_never_falls_back(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        env.resolve_device()
    assert env.resolve_device("cpu") == torch.device("cpu")
    with pytest.raises(ValueError):
        env.resolve_device("mps")
    assert torch.backends.cuda.matmul.allow_tf32 is False
    assert torch.backends.cudnn.allow_tf32 is False
