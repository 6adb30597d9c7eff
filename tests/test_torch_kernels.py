"""The port's four kernel modules, on the CPU: each plain version
(repro_torch.kernels.ref) held against the Pallas kernel it replaces, run
in interpret mode as tests/test_kernels.py runs it, on the same numpy
inputs; the wrappers' dispatch (plain version only for CPU tensors); the
build's refusal to fall back. tests/test_torch_cuda_kernels.py holds each
CUDA kernel against its plain version on a card.

Tolerances: ids, versions and counts exact; rows and state leaves atol
1e-6; lookup values and nn scores atol 1e-5 (tests/test_kb_engine.py).
"""
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
from repro_torch.kernels.nn_search import KMAX, tile_rows

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


def test_build_raises_without_nvcc(tmp_path, monkeypatch):
    """A missing compiler is an error, never a quiet switch to the plain
    version."""
    monkeypatch.setattr(_build.shutil, "which", lambda name: None)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "no-cuda"))
    monkeypatch.setattr(_build, "BUILD_ROOT", tmp_path / "build")
    with pytest.raises(RuntimeError, match="nvcc"):
        _build.build(["kb_gather"])
    with pytest.raises(ValueError, match="unknown kernel source"):
        _build.build(["flash_attention"])


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
    assert env.fused_lookup_block(1024, 16384) == 2
    assert tile_rows(128, 8) == 128
    assert tile_rows(512, KMAX) == 32
    with pytest.raises(ValueError):
        tile_rows(2048, 8)


def test_resolve_device_never_falls_back(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        env.resolve_device()
    assert env.resolve_device("cpu") == torch.device("cpu")
    with pytest.raises(ValueError):
        env.resolve_device("mps")
    assert torch.backends.cuda.matmul.allow_tf32 is False
    assert torch.backends.cudnn.allow_tf32 is False
