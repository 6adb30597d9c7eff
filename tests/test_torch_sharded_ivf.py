"""The port's sharded IVF path held against the JAX package on the CPU, on
the same numpy inputs: the plain version of the sharded stage-2 kernel
(repro_torch.kernels.ref.ivf_stage2_sharded_ref) against
``ivf_stage2_sharded_pallas`` in interpret mode; the sharded searches
against the meshless oracle ``ivf_search_sharded_jnp`` (which the JAX
tests pin to the ``shard_map`` op) and ``ivf_search_sharded_pallas``; the
port's own sharded build and partial rebuilds; and ``ShardedBackend``'s
engine and server against the JAX dense engine and the oracle.

Tolerances: the stage-2 shortlists' ids exact and their scores within
atol 1e-4 plus 8 fp32 ulps of the score (the kernels' rule); the searches'
scores within atol 1e-5 plus 8 ulps and their ids exact where the scores
around them are apart by more than 1e-4 plus twice that; state leaves
atol 1e-6, lookup values 1e-5 (tests/test_kb_engine.py). The port's
k-means may break float ties another way than JAX's, so its own build is
held by recall (>= 0.95 against exact) and by determinism, and search
parity runs on indexes that JAX built.
"""
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import KBEngine as JaxEngine
from repro.core import ann_index as jann
from repro.core import knowledge_bank as jkb
from repro.kernels import nn_search_ivf as jivf
from repro_torch.convert import kb_state_to_numpy, sharded_ivf_index_from
from repro_torch.core import ann_index as tann
from repro_torch.core.async_runtime import KnowledgeBankServer
from repro_torch.core.kb_engine import KBEngine, ShardedBackend
from repro_torch.kernels import nn_search_ivf as tivf
from repro_torch.kernels import ops, ref
from repro_torch.launch import serve

D = 16
# the meshless oracle, compiled once per shape (its eager ops would each
# compile on their own)
oracle = jax.jit(jivf.ivf_search_sharded_jnp, static_argnums=(5, 6),
                 static_argnames=("n_shards",))
RTOL = 8 * 2.0 ** -23     # 8 fp32 ulps of a score
LAZY_LR, ZMAX = 0.2, 2.0


def t(a):
    return torch.from_numpy(np.array(a))


def skewed_bank(n, seed=0):
    """~70% of the rows in one tight cluster: very unequal buckets
    (tests/test_kernel_config.py's skewed bank)."""
    rng = np.random.default_rng(seed)
    fat = 0.05 * rng.normal(size=(int(n * 0.7), D)) + 3.0
    rest = rng.normal(size=(n - fat.shape[0], D))
    return np.concatenate([fat, rest]).astype(np.float32)[
        rng.permutation(n)]


def clustered(n, centers, seed):
    return tann.clustered_bank(n, D, centers, seed=seed)     # numpy


def local_probes(queries, centroids, S, nprobe):
    """The JAX searches' stage 1, (B, S, nprobe) local bucket ids."""
    cs = jnp.einsum("bd,scd->bsc", jnp.asarray(queries),
                    jnp.asarray(centroids).reshape(S, -1, D))
    return np.asarray(jax.lax.top_k(cs, nprobe)[1], np.int32)


def assert_nn_close(got, want, label=""):
    (gs, gi), (ws, wi) = [tuple(np.asarray(x) for x in p)
                          for p in (got, want)]
    fin = np.isfinite(ws)
    np.testing.assert_array_equal(np.isfinite(gs), fin, err_msg=label)
    np.testing.assert_allclose(gs[fin], ws[fin], rtol=RTOL, atol=1e-5,
                               err_msg=f"{label} scores")
    s = np.where(fin, ws, -1e30)
    near = 1e-4 + 2 * RTOL * np.maximum(np.abs(s[:, :-1]), np.abs(s[:, 1:]))
    gap = np.concatenate([s[:, :-1] - s[:, 1:] > near,
                          np.ones((len(s), 1), bool)], 1)
    decided = gap & np.roll(gap, 1, 1)
    np.testing.assert_array_equal(gi[decided], wi[decided],
                                  err_msg=f"{label} ids")
    assert decided.mean() > 0.5, label


# ---------------------------------------------------------------------------
# the kernel's plain version against the Pallas kernel
# ---------------------------------------------------------------------------

STAGE2_CASES = {
    # bank, shards, nlist per shard, nprobe, k
    "clustered": (lambda: clustered(1024, 12, 3), 4, 8, 3, 8),
    "skewed": (lambda: skewed_bank(768, 9), 3, 8, 2, 16),
    # a shard's probed buckets hold fewer than k rows: padding
    "short": (lambda: clustered(512, 4, 5), 2, 16, 1, 16),
}


@pytest.mark.parametrize("jax_occ", [True, False])
@pytest.mark.parametrize("case", sorted(STAGE2_CASES))
def test_stage2_sharded_plain_matches_pallas(case, jax_occ):
    make, S, nlist, nprobe, k = STAGE2_CASES[case]
    table = make()
    jidx = jann.build_sharded_ivf_index(table, S, nlist=nlist, iters=5)
    idx = sharded_ivf_index_from(jidx, "cpu")
    rng = np.random.default_rng(11)
    q = (table[rng.integers(0, len(table), 6)]
         + 0.05 * rng.standard_normal((6, D))).astype(np.float32)
    probes = local_probes(q, jidx.centroids, S, nprobe)
    ws, wi = jivf.ivf_stage2_sharded_pallas(
        jidx.packed_vecs, jidx.packed_ids, jnp.asarray(q),
        jnp.asarray(probes), k, n_shards=S, nlist=idx.nlist,
        bucket_cap=idx.bucket_cap,
        bucket_occ=jidx.bucket_occ if jax_occ else None, interpret=True)
    gs, gi = ref.ivf_stage2_sharded_ref(idx.packed_vecs, idx.packed_ids,
                                        idx.bucket_occ, t(q), t(probes), k)
    ws, wi = np.asarray(ws), np.asarray(wi)
    assert gs.shape == gi.shape == (6, S, k)
    np.testing.assert_allclose(gs.numpy(), ws, rtol=RTOL, atol=1e-4)
    # every filled slot holds the Pallas id; an unfilled one (score -1e30)
    # holds 2**31 - 1. (Pallas's _merge_topk, once a list runs out of
    # candidates, repeats the lowest id it already took with score -1e30;
    # the oracle ivf_search_sharded_jnp pads with -1 there.)
    filled = ws > -1e30
    np.testing.assert_array_equal(gi.numpy()[filled], wi[filled])
    assert (gi.numpy()[~filled] == 2 ** 31 - 1).all()
    if case == "short":             # a shard's short shortlist is padded
        assert (~filled).any()
    # the wrapper takes the plain version for CPU tensors
    os_, oi = ops.ivf_stage2_sharded(idx.packed_vecs, idx.packed_ids,
                                     idx.bucket_occ, t(q), t(probes), k)
    assert torch.equal(oi, gi) and torch.equal(os_, gs)


def test_stage2_sharded_q_plain_is_the_single_pass_per_shard():
    """The int8 entry's plain version: each (query, shard) is the int8
    single-index stage 2 over that shard's globalised probes."""
    table = clustered(512, 8, 6)
    jidx = jann.QuantizedShardedIVFIndex(
        jann.build_sharded_ivf_index(table, 2, nlist=8, iters=4))
    idx = sharded_ivf_index_from(jidx, "cpu")
    q = t(table[:5] + 0.01)
    probes = t(local_probes(q.numpy(), jidx.centroids, 2, 3))
    args = (idx.packed_codes, idx.packed_scale, idx.packed_offset,
            idx.packed_ids, idx.bucket_occ)
    gs, gi = ops.ivf_stage2_sharded_q(*args, q, probes, 12)
    for s in range(2):
        ws, wi = ref.ivf_stage2_q_ref(*args, q, probes[:, s] + s * 8, 12)
        assert torch.equal(gi[:, s], wi) and torch.equal(gs[:, s], ws)


# ---------------------------------------------------------------------------
# the sharded searches against the JAX oracle and the Pallas search
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("storage", ["fp32", "int8"])
def test_sharded_searches_match_jax_on_a_jax_index(storage):
    # the "clustered" stage-2 case's bank, index and query count: the
    # Pallas search's stage 2 reuses that case's compiled kernel
    S, k, nprobe = 4, 8, 3
    table = clustered(1024, 12, 3)
    jidx = jann.build_sharded_ivf_index(table, S, nlist=8, iters=5)
    if storage == "int8":
        jidx = jann.QuantizedShardedIVFIndex(jidx)
    idx = sharded_ivf_index_from(jidx, "cpu")
    rng = np.random.default_rng(4)
    q = (table[rng.integers(0, 1024, 6)]
         + 0.05 * rng.standard_normal((6, D))).astype(np.float32)
    if storage == "int8":
        rows = (idx.packed_codes,)
        extra = dict(packed_scale=idx.packed_scale,
                     packed_offset=idx.packed_offset)
        jextra = dict(packed_scale=jidx.packed_scale,
                      packed_offset=jidx.packed_offset)
        jrows = jidx.packed_codes
    else:
        rows, extra, jextra, jrows = (idx.packed_vecs,), {}, {}, \
            jidx.packed_vecs
    want = oracle(
        jnp.asarray(table), jidx.centroids, jrows, jidx.packed_ids,
        jnp.asarray(q), k, nprobe, n_shards=S, **jextra)
    targs = (t(table), idx.centroids, *rows, idx.packed_ids, t(q), k, nprobe)
    assert_nn_close(tivf.ivf_search_sharded_ref(*targs, n_shards=S, **extra),
                    want, "oracle")
    assert_nn_close(tivf.ivf_search_sharded(*targs, n_shards=S,
                                            bucket_occ=idx.bucket_occ,
                                            **extra), want, "kernel path")
    if storage == "fp32":
        pallas = jivf.ivf_search_sharded_pallas(
            jnp.asarray(table), jidx.centroids, jidx.packed_vecs,
            jidx.packed_ids, jnp.asarray(q), k, nprobe, n_shards=S,
            bucket_occ=jidx.bucket_occ, interpret=True)
        assert_nn_close(tivf.ivf_search_sharded(
            *targs, n_shards=S, bucket_occ=idx.bucket_occ), pallas, "pallas")


def test_sharded_probes_match_jax_and_clamp_nprobe():
    table = clustered(256, 8, 2)
    jidx = jann.build_sharded_ivf_index(table, 2, nlist=4, iters=3)
    q = table[:5] + 0.01
    got = tivf.sharded_probes(t(q), t(jidx.centroids), 2, 9)
    assert got.shape == (5, 2, 4) and got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(),
                                  local_probes(q, jidx.centroids, 2, 4))


# ---------------------------------------------------------------------------
# the port's build and partial rebuilds (tests/test_sharded_ivf.py:35-290)
# ---------------------------------------------------------------------------

def test_sharded_build_packs_each_shard_with_its_own_global_ids():
    n, S = 256, 4
    table = t(clustered(n, 8, 0))
    idx = tann.build_sharded_ivf_index(table, S, nlist=8, iters=5)
    assert isinstance(idx, tann.ShardedIVFIndex) and idx.n_shards == S
    C, cap, n_local = idx.nlist, idx.bucket_cap, n // S
    pids = idx.packed_ids.numpy()
    seen = []
    for s in range(S):
        block = pids[s * C * cap:(s + 1) * C * cap]
        real = block[block >= 0]
        assert ((real >= s * n_local) & (real < (s + 1) * n_local)).all()
        seen.extend(real.tolist())
    assert sorted(seen) == list(range(n))
    pv = idx.packed_vecs.numpy()
    np.testing.assert_array_equal(pv[pids >= 0], table.numpy()[
        pids[pids >= 0]])
    np.testing.assert_array_equal(
        idx.bucket_occ.numpy(), (pids.reshape(S * C, cap) >= 0).sum(1))
    stats = idx.shard_stats()
    assert [st["shard"] for st in stats] == list(range(S))
    assert all(st["bucket_cap"] == cap for st in stats)


def test_sharded_build_refuses_indivisible_banks_and_bad_shard_ids():
    with pytest.raises(ValueError):
        tann.build_sharded_ivf_index(t(clustered(100, 4, 0)), 3, nlist=4)
    table = t(clustered(256, 8, 0))
    base = tann.build_sharded_ivf_index(table, 4, nlist=8, iters=4)
    for bad in ([4], [-1]):
        with pytest.raises(ValueError):
            tann.build_sharded_ivf_index(table, 4, nlist=8, iters=4,
                                         base=base, shards=bad)


def test_sharded_build_is_deterministic_and_empty_list_is_a_noop():
    table = t(clustered(512, 8, 5))
    a = tann.build_sharded_ivf_index(table, 4, nlist=8, iters=5)
    b = tann.build_sharded_ivf_index(table, 4, nlist=8, iters=5)
    assert all(torch.equal(x, y) for x, y in zip(a.tensors(), b.tensors()))
    assert tann.build_sharded_ivf_index(table, 4, nlist=8, iters=4, base=a,
                                        shards=[]) is a


def test_partial_rebuild_touches_only_requested_shards():
    n, S = 2048, 4
    table = clustered(n, 24, 3)
    base = tann.build_sharded_ivf_index(t(table), S, nlist=16, iters=6)
    n_local = n // S
    t2 = table.copy()
    t2[n_local:2 * n_local] *= 1.01
    idx = tann.build_sharded_ivf_index(t(t2), S, nlist=16, iters=6,
                                       base=base, shards=[1])
    assert idx.bucket_cap == base.bucket_cap
    C, cap = idx.nlist, idx.bucket_cap
    for s in range(S):
        blk = slice(s * C * cap, (s + 1) * C * cap)
        cen = slice(s * C, (s + 1) * C)
        same = [torch.equal(base.packed_vecs[blk], idx.packed_vecs[blk]),
                torch.equal(base.packed_ids[blk], idx.packed_ids[blk]),
                torch.equal(base.centroids[cen], idx.centroids[cen]),
                torch.equal(base.bucket_occ[cen], idx.bucket_occ[cen])]
        assert all(same) == (s != 1), (s, same)
    # the rebuilt shard equals that shard of a full build of the snapshot
    full = tann.build_sharded_ivf_index(t(t2), S, nlist=16, iters=6)
    blk = slice(C * cap, 2 * C * cap)
    assert torch.equal(full.packed_vecs[blk], idx.packed_vecs[blk])


def test_partial_rebuild_upgrades_to_full_when_capacity_grows():
    n, S = 512, 4
    table = clustered(n, 16, 6)
    base = tann.build_sharded_ivf_index(t(table), S, nlist=16, iters=6)
    t2 = table.copy()
    t2[2 * (n // S):3 * (n // S)] = t2[2 * (n // S)]   # one bucket
    idx = tann.build_sharded_ivf_index(t(t2), S, nlist=16, iters=6,
                                       base=base, shards=[2])
    assert idx.bucket_cap > base.bucket_cap
    pids = idx.packed_ids.numpy()
    assert sorted(pids[pids >= 0].tolist()) == list(range(n))
    full = tann.build_sharded_ivf_index(t(t2), S, nlist=16, iters=6)
    assert all(torch.equal(x, y) for x, y in zip(idx.tensors(),
                                                 full.tensors()))


@pytest.mark.parametrize("quantized", [False, True])
def test_port_build_recall_against_exact(quantized):
    """The port's own sharded build, searched through the kernel path:
    recall@10 >= 0.95 on a clustered bank (tests/test_sharded_ivf.py)."""
    n, S = 2048, 8
    table = clustered(n, 24, 3)
    idx = tann.build_sharded_ivf_index(t(table), S, nlist=16, iters=6)
    if quantized:
        idx = tann.QuantizedShardedIVFIndex(idx)
        assert idx.base is not None and idx.shard_stats()[0]["shard"] == 0
    rng = np.random.default_rng(9)
    q = t(table[rng.integers(0, n, 16)] + 0.05)
    exact = torch.topk(q @ t(table).T, 10).indices.numpy()
    from repro_torch.core.sharded_kb import sharded_kb_nn_search_ivf
    _, approx = sharded_kb_nn_search_ivf(t(table), idx, q, 10, 4)
    recall = np.mean([len(set(exact[b]) & set(approx[b].tolist())) / 10
                      for b in range(16)])
    assert recall >= 0.95, recall


# ---------------------------------------------------------------------------
# ShardedBackend: engine and server
# ---------------------------------------------------------------------------

def bank_leaves(n, table):
    return {"table": table, "version": np.zeros(n, np.int32),
            "grad_sum": np.zeros((n, D), np.float32),
            "grad_cnt": np.zeros(n, np.float32),
            "grad_sqnorm": np.zeros(n, np.float32),
            "norm_ema": np.zeros(n, np.float32),
            "step": np.zeros((), np.int32)}


def sharded_engine(n, S, table=None, **kw):
    eng = KBEngine(n, D, backend=ShardedBackend(S), lazy_lr=LAZY_LR,
                   zmax=ZMAX, device="cpu", **kw)
    if table is not None:
        eng.update(np.arange(n), table)
    return eng


def test_sharded_engine_row_ops_and_exact_search_match_jax_dense():
    n, S = 200, 4
    rng = np.random.default_rng(0)
    leaves = bank_leaves(n, (0.5 * rng.standard_normal((n, D))).astype(
        np.float32))
    port = sharded_engine(n, S)
    port.load_state(leaves)
    jeng = JaxEngine(n, D, backend="dense", lazy_lr=LAZY_LR, zmax=ZMAX)
    jeng.state = jkb.KBState(**{f: jnp.asarray(leaves[f])
                                for f in jkb.KBState._fields})
    for size in (3, 17):
        ids = rng.integers(0, n, size)
        ids[size // 2:] = ids[:size - size // 2]
        g = (0.1 * rng.standard_normal((size, D))).astype(np.float32)
        for e in (port, jeng):
            e.lazy_grad(ids, g)
        np.testing.assert_allclose(port.lookup(ids), jeng.lookup(ids),
                                   atol=1e-5)
    for e in (port, jeng):
        e.update(np.array([4, 4, 60, 150]), np.ones((4, D), np.float32))
        e.lazy_grad(np.array([150, 9]), np.full((2, D), 0.05, np.float32))
        e.flush()
    got = kb_state_to_numpy(port.state)
    for f in jkb.KBState._fields:
        want = np.asarray(getattr(jeng.state, f))
        if f in ("version", "grad_cnt", "step"):
            np.testing.assert_array_equal(got[f], want, err_msg=f)
        else:
            np.testing.assert_allclose(got[f], want, atol=1e-6, err_msg=f)
    q = rng.standard_normal((5, D)).astype(np.float32)
    assert_nn_close(port.nn_search(q, 6), jkb.kb_nn_search(
        jeng.state, jnp.asarray(q), 6), "exact")
    # exclusion across shard boundaries: the over-fetch of the engine
    best = np.argsort(-(q @ port.table_snapshot().T), 1)[:, :3]
    assert len(np.unique(best // (n // S))) > 1
    assert_nn_close(port.nn_search(q, 6, exclude_ids=best),
                    jkb.kb_nn_search(jeng.state, jnp.asarray(q), 6,
                                     exclude_ids=jnp.asarray(best)), "excl")
    assert port.search_stats == {"exact": 2, "ivf": 0}


@pytest.mark.parametrize("storage", ["fp32", "int8"])
def test_sharded_engine_ivf_matches_the_oracle_on_a_jax_index(storage):
    # the searches test's bank, index and query count (shared compiles)
    n, S, k = 1024, 4, 8
    table = clustered(n, 12, 3)
    eng = sharded_engine(n, S, table, search_mode="ivf", ann_nlist=8,
                         ann_nprobe=3, storage=storage)
    assert eng.state.table.dtype == torch.float32     # int8: the index
    jidx = jann.build_sharded_ivf_index(table, S, nlist=8, iters=5)
    if storage == "int8":
        jidx = jann.QuantizedShardedIVFIndex(jidx)
        rows, extra = jidx.packed_codes, dict(
            packed_scale=jidx.packed_scale, packed_offset=jidx.packed_offset)
    else:
        rows, extra = jidx.packed_vecs, {}
    eng.set_ann_index(sharded_ivf_index_from(jidx, "cpu"))
    rng = np.random.default_rng(7)
    q = (table[rng.integers(0, n, 6)] + 0.05 * rng.standard_normal(
        (6, D))).astype(np.float32)
    kq = 4 * k if storage == "int8" else k      # the sharded op's 4k
    jargs = (jnp.asarray(table), jidx.centroids, rows, jidx.packed_ids,
             jnp.asarray(q))
    ws, wi = oracle(*jargs, kq, 3, n_shards=S, **extra)
    assert_nn_close(eng.nn_search(q, k),
                    (np.asarray(ws)[:, :k], np.asarray(wi)[:, :k]), "ivf")
    # exclusion spanning shards: the engine over-fetches k + E
    _, top = eng.nn_search(q, 3)
    assert len(np.unique(top // (n // S))) > 1
    ws, wi = oracle(*jargs, kq + 3, 3, n_shards=S, **extra)
    ws, wi = np.asarray(ws), np.asarray(wi)
    banned = (wi[:, :, None] == top[:, None, :]).any(-1)
    ws, wi = np.where(banned, -np.inf, ws), np.where(banned, -1, wi)
    order = np.argsort(-ws, 1, kind="stable")[:, :k]
    got = eng.nn_search(q, k, exclude_ids=top)
    assert not (got[1][:, :, None] == top[:, None, :]).any()
    if storage == "fp32":
        assert_nn_close(got, (np.take_along_axis(ws, order, 1),
                              np.take_along_axis(wi, order, 1)), "excl")
    assert eng.search_stats == {"exact": 0, "ivf": 3}


@pytest.mark.parametrize("storage", ["fp32", "int8"])
def test_one_shard_engine_builds_the_single_index(storage):
    """One shard is the single index, as in JAX (``ann_shards == 1``
    builds ``build_ivf_index``, quantized for int8 storage over the fp32
    table), and the sharded search through it equals the kernel
    backend's over the same fp32 index."""
    n = 512
    table = clustered(n, 8, 2)
    eng = sharded_engine(n, 1, table, search_mode="ivf", ann_nlist=8,
                         ann_nprobe=3, storage=storage)
    assert eng.rebuild_ann_index(iters=4, shards=[0]) == 1
    want = tann.QuantizedIVFIndex if storage == "int8" else tann.IVFIndex
    assert type(eng.ann_index) is want
    q = table[::64] + 0.01
    s, i = eng.nn_search(q, 5)
    assert eng.search_stats == {"exact": 0, "ivf": 1}
    if storage == "fp32":
        single = KBEngine(n, D, backend="cuda", search_mode="ivf",
                          ann_nlist=8, ann_nprobe=3, device="cpu")
        single.update(np.arange(n), table)
        single.set_ann_index(eng.ann_index)
        np.testing.assert_array_equal(single.nn_search(q, 5)[1], i)
    else:
        assert ((i >= 0) & (i < n)).all() and np.isfinite(s).all()


def test_per_shard_clocks_and_staleness():
    n, S = 64, 4
    eng = sharded_engine(n, S)
    eng.update(np.array([0, 1, 17, 63, 63]), np.ones((5, D), np.float32))
    eng.lazy_grad(np.array([2, 40]), np.ones((2, D), np.float32))
    assert eng.total_write_rows == 6        # update deduplicates 63
    assert eng.shard_write_rows.tolist() == [3, 1, 1, 1]
    assert np.isinf(eng.ann_shard_staleness_rows).all()
    idx = tann.build_sharded_ivf_index(eng.state.table, S, nlist=2, iters=2)
    eng.set_ann_index(idx)                        # fresh now
    assert (eng.ann_shard_staleness_rows == 0).all()
    eng.set_ann_index(idx, built_at_shard_writes=[0, 0, 1, 1])
    assert eng.ann_shard_staleness_rows.tolist() == [3, 1, 0, 0]
    assert eng.ann_staleness_rows == 3          # the worst shard's
    with pytest.raises(ValueError):
        sharded_engine(66, 4)                 # 4 does not divide 66


def test_engine_partial_rebuild_keeps_untouched_shards_and_clocks():
    n, S = 512, 4
    table = clustered(n, 8, 4)
    eng = sharded_engine(n, S, table, search_mode="ivf", ann_nlist=8,
                         ann_nprobe=2, storage="int8")
    assert eng.rebuild_ann_index(iters=4) == S
    first = eng.ann_index
    assert isinstance(first, tann.QuantizedShardedIVFIndex)
    eng.update(np.arange(256, 300), table[256:300, ::-1])    # shard 2
    eng.lazy_grad(np.array([5]), np.ones((1, D), np.float32))  # shard 0
    clocks = eng._ann_shard_built_at.copy()
    assert eng.rebuild_ann_index(iters=4, shards=[2]) == 1
    new = eng.ann_index
    assert eng.ann_shard_staleness_rows.tolist() == [1, 0, 0, 0]
    assert eng._ann_shard_built_at[[0, 1, 3]].tolist() == \
        clocks[[0, 1, 3]].tolist()
    C, cap = new.nlist, new.bucket_cap
    for s in range(S):
        blk = slice(s * C * cap, (s + 1) * C * cap)
        same = torch.equal(first.packed_codes[blk], new.packed_codes[blk])
        assert same == (s != 2), s
    assert eng.rebuild_ann_index(iters=4, shards=[]) == 0
    assert eng.ann_index is new


def test_refresher_rebuilds_only_the_written_shard():
    n, S = 512, 4
    table = clustered(n, 8, 8)
    srv = KnowledgeBankServer(engine=sharded_engine(
        n, S, table, search_mode="ivf", ann_nlist=8, ann_nprobe=2),
        device="cpu")
    try:
        ref_ = srv.start_ann_refresher(rebuild_rows=S * 50, iters=4,
                                       min_period_s=0.001)
        assert ref_.rebuild_shard_rows == 50
        deadline = time.time() + 60
        while srv.engine.ann_index is None and time.time() < deadline:
            time.sleep(0.005)
        first = srv.engine.ann_index
        assert srv.stats()["shard_rebuilds"] == S
        srv.update(np.arange(128, 188), 1.01 * table[128:188])   # shard 1
        while ref_.shard_rebuilds == S and time.time() < deadline:
            time.sleep(0.005)
        assert ref_.last_error is None, ref_.last_error
        new = srv.engine.ann_index
        stats = srv.stats()
        assert stats["shard_rebuilds"] == S + 1 and stats["rebuilds"] == 2
        assert ref_.last_build_s > 0
        C, cap = new.nlist, new.bucket_cap
        for s in range(S):
            blk = slice(s * C * cap, (s + 1) * C * cap)
            same = torch.equal(first.packed_vecs[blk], new.packed_vecs[blk])
            assert same == (s != 1), s
        assert srv.engine.ann_shard_staleness_rows.sum() == 0
    finally:
        srv.close()


def test_coalesced_sharded_ivf_searches_equal_solo_ones():
    n, S = 512, 4
    table = clustered(n, 8, 4)

    def fresh():
        e = sharded_engine(n, S, table, search_mode="ivf", ann_nlist=8,
                           ann_nprobe=2)
        e.rebuild_ann_index(iters=4)
        return e

    solo = fresh()
    queries = {i: table[i * 8:i * 8 + 4] + 0.01 for i in range(8)}
    want = {i: solo.nn_search(queries[i], 5) for i in range(8)}
    srv = KnowledgeBankServer(engine=fresh(), coalesce_window_s=0.05,
                              device="cpu")
    got = {}
    threads = [threading.Thread(
        target=lambda i=i: got.__setitem__(i, srv.nn_search(queries[i], 5)))
        for i in range(8)]
    d0 = srv.metrics["dispatches"]
    for th in threads:
        th.start()
    for th in threads:
        th.join()
    merged = srv.metrics["dispatches"] - d0
    srv.close()
    assert merged < 8 and srv.engine.search_stats["exact"] == 0
    for i in range(8):
        np.testing.assert_array_equal(got[i][1], want[i][1])
        np.testing.assert_array_equal(got[i][0], want[i][0])


@pytest.mark.parametrize("storage", ["fp32", "int8"])
def test_serve_sharded_ivf_on_the_cpu(capsys, storage):
    res = serve.main(["--kb", "--device", "cpu", "--kb-backend", "sharded",
                      "--kb-shards", "4", "--kb-search", "ivf",
                      "--kb-entries", "400", "--kb-dim", "16", "--clients",
                      "4", "--batch", "3", "--gen", "3", "--nlist", "8",
                      "--nprobe", "3", "--kb-storage", storage])
    out = capsys.readouterr().out.splitlines()
    assert out[0].startswith("kb-serve backend=sharded search=ivf ")
    assert "(4 shard builds)" in out[0]
    assert out[1].startswith(f"kb storage mode={storage} bytes/row=64 ")
    assert [line.split(":")[0] for line in out[2:]] == [
        f"ivf shard {s}" for s in range(4)]
    assert res["search_stats"]["exact"] == 0
    assert res["search_stats"]["ivf"] > 1
    assert res["index_rebuilds"] >= 1 and res["shard_rebuilds"] >= 4
    eng = res["engine"]
    assert isinstance(eng.backend, ShardedBackend) and eng.ann_shards == 4
    assert not eng.state.grad_cnt.any()           # flushed
    with pytest.raises(ValueError):
        serve.main(["--kb", "--device", "cpu", "--kb-shards", "4",
                    "--kb-entries", "400", "--kb-dim", "16"])


def test_sharded_index_round_trips_through_convert():
    table = clustered(256, 8, 3)
    jidx = jann.QuantizedShardedIVFIndex(
        jann.build_sharded_ivf_index(table, 2, nlist=4, iters=3))
    idx = sharded_ivf_index_from(jidx, "cpu")
    assert isinstance(idx, tann.QuantizedShardedIVFIndex)
    for name in ("centroids", "packed_codes", "packed_scale",
                 "packed_offset", "packed_ids", "bucket_occ"):
        np.testing.assert_array_equal(getattr(idx, name).numpy(),
                                      np.asarray(getattr(jidx, name)))
    np.testing.assert_array_equal(idx.base.packed_vecs.numpy(),
                                  np.asarray(jidx.base.packed_vecs))
    # the port quantizes a packed index as JAX does
    again = tann.QuantizedShardedIVFIndex(idx.base)
    assert torch.equal(again.packed_codes, idx.packed_codes)
