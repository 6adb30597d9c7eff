"""The port's IVF index (repro_torch.core.ann_index) and the host half of
its two-stage search (repro_torch.kernels.nn_search_ivf) held against the
JAX package on the CPU, on the same numpy inputs.

- exact against JAX: ``_chunk_rows``, ``_round_capacity``,
  ``ivf_chunk_plan``, ``ivf_probes``, ``_pack_buckets`` and the int8
  quantization of a packed index;
- stage 2 and the full search on an index the JAX package built: the
  plain versions of the stage-2 kernels against the Pallas kernels
  (interpret mode) on the same probes, and the port's searches against
  ``ivf_search_jnp`` / ``ivf_search_quantized_jnp`` and the Pallas
  searches. Tolerances: scores atol 1e-5 plus 8 fp32 ulps of the score
  (rtol 8 * 2**-23: the sums are rounded in another order), ids exact
  where the scores around them are apart by more than 1e-4 plus twice
  that relative bound (tests/test_kb_engine.py);
- the port's own build, whose k-means may break float ties another way
  than JAX's: recall@10 >= 0.95 on a clustered bank
  (tests/test_ann_index.py:62-73) and two builds identical;
- the engine's IVF lifecycle: the exact fallback when the index is absent
  or stale, a rebuild on the test's own thread, the int8 and fp32 engines
  against the JAX engine on one index, and the refresher thread, waited
  on with a deadline and stopped in a ``finally``.
"""
import sys
import threading
import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import KBEngine as JaxEngine
from repro.core import ann_index as jann
from repro.kernels import nn_search_ivf as jivf
from repro_torch.convert import ivf_index_from
from repro_torch.core import ann_index as tann
from repro_torch.core.async_runtime import KnowledgeBankServer
from repro_torch.core.kb_engine import CudaBackend, DenseBackend, KBEngine
from repro_torch.core.knowledge_bank import KBState
from repro_torch.kernels import nn_search_ivf as tivf
from repro_torch.kernels import ops

D = 16
RTOL = 8 * 2.0 ** -23     # 8 fp32 ulps of a score


def t(a):
    return torch.from_numpy(np.array(a))


def assert_nn_close(got, want, label=""):
    (gs, gi), (ws, wi) = [tuple(np.asarray(x) for x in p)
                          for p in (got, want)]
    fin = np.isfinite(ws)
    np.testing.assert_array_equal(np.isfinite(gs), fin, err_msg=label)
    np.testing.assert_allclose(gs[fin], ws[fin], rtol=RTOL, atol=1e-5,
                               err_msg=f"{label} scores")
    s = np.where(fin, ws, -1e30)
    # two scores each within the bound of their own may swap when closer
    # than twice it
    near = 1e-4 + 2 * RTOL * np.maximum(np.abs(s[:, :-1]), np.abs(s[:, 1:]))
    gap = np.concatenate([s[:, :-1] - s[:, 1:] > near,
                          np.ones((len(s), 1), bool)], 1)
    decided = gap & np.roll(gap, 1, 1)
    np.testing.assert_array_equal(gi[decided], wi[decided],
                                  err_msg=f"{label} ids")
    assert decided.mean() > 0.5, label


def jax_index(n=512, nlist=8, seed=2, centers=8):
    """A clustered bank and the JAX package's index of it."""
    table = np.asarray(jann.clustered_bank(n, D, centers, seed=seed))
    return table, jann.build_ivf_index(table, nlist=nlist, iters=5)


# ---------------------------------------------------------------------------
# exact against JAX
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("cap", [8, 64, 128, 384, 640, 1024])
def test_chunk_rows_and_capacity_match_jax(cap):
    for block in (128, 256, 512):
        assert tivf._chunk_rows(cap, block) == jivf._chunk_rows(cap, block)
    assert tann._round_capacity(cap - 3) == jann._round_capacity(cap - 3)


@pytest.mark.parametrize("with_occ", [True, False])
def test_ivf_chunk_plan_matches_jax(with_occ):
    rng = np.random.default_rng(0)
    C, cpb, lb = 12, 3, 128
    probes = np.stack([rng.permutation(C)[:4] for _ in range(6)]).astype(
        np.int32)
    occ = rng.integers(0, cpb * lb + 1, C).astype(np.int32)
    occ[probes[0, 0]] = 0                          # an empty probed bucket
    sel, nv = tivf.ivf_chunk_plan(t(probes), t(occ) if with_occ else None,
                                  cpb, lb)
    jsel, jnv = jivf.ivf_chunk_plan(jnp.asarray(probes),
                                    jnp.asarray(occ) if with_occ else None,
                                    cpb, lb)
    np.testing.assert_array_equal(sel.numpy(), np.asarray(jsel))
    np.testing.assert_array_equal(nv.numpy(), np.asarray(jnv))


def test_ivf_probes_match_jax_and_clamp_nprobe():
    table, idx = jax_index()
    q = table[:7] + 0.01
    got = tivf.ivf_probes(t(q), t(idx.centroids), 3)
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(jivf.ivf_probes(jnp.asarray(q),
                                                idx.centroids, 3)))
    assert got.dtype == torch.int32
    assert tivf.ivf_probes(t(q), t(idx.centroids), 99).shape == (7, 8)


def test_pack_buckets_and_quantized_index_match_jax():
    rng = np.random.default_rng(1)
    tbl = rng.standard_normal((300, D)).astype(np.float32)
    assign = rng.integers(0, 7, 300)
    cap = jann._round_capacity(int(np.bincount(assign).max()))
    pv, pi = tann._pack_buckets(t(tbl), t(assign), 7, cap)
    jpv, jpi = jann._pack_buckets(tbl, assign, 7, cap)
    np.testing.assert_array_equal(pv.numpy(), jpv)
    np.testing.assert_array_equal(pi.numpy(), jpi)
    _, jidx = jax_index()
    qi = tann.QuantizedIVFIndex(ivf_index_from(jidx, "cpu"))
    jqi = jann.QuantizedIVFIndex(jidx)
    np.testing.assert_array_equal(qi.packed_codes.numpy(),
                                  np.asarray(jqi.packed_codes))
    np.testing.assert_array_equal(qi.packed_scale.numpy(),
                                  np.asarray(jqi.packed_scale))
    np.testing.assert_array_equal(qi.packed_offset.numpy(),
                                  np.asarray(jqi.packed_offset))
    conv = ivf_index_from(jqi, "cpu")              # carried over as is
    assert isinstance(conv, tann.QuantizedIVFIndex)
    assert torch.equal(conv.packed_codes, qi.packed_codes)
    assert conv.bucket_stats() == jqi.bucket_stats()


# ---------------------------------------------------------------------------
# stage 2 and the full search on a JAX-built index
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("k", [1, 5, 200])
def test_stage2_plain_matches_pallas(k):
    """The plain version of kernel #6 (what ops.ivf_stage2 runs on the
    CPU) against ivf_stage2_pallas on the same probes; k = 200 is past the
    candidates of some queries, so the padding is compared too."""
    table, idx = jax_index(n=700, nlist=8, centers=6)
    q = table[::70] + 0.01
    probes = jivf.ivf_probes(jnp.asarray(q), idx.centroids, 2)
    ws, wi = jivf.ivf_stage2_pallas(
        idx.packed_vecs, idx.packed_ids, jnp.asarray(q), probes, k,
        bucket_cap=idx.bucket_cap, bucket_occ=idx.bucket_occ,
        interpret=True)
    ti = ivf_index_from(idx, "cpu")
    gs, gi = ops.ivf_stage2(ti.packed_vecs, ti.packed_ids, ti.bucket_occ,
                            t(q), t(probes), k)
    assert gi.dtype == torch.int64
    np.testing.assert_allclose(gs.numpy(), np.asarray(ws), rtol=RTOL,
                               atol=1e-5)
    pad = np.asarray(wi) == np.iinfo(np.int32).max
    np.testing.assert_array_equal(gi.numpy()[pad], np.asarray(wi)[pad])
    assert_nn_close((np.where(pad, -np.inf, gs.numpy()), gi.numpy()),
                    (np.where(pad, -np.inf, np.asarray(ws)),
                     np.asarray(wi)), "stage2")


@pytest.mark.parametrize("k", [4, 32])
def test_stage2_q_plain_matches_pallas(k):
    table, idx = jax_index(n=600, nlist=6, centers=6, seed=3)
    qidx = jann.QuantizedIVFIndex(idx)
    q = table[::50] - 0.02
    probes = jivf.ivf_probes(jnp.asarray(q), idx.centroids, 3)
    ws, wi = jivf.ivf_stage2_quantized_pallas(
        qidx.packed_codes, qidx.packed_scale, qidx.packed_offset,
        qidx.packed_ids, jnp.asarray(q), probes, k,
        bucket_cap=idx.bucket_cap, bucket_occ=idx.bucket_occ,
        interpret=True)
    ti = ivf_index_from(qidx, "cpu")
    gs, gi = ops.ivf_stage2_q(ti.packed_codes, ti.packed_scale,
                              ti.packed_offset, ti.packed_ids,
                              ti.bucket_occ, t(q), t(probes), k)
    assert_nn_close((gs.numpy(), gi.numpy()),
                    (np.asarray(ws), np.asarray(wi)), "stage2_q")


def test_full_searches_match_jax_on_a_jax_index():
    """fp32 and int8, the plain searches (DenseBackend) against the jnp
    oracles and the kernel path (CudaBackend on CPU tensors) against the
    Pallas searches, with the live table differing from the snapshot."""
    table, idx = jax_index(n=512, nlist=8, seed=4)
    live = (1.5 * table).astype(np.float32)
    q = (table[:9] + 0.01).astype(np.float32)
    ti = ivf_index_from(idx, "cpu")
    st = KBState(t(live), *[None] * 6)
    want = jivf.ivf_search_jnp(jnp.asarray(live), idx.centroids,
                               idx.packed_vecs, idx.packed_ids,
                               jnp.asarray(q), 6, 3)
    assert_nn_close(DenseBackend().ivf_search(st, ti, t(q), 6, 3), want,
                    "dense fp32")
    want = jivf.ivf_search_pallas(jnp.asarray(live), idx.centroids,
                                  idx.packed_vecs, idx.packed_ids,
                                  jnp.asarray(q), 6, 3,
                                  bucket_occ=idx.bucket_occ, interpret=True)
    assert_nn_close(CudaBackend().ivf_search(st, ti, t(q), 6, 3), want,
                    "kernel path fp32")
    # int8: live bank and snapshot both coded
    from repro.core import knowledge_bank as jkb
    codes, s, o = map(np.asarray, jkb.quantize_rows(jnp.asarray(live)))
    qidx = jann.QuantizedIVFIndex(idx)
    tq = ivf_index_from(qidx, "cpu")
    st = KBState(t(codes), *[None] * 6)
    args = (jnp.asarray(codes), jnp.asarray(s), jnp.asarray(o),
            qidx.centroids, qidx.packed_codes, qidx.packed_scale,
            qidx.packed_offset, qidx.packed_ids, jnp.asarray(q), 6, 3)
    assert_nn_close(DenseBackend().ivf_search_q(st, t(s), t(o), tq, t(q),
                                                6, 3),
                    jivf.ivf_search_quantized_jnp(*args), "dense int8")
    assert_nn_close(CudaBackend().ivf_search_q(st, t(s), t(o), tq, t(q),
                                               6, 3),
                    jivf.ivf_search_quantized_pallas(
                        *args, bucket_occ=qidx.bucket_occ, interpret=True),
                    "kernel path int8")


def test_tiny_index_pads_with_minus_one():
    """nlist > N and k past every candidate: (-inf, -1) padding, as
    ivf_search_jnp pads."""
    table = np.eye(4, dtype=np.float32)
    idx = jann.build_ivf_index(table, nlist=16, iters=2)
    ti = ivf_index_from(idx, "cpu")
    q = table[:2]
    got = tivf.ivf_search_ref(t(table), ti.centroids, ti.packed_vecs,
                              ti.packed_ids, t(q), 6, 2)
    want = jivf.ivf_search_jnp(jnp.asarray(table), idx.centroids,
                               idx.packed_vecs, idx.packed_ids,
                               jnp.asarray(q), 6, 2)
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    kern = CudaBackend().ivf_search(KBState(t(table), *[None] * 6), ti,
                                    t(q), 6, 2)
    np.testing.assert_array_equal(kern[1].numpy(), np.asarray(want[1]))


# ---------------------------------------------------------------------------
# the port's own build
# ---------------------------------------------------------------------------

def test_port_build_packs_every_row_once_and_is_deterministic():
    table = t(tann.clustered_bank(300, 8, 10, seed=0))
    a = tann.build_ivf_index(table, nlist=10, iters=5)
    b = tann.build_ivf_index(table, nlist=10, iters=5)
    for x, y in zip(a.tensors(), b.tensors()):
        assert torch.equal(x, y)
    pids = a.packed_ids.numpy()
    real = pids[pids >= 0]
    assert sorted(real.tolist()) == list(range(300))
    pv = a.packed_vecs.numpy()
    np.testing.assert_array_equal(pv[pids >= 0], table.numpy()[real])
    assert not pv[pids < 0].any()
    occ = a.bucket_occ.numpy()
    assert occ.sum() == 300 and a.packed_ids.shape[0] == a.nlist * \
        a.bucket_cap
    for c in range(a.nlist):                 # each bucket filled from start
        seg = pids[c * a.bucket_cap:(c + 1) * a.bucket_cap]
        assert (seg[:occ[c]] >= 0).all() and (seg[occ[c]:] < 0).all()


@pytest.mark.parametrize("backend", [DenseBackend, CudaBackend])
def test_port_build_recall_at_10(backend):
    """The reference's recall test (tests/test_ann_index.py:62-73) on the
    same bank, through the port's own build."""
    table = np.asarray(jann.clustered_bank(2048, 16, 24, seed=3))
    idx = tann.build_ivf_index(t(table), nlist=24, iters=6)
    rng = np.random.default_rng(9)
    q = (table[rng.integers(0, 2048, 16)] + 0.05).astype(np.float32)
    exact = np.argsort(-(q @ table.T), axis=1, kind="stable")[:, :10]
    _, approx = backend().ivf_search(KBState(t(table), *[None] * 6), idx,
                                     t(q), 10, 4)
    approx = approx.numpy()
    recall = np.mean([len(set(exact[b]) & set(approx[b])) / 10
                      for b in range(16)])
    assert recall >= 0.95, recall


def test_kmeans_stays_balanced_and_reseeds_empty_clusters():
    table = t(tann.clustered_bank(4096, 16, 32, seed=1))
    _, assign = tann.kmeans(table, 32, iters=6)
    counts = np.bincount(assign.numpy(), minlength=32)
    assert counts.min() > 0 and counts.max() <= 3 * counts.mean()
    dup = torch.cat([table[:1].repeat(50, 1), table[:50]])  # many ties
    cents, assign = tann.kmeans(dup, 8, iters=3)
    assert cents.shape == (8, 16) and torch.isfinite(cents).all()


# ---------------------------------------------------------------------------
# the engine's IVF lifecycle
# ---------------------------------------------------------------------------

def test_engine_falls_back_to_exact_when_absent_or_stale():
    n = 256
    table = tann.clustered_bank(n, D, 8, seed=5)
    eng = KBEngine(n, D, search_mode="ivf", ann_nlist=8, ann_nprobe=2,
                   ann_stale_rows=10, device="cpu")
    eng.update(np.arange(n), table)
    q = table[:3]
    exact = eng.nn_search(q, 4, mode="exact")
    assert eng.nn_search(q, 4)[1].tolist() == exact[1].tolist()
    assert eng.search_stats == {"exact": 2, "ivf": 0}      # no index yet
    assert eng.rebuild_ann_index(iters=4) == 1             # this thread
    assert eng.ann_staleness_rows == 0
    eng.nn_search(q, 4)
    assert eng.search_stats["ivf"] == 1
    eng.lazy_grad(np.arange(11), np.zeros((11, D), np.float32))
    assert eng.ann_staleness_rows == 11                    # past budget
    eng.nn_search(q, 4)
    assert eng.search_stats == {"exact": 3, "ivf": 1}
    eng.nn_search(q, 4, mode="exact")                      # per request
    assert eng.search_stats["exact"] == 4


class SpyLock:
    def __init__(self):
        self.entered = 0

    def __enter__(self):
        self.entered += 1

    def __exit__(self, *exc):
        return False


def test_rebuild_takes_its_snapshot_under_the_lock_and_clock_first():
    eng = KBEngine(64, D, search_mode="ivf", ann_nlist=4, storage="int8",
                   device="cpu")
    eng.update(np.arange(64), tann.clustered_bank(64, D, 4, seed=6))
    lock = SpyLock()
    eng.rebuild_ann_index(iters=3, lock=lock)
    assert lock.entered == 1
    assert isinstance(eng.ann_index, tann.QuantizedIVFIndex)
    assert eng.ann_staleness_rows == 0 and eng.total_write_rows == 64
    srv = KnowledgeBankServer(engine=eng, coalesce=False)
    try:
        ref = srv.start_ann_refresher(min_period_s=3600.0)
        assert ref.lock is srv._elock
    finally:
        srv.close()


@pytest.mark.parametrize("storage", ["fp32", "int8"])
@pytest.mark.parametrize("port_backend,jax_backend", [("dense", "dense"),
                                                      ("cuda", "pallas")])
def test_ivf_engine_matches_jax_engine_on_one_index(storage, port_backend,
                                                    jax_backend):
    """Both engines serve IVF searches (with and without exclusion, int8
    with its 4x over-retrieval and master re-rank) from one JAX-built
    index."""
    n = 384
    table = np.asarray(jann.clustered_bank(n, D, 8, seed=7))
    kw = dict(search_mode="ivf", ann_nlist=8, ann_nprobe=3,
              storage=storage, master_rows=32)
    port = KBEngine(n, D, backend=port_backend, device="cpu", **kw)
    jeng = JaxEngine(n, D, backend=jax_backend, **kw)
    for e in (port, jeng):
        e.update(np.arange(n), table)
    jidx = jann.build_ivf_index(np.asarray(jeng.table_snapshot()), nlist=8,
                                iters=5)
    if storage == "int8":
        jidx = jann.QuantizedIVFIndex(jidx)
    jeng.set_ann_index(jidx)
    port.set_ann_index(ivf_index_from(jidx, "cpu"))
    q = (table[::40] + 0.003).astype(np.float32)
    want = jeng.nn_search(q, 5)
    assert_nn_close(port.nn_search(q, 5), want, "ivf")
    excl = np.stack([want[1][:, 0], np.full(len(q), -1)], 1)
    assert_nn_close(port.nn_search(q, 5, exclude_ids=excl),
                    jeng.nn_search(q, 5, exclude_ids=excl), "ivf excl")
    assert port.search_stats == jeng.search_stats
    assert port.search_stats["ivf"] > 0


def test_refresher_thread_builds_and_the_server_serves_from_it():
    """Waited on with a deadline, never by sleeping a fixed time; the
    thread is stopped in a finally."""
    n = 512
    srv = KnowledgeBankServer(n, D, search_mode="ivf", ann_nlist=8,
                              ann_nprobe=3, storage="int8", device="cpu")
    try:
        srv.update(np.arange(n), tann.clustered_bank(n, D, 8, seed=8))
        ref = srv.start_ann_refresher(min_period_s=0.01, iters=4)
        deadline = time.monotonic() + 120.0
        while srv.engine.ann_index is None:
            assert ref.last_error is None, ref.last_error
            assert time.monotonic() < deadline, "no index within 120 s"
            ref.stop_event.wait(0.01)
        s, i = srv.nn_search(tann.clustered_bank(4, D, 8, seed=8), k=5)
        assert i.shape == (4, 5) and np.isfinite(s).all()
        st = srv.stats()
        assert st["search_stats"]["ivf"] >= 1 and ref.rebuilds >= 1
        assert st["storage"]["mode"] == "int8"
    finally:
        srv.close()
    assert srv._ann_refresher is None and not ref.is_alive()


def test_refresher_snapshots_never_tear_under_concurrent_writes():
    """16 client threads write whole constant rows and search while the
    refresher rebuilds after every write; with a short switch interval.
    Every row of every index published must be constant: a snapshot taken
    while an in-place write was halfway through a row would not be."""
    n, d = 256, 64
    srv = KnowledgeBankServer(n, d, search_mode="ivf", ann_nlist=4,
                              ann_nprobe=2, device="cpu")
    published = []
    publish = srv.engine.set_ann_index

    def spy(index, **kw):
        published.append(index)
        publish(index, **kw)

    srv.engine.set_ann_index = spy
    errors = []

    def client(seed):
        rng = np.random.default_rng(seed)
        try:
            for _ in range(40):
                ids = rng.integers(0, n, 32)
                srv.update(ids, np.repeat(rng.standard_normal((32, 1)), d,
                                          1))
                s, i = srv.nn_search(rng.standard_normal((2, d)), k=3)
                assert ((i >= 0) & (i < n)).all() and np.isfinite(s).all()
        except Exception as e:              # reported below
            errors.append(e)

    switch = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        srv.update(np.arange(n), np.zeros((n, d), np.float32))
        ref = srv.start_ann_refresher(rebuild_rows=1, min_period_s=0.0,
                                      iters=2)
        threads = [threading.Thread(target=client, args=(t,))
                   for t in range(16)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=120)
        assert not any(th.is_alive() for th in threads)
        deadline = time.monotonic() + 60.0
        while len(published) < 3:
            assert time.monotonic() < deadline, len(published)
            ref.stop_event.wait(0.01)
    finally:
        sys.setswitchinterval(switch)
        srv.close()
    assert not errors, errors[0]
    assert ref.last_error is None and not ref.is_alive()
    for index in published:
        rows = index.packed_vecs[index.packed_ids >= 0]
        assert torch.equal(rows, rows[:, :1].expand_as(rows))
