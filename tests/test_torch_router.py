"""The port's scale-out router (repro_torch.core.kb_router) on the CPU.

- ``PartitionMap`` equals the JAX ring exactly (owner, local rank, counts,
  global ids) on a fixed grid of bank sizes, partition counts and vnodes,
  refusals included, and ROADMAP Q3 item 1's cases, which the port keeps
  on purpose: ids 0 .. 63 hash to partition 0's vnode points, so
  ``PartitionMap(192, P)`` puts them on partition 0 for every P, and
  ``PartitionMap(64, 2)`` leaves partition 1 empty and raises.
- A port ``KBRouter`` over 3 port servers answers as one port server
  holding the same table: rows, snapshot and ids exact, scores within
  tests/test_kb_engine.py's 1e-5 (ROADMAP Q3 item 2: a member's row count
  may change the CPU dot's summation order), exclusion across partitions.
- Fail-over through the ``FaultPlan`` seam: the standby is promoted and
  the healed fleet is bit-identical to a never-failed one; for fixed
  seeds and kill points, with and without a lost ack, no acknowledged
  write is lost.
- ``reshard`` (2 -> 3) moves exactly the ring's predicted ids with every
  leaf bit-identical (fp32 and int8); ``partition_slices`` splits the id
  space by owner; a tiered standby or new member refuses the row
  transfer with the engine's own ``ValueError``.
- A fleet mixing a JAX member and a port member over sockets routes alike
  from a router of either package, and its ``stats()`` merge.

No Hypothesis: every case is a fixed one.
"""
import numpy as np
import pytest

import repro.core as jcore
import repro_torch.core as tcore
from repro_torch.core import (FaultPlan, FaultyTransport, InProcessTransport,
                              KBPartitionDownError, KBRouter,
                              KnowledgeBankServer, PartitionMap)

N, D = 192, 8
ATOL_SCORES = 1e-5
TIMEOUT_S = 10.0


def _table(n=N, d=D, seed=0):
    return np.random.default_rng(seed).normal(size=(n, d)).astype(
        np.float32)


def _server(rows, **kw):
    return KnowledgeBankServer(rows, D, device="cpu", **kw)


def _fleet(parts, table, *, plan=None, standby_for=None, **kw):
    """P port servers filled from one global table and a router over
    them; ``plan`` wraps partition 0's transport in a ``FaultyTransport``,
    ``standby_for`` attaches a standby filled the same way."""
    pmap = PartitionMap(table.shape[0], parts)
    servers, transports = [], []
    for p in range(parts):
        s = _server(int(pmap.counts[p]), **kw)
        s.update(np.arange(int(pmap.counts[p])), table[pmap.global_ids(p)])
        servers.append(s)
        t = InProcessTransport(s, partition=f"{p}/{parts}")
        if plan is not None and p == 0:
            t = FaultyTransport(t, plan)
        transports.append(t)
    router = KBRouter(transports, pmap=pmap)
    if standby_for is not None:
        p = standby_for
        sb = _server(int(pmap.counts[p]), **kw)
        sb.update(np.arange(int(pmap.counts[p])), table[pmap.global_ids(p)])
        servers.append(sb)
        router.attach_standby(p, InProcessTransport(sb), fill=False)
    return pmap, servers, router


def _close(servers, router=None):
    if router is not None:
        router.close()
    for s in servers:
        s.close()


# ---------------------------------------------------------------------------
# the ring
# ---------------------------------------------------------------------------

GRID = [(n, p, 64) for n in (64, 100, 192, 300, 1000, 4096)
        for p in (1, 2, 3, 4)] + [(300, 3, 16), (1000, 5, 16), (50, 2, 8)]


@pytest.mark.parametrize("n,parts,vnodes", GRID)
def test_partition_map_equals_the_jax_ring(n, parts, vnodes):
    try:
        want = jcore.PartitionMap(n, parts, vnodes=vnodes)
    except ValueError as e:
        with pytest.raises(ValueError) as got:
            PartitionMap(n, parts, vnodes=vnodes)
        assert str(got.value) == str(e)
        return
    got = PartitionMap(n, parts, vnodes=vnodes)
    for leaf in ("owner", "local", "counts", "_points", "_point_owner"):
        a, b = getattr(got, leaf), getattr(want, leaf)
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    for p in range(parts):
        np.testing.assert_array_equal(got.global_ids(p), want.global_ids(p))
    ids = np.random.default_rng(n).integers(0, n, 17)
    np.testing.assert_array_equal(got.owner_of(ids), want.owner_of(ids))
    np.testing.assert_array_equal(got.to_local(ids), want.to_local(ids))


@pytest.mark.parametrize("parts", [1, 2, 3, 4])
def test_ids_below_vnodes_stay_on_partition_zero(parts):
    """ROADMAP Q3 item 1, kept so that mixed fleets route alike."""
    pm = PartitionMap(192, parts)
    assert (pm.owner[:64] == 0).all()
    np.testing.assert_array_equal(pm.owner,
                                  jcore.PartitionMap(192, parts).owner)


def test_a_ring_too_small_for_its_partitions_raises():
    with pytest.raises(ValueError, match="partition 1 owns 0 of 64 ids"):
        PartitionMap(64, 2)
    with pytest.raises(ValueError):
        PartitionMap(0, 1)
    with pytest.raises(ValueError, match="cannot be routed"):
        PartitionMap(100, 2).owner_of([100])


# ---------------------------------------------------------------------------
# the router against one server
# ---------------------------------------------------------------------------

def test_router_matches_one_server():
    table = _table()
    single = _server(N)
    single.update(np.arange(N), table)
    pmap, servers, router = _fleet(3, table)
    rng = np.random.default_rng(1)
    try:
        ids = rng.integers(0, N, (4, 6))
        np.testing.assert_array_equal(router.lookup(ids),
                                      single.lookup(ids))
        up_ids = rng.integers(0, N, 17)
        up_vals = rng.normal(size=(17, D)).astype(np.float32)
        for c in (router, single):
            c.update(up_ids, up_vals, src_step=2)
        g_ids = rng.integers(0, N, 9)
        g = rng.normal(size=(9, D)).astype(np.float32)
        for c in (router, single):
            c.lazy_grad(g_ids, g)
        np.testing.assert_array_equal(router.lookup(g_ids[:4]),
                                      single.lookup(g_ids[:4]))
        for c in (router, single):
            c.flush()
        np.testing.assert_array_equal(router.table_snapshot(),
                                      single.table_snapshot())
        q = rng.normal(size=(3, D)).astype(np.float32)
        s_scores, s_ids = single.nn_search(q, k=5)
        r_scores, r_ids = router.nn_search(q, k=5)
        np.testing.assert_array_equal(r_ids, s_ids)
        np.testing.assert_allclose(r_scores, s_scores, atol=ATOL_SCORES,
                                   rtol=0)
        st = router.stats()
        assert st["router"]["partitions"] == 3
        assert st["metrics"]["lookups"] == sum(
            s.metrics["lookups"] for s in servers)
        assert st["num_entries"] == N and st["storage"]["total_rows"] == N
    finally:
        _close(servers, router)
        single.close()


def test_router_exclude_ids_across_partitions():
    table = _table(seed=3)
    single = _server(N)
    single.update(np.arange(N), table)
    pmap, servers, router = _fleet(3, table)
    try:
        probe = np.array([int(pmap.global_ids(p)[0]) for p in range(3)])
        q = table[probe]
        _, top = router.nn_search(q, k=1)
        excl = np.stack([top[:, 0], probe], axis=1).astype(np.int32)
        s_scores, s_ids = single.nn_search(q, k=4, exclude_ids=excl)
        r_scores, r_ids = router.nn_search(q, k=4, exclude_ids=excl)
        np.testing.assert_array_equal(r_ids, s_ids)
        np.testing.assert_allclose(r_scores, s_scores, atol=ATOL_SCORES,
                                   rtol=0)
        for row, banned in zip(r_ids, excl):
            assert not np.isin(banned, row).any()
    finally:
        _close(servers, router)
        single.close()


def test_partition_slices_split_the_ids_by_owner():
    table = _table()
    pmap, servers, router = _fleet(3, table)
    try:
        slices = router.partition_slices()
        assert len(slices) == 3
        np.testing.assert_array_equal(np.sort(np.concatenate(slices)),
                                      np.arange(N))
        for p, sl in enumerate(slices):
            np.testing.assert_array_equal(sl, pmap.global_ids(p))
            before = router.router_metrics["single_partition_fastpath"]
            router.lookup(sl[:5])
            assert (router.router_metrics["single_partition_fastpath"]
                    == before + 1)
    finally:
        _close(servers, router)


def test_a_dead_partition_without_a_standby_fails_fast():
    table = _table()
    pmap, servers, router = _fleet(2, table)
    try:
        servers[1].close()
        ok = pmap.global_ids(0)[:5]
        np.testing.assert_array_equal(router.lookup(ok), table[ok])
        with pytest.raises(KBPartitionDownError) as ei:
            router.lookup(pmap.global_ids(1)[:5])
        assert ei.value.partition == 1
        assert "KBServerClosedError" in str(ei.value)
    finally:
        _close(servers, router)


# ---------------------------------------------------------------------------
# fail-over
# ---------------------------------------------------------------------------

def test_failover_promotes_the_standby_bit_identical():
    table = _table()
    _, ref_srvs, ref = _fleet(2, table)
    plan = FaultPlan(kill_after_requests=6)
    _, srvs, router = _fleet(2, table, plan=plan, standby_for=0)
    try:
        rng = np.random.default_rng(1)
        for _ in range(12):
            ids = rng.integers(0, N, 5)
            g = rng.normal(size=(5, D)).astype(np.float32)
            for r in (ref, router):
                r.lazy_grad(ids, g)
                r.lookup(ids, trainer_step=1)
        assert router.router_metrics["promotions"] == 1 and plan.faults >= 1
        np.testing.assert_array_equal(ref.table_snapshot(),
                                      router.table_snapshot())
        np.testing.assert_array_equal(ref.lookup(np.arange(N)),
                                      router.lookup(np.arange(N)))
        assert router.standby_status() == [False, False]
    finally:
        _close(ref_srvs, ref)
        _close(srvs, router)


@pytest.mark.parametrize("seed,kill_at,drop_ack", [
    (0, 0, False), (1, 5, False), (2, 9, True), (3, 14, True),
    (4, 20, False), (5, 24, True)])
def test_acknowledged_writes_survive_a_promotion(seed, kill_at, drop_ack):
    """A permanent kill at a fixed request, and optionally a lost ack (the
    primary executed, the response was dropped): the healed fleet equals
    a never-failed one bit for bit."""
    table = _table(seed=2)
    _, ref_srvs, ref = _fleet(2, table)
    drops = (kill_at - 3,) if (drop_ack and kill_at >= 3) else ()
    plan = FaultPlan(kill_after_requests=kill_at, drop_responses=drops)
    _, srvs, router = _fleet(2, table, plan=plan, standby_for=0)
    try:
        rng = np.random.default_rng(seed)
        for _ in range(16):
            kind = int(rng.integers(3))
            ids = rng.integers(0, N, int(rng.integers(1, 6)))
            if kind == 0:
                np.testing.assert_array_equal(
                    ref.lookup(ids, trainer_step=1),
                    router.lookup(ids, trainer_step=1))
            elif kind == 1:
                v = rng.normal(size=(ids.size, D)).astype(np.float32)
                ref.update(ids, v, src_step=2)
                router.update(ids, v, src_step=2)
            else:
                g = rng.normal(size=(ids.size, D)).astype(np.float32)
                ref.lazy_grad(ids, g)
                router.lazy_grad(ids, g)
        ref.flush()
        router.flush()
        np.testing.assert_array_equal(ref.table_snapshot(),
                                      router.table_snapshot())
        np.testing.assert_array_equal(ref.lookup(np.arange(N)),
                                      router.lookup(np.arange(N)))
    finally:
        _close(ref_srvs, ref)
        _close(srvs, router)


# ---------------------------------------------------------------------------
# resharding
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("storage", ["fp32", "int8"])
def test_reshard_moves_exactly_the_predicted_rows(storage):
    """2 -> 3: exactly the ids the ring moves, every leaf bit-identical
    (pending lazy gradients included), the logical bank unchanged; exact
    search over fp32 rows keeps its ids and its scores within 1e-5
    (ROADMAP Q3 item 2's decision for the CPU)."""
    table = _table(seed=7)
    pmap, srvs, router = _fleet(2, table, storage=storage)
    srv3 = None
    try:
        rng = np.random.default_rng(11)
        up = rng.integers(0, N, 64)
        router.update(up, rng.normal(size=(64, D)).astype(np.float32),
                      src_step=3)
        lg = rng.integers(0, N, 40)
        router.lazy_grad(lg, rng.normal(size=(40, D)).astype(np.float32))
        new_pmap = PartitionMap(N, 3)
        moved = np.flatnonzero(new_pmap.owner != pmap.owner)
        assert (new_pmap.owner[moved] == 2).all()
        pre = {}
        for p in range(2):
            sel = moved[pmap.owner[moved] == p]
            leaves = srvs[p].export_rows(pmap.local[sel])
            for j, g in enumerate(sel):
                pre[int(g)] = {k: np.asarray(v)[j] for k, v in leaves.items()}
        snap_before = router.table_snapshot()
        q = rng.normal(size=(4, D)).astype(np.float32)
        nn_before = router.nn_search(q, k=6)
        srv3 = _server(moved.size, storage=storage)
        res = router.reshard(InProcessTransport(srv3), chunk_rows=16)
        assert res == {"moved": moved.size, "dirty_recopied": 0,
                       "partitions": 3}
        post = srv3.export_rows(np.arange(moved.size))
        for j, g in enumerate(moved):
            for k in post:
                np.testing.assert_array_equal(post[k][j], pre[int(g)][k])
        np.testing.assert_array_equal(router.table_snapshot(), snap_before)
        nn_after = router.nn_search(q, k=6)
        if storage == "fp32":
            np.testing.assert_array_equal(nn_after[1], nn_before[1])
            np.testing.assert_allclose(nn_after[0], nn_before[0],
                                       atol=ATOL_SCORES, rtol=0)
        else:
            # int8 shortlists are chosen per member on quantized scores
            assert nn_after[1].shape == nn_before[1].shape
            assert ((nn_after[1] >= 0) & (nn_after[1] < N)).all()
        router.flush()
        assert router.stats()["router"]["reshards"] == 1
        with pytest.raises(ValueError, match="new member serves"):
            router.reshard(InProcessTransport(srv3))
    finally:
        _close(srvs + ([srv3] if srv3 else []), router)


def test_a_tiered_member_refuses_row_transfer():
    """Row export and import refuse tiered engines (PR 33, the JAX
    engine's refusal in the port's words), so attaching a tiered standby
    or resharding onto a tiered member fails with that ValueError, and
    the router keeps serving without a standby."""
    table = _table(seed=8)
    pmap, srvs, router = _fleet(2, table)
    rows0 = int(pmap.counts[0])
    tiered = _server(rows0, resident_rows=16)
    try:
        with pytest.raises(ValueError, match="tiered engines"):
            router.attach_standby(0, InProcessTransport(tiered))
        assert router.standby_status() == [False, False]
        moved = int(PartitionMap(N, 3).counts[2])
        grown = _server(moved, resident_rows=16)
        srvs.append(grown)
        with pytest.raises(ValueError, match="tiered engines"):
            router.reshard(InProcessTransport(grown))
        assert len(router.partition_slices()) == 2
        np.testing.assert_array_equal(router.lookup(np.arange(N)), table)
    finally:
        tiered.close()
        _close(srvs, router)


# ---------------------------------------------------------------------------
# a fleet of both packages
# ---------------------------------------------------------------------------

def test_a_mixed_fleet_routes_alike_and_merges_its_stats():
    """Member 0 a JAX server, member 1 a port server, each on its own
    socket; a router of each package over them gives the same rows and
    ids, and a fleet's stats merge with the port's extra keys."""
    table = _table(seed=5)
    pmap = PartitionMap(N, 2)
    js = jcore.KnowledgeBankServer(int(pmap.counts[0]), D)
    ps = _server(int(pmap.counts[1]))
    js.update(np.arange(int(pmap.counts[0])), table[pmap.global_ids(0)])
    ps.update(np.arange(int(pmap.counts[1])), table[pmap.global_ids(1)])
    jw = jcore.KBTransportServer(js, partition="0/2")
    pw = tcore.KBTransportServer(ps, partition="1/2")
    spec = f"127.0.0.1:{jw.port},127.0.0.1:{pw.port}"
    try:
        routers = [tcore.connect_kb(spec, connect_timeout_s=TIMEOUT_S),
                   jcore.connect_kb(spec, connect_timeout_s=TIMEOUT_S)]
        ids = np.random.default_rng(6).integers(0, N, 24)
        got = [r.lookup(ids) for r in routers]
        np.testing.assert_array_equal(got[0], got[1])
        np.testing.assert_allclose(got[0], table[ids], atol=1e-6)
        q = table[:3] + 0.05
        (s0, i0), (s1, i1) = [r.nn_search(q, k=4) for r in routers]
        np.testing.assert_array_equal(i0, i1)
        np.testing.assert_array_equal(s0, s1)
        for r in routers:
            st = r.stats()
            assert st["metrics"]["lookups"] >= 1
            assert st["storage"]["total_rows"] == N
            assert "device" in st["partitions"][1]
            assert "device" not in st["partitions"][0]
            r.close()
    finally:
        jw.close()
        pw.close()
        js.close()
        ps.close()
