"""Tiered residency and row export in the port, held against the JAX
package on the CPU, on the same numpy inputs (tests/test_kb_quantized.py's
sizes: N 512, D 32, 96 resident slots, cold after 48 written rows).

Tolerances: slot maps, touch clocks, free lists, fault and spill counts,
cold-store ids, versions and int8 codes exact; lookups within 1e-5;
state leaves, scale, offset and cold records within 1e-6, absolute plus
relative (the norm EMAs of N(0, 1) gradients of width 32 reach ~40,
where one fp32 ulp is ~4e-6); nn ids exact
where the JAX scores around them are more than 1e-4 apart. The port's
tiered engine is held bit-identical to its untiered one, and exported
leaves bit-identical across the two packages.
"""
import functools

import numpy as np
import pytest
import torch

from repro.core import KBEngine as JaxEngine
from repro.core import KnowledgeBankServer as JaxServer
from repro.core.kb_storage import DiskColdStore as JaxDiskColdStore
from repro_torch.core import (DiskColdStore, MemoryColdStore,
                              make_cold_store)
from repro_torch.core.async_runtime import KnowledgeBankServer
from repro_torch.core.kb_engine import KBEngine, ShardedBackend
from repro_torch.launch import serve

N, D = 512, 32
RESIDENT, COLD_AFTER = 96, 48
WAVE = 64
ATOL_ROWS, ATOL_LEAF, ID_GAP = 1e-5, 1e-6, 1e-4
# (storage, lazy_update); int8 needs lazy updates
CONFIGS = [("fp32", True), ("fp32", False), ("int8", True)]
# rows of the last wave stay resident to the end; these are banned
EXCL = np.array([[N - 1, N - 3, -1]] * 4)


def stream_inputs(seed: int = 12):
    """Waves of writes over the whole id space, then the queries. Each
    wave: an update of WAVE rows (which evicts the oldest-touched rows),
    lazy gradients on half of them, and a lookup of 16 distinct rows of
    the earlier waves, which by then are all cold and fault back with
    their pending gradients, beside 8 draws (repeats among them) of the
    wave's own resident rows. (Faults of one size keep the JAX engine's
    eager scatters to one compile.)"""
    rng = np.random.default_rng(seed)
    waves = []
    for lo in range(0, N, WAVE):
        sel = np.arange(lo, lo + WAVE)
        cold = rng.choice(lo, 16, replace=False) if lo else sel[:16]
        waves.append((sel,
                      rng.standard_normal((WAVE, D)).astype(np.float32),
                      rng.standard_normal((WAVE // 2, D)).astype(np.float32),
                      np.concatenate([cold, rng.choice(sel, 8)])))
    return waves, rng.standard_normal((4, D)).astype(np.float32)


def tier_state(e) -> dict:
    return {"slot_of": e._slot_of.copy(), "slot_id": e._slot_id.copy(),
            "free": list(e._free_slots), "touch": e._touch.copy(),
            "gen": e._gen, "faults": e.tier_faults,
            "spills": e.tier_spills, "cold": sorted(e.cold_store.ids())}


def run_stream(e, tiered: bool = True, n_waves: int = N // WAVE) -> dict:
    """One op stream through an engine of either package. The snapshots
    are taken before the flush: a tiered flush applies the resident rows'
    pending gradients only (a cold row's apply when it faults in), so
    after it a tiered table differs from an untiered one by design."""
    waves, q = stream_inputs()
    out = {"lookups": [], "tier": []}
    for sel, vals, g, look in waves[:n_waves]:
        e.update(sel, vals)
        e.lazy_grad(sel[:WAVE // 2], g)
        out["lookups"].append(e.lookup(look))
        if tiered:
            out["tier"].append(tier_state(e))
    out["table"] = e.table_snapshot()
    out["version"] = e.version_snapshot()
    e.flush()
    out["flushed"] = e.table_snapshot()
    out["nn"] = e.nn_search(q, 5)
    out["nnx"] = e.nn_search(q, 5, exclude_ids=EXCL)
    return out


def jax_engine(storage, lazy_update, **kw):
    return JaxEngine(N, D, backend="dense", storage=storage,
                     lazy_update=lazy_update, **kw)


def port_engine(storage, lazy_update, backend="cuda", **kw):
    return KBEngine(N, D, backend=backend, storage=storage,
                    lazy_update=lazy_update, device="cpu", **kw)


TIER = dict(resident_rows=RESIDENT, cold_after_rows=COLD_AFTER)


@functools.lru_cache(maxsize=None)
def jax_run(storage, lazy_update):
    e = jax_engine(storage, lazy_update, **TIER)
    return e, run_stream(e)


def leaves_of(e, jax: bool) -> dict:
    """The engine's device slots' per-row leaves (and side-cars), numpy."""
    st = e.state
    out = {f: np.asarray(getattr(st, f)) if jax
           else getattr(st, f).numpy() for f in JaxEngine.ROW_LEAVES}
    if e._qscale is not None:
        out["scale"] = np.asarray(e._qscale) if jax else e._qscale.numpy()
        out["offset"] = (np.asarray(e._qoffset) if jax
                         else e._qoffset.numpy())
    return out


def assert_leaves_close(got: dict, want: dict, label: str) -> None:
    assert set(got) == set(want), label
    for f in want:
        a, b = np.asarray(got[f]), np.asarray(want[f])
        assert a.dtype == b.dtype and a.shape == b.shape, (label, f)
        if f == "version" or a.dtype == np.int8:
            np.testing.assert_array_equal(a, b, err_msg=f"{label} {f}")
        else:
            np.testing.assert_allclose(a, b, rtol=ATOL_LEAF,
                                       atol=ATOL_LEAF,
                                       err_msg=f"{label} {f}")


def assert_nn_decided(got, want, label: str) -> int:
    """Scores within 1e-4 and ids exact wherever the reference's scores
    around a rank are more than ID_GAP apart; returns that count."""
    (s_g, i_g), (s_w, i_w) = got, want
    fin = np.isfinite(s_w)
    assert np.array_equal(np.isfinite(s_g), fin), label
    np.testing.assert_allclose(s_g[fin], s_w[fin], atol=ID_GAP,
                               err_msg=label)
    np.testing.assert_array_equal(i_g[~fin], i_w[~fin], err_msg=label)
    with np.errstate(invalid="ignore"):     # -inf - -inf: no gap
        gap = np.nan_to_num(np.concatenate(
            [s_w[:, :-1] - s_w[:, 1:], np.full((len(s_w), 1), np.inf)], 1),
            nan=0.0)
    ok = (gap > ID_GAP) & (np.roll(gap, 1, 1) > ID_GAP)
    ok[:, 0] = gap[:, 0] > ID_GAP
    np.testing.assert_array_equal(i_g[ok], i_w[ok], err_msg=label)
    return int(ok.sum())


# ---------------------------------------------------------------------------
# parity with the JAX engine
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("backend", ["cuda", "dense"])
@pytest.mark.parametrize("storage,lazy_update", CONFIGS)
def test_tiered_engine_matches_jax(storage, lazy_update, backend):
    je, want = jax_run(storage, lazy_update)
    te = port_engine(storage, lazy_update, backend, **TIER)
    got = run_stream(te)
    # the bookkeeping: the same slots picked, faulted and spilled
    for step, (a, b) in enumerate(zip(got["tier"], want["tier"])):
        for key in b:
            np.testing.assert_array_equal(np.asarray(a[key]),
                                          np.asarray(b[key]),
                                          err_msg=f"step {step} {key}")
    assert want["tier"][-1]["spills"] > 0 and want["tier"][-1]["faults"] > 0
    for a, b in zip(got["lookups"], want["lookups"]):
        np.testing.assert_allclose(a, b, rtol=0, atol=ATOL_ROWS)
    assert_leaves_close(leaves_of(te, False), leaves_of(je, True), "slots")
    for g in je.cold_store.ids():
        assert_leaves_close(te.cold_store.get(g), je.cold_store.get(g),
                            f"cold row {g}")
    for key in ("table", "flushed"):
        np.testing.assert_allclose(got[key], want[key], rtol=0,
                                   atol=ATOL_ROWS, err_msg=key)
    np.testing.assert_array_equal(got["version"], want["version"])
    assert assert_nn_decided(got["nn"], want["nn"], "nn") > 0
    assert_nn_decided(got["nnx"], want["nnx"], "nn exclude")
    assert not np.isin(got["nnx"][1], EXCL[0, :2]).any()
    assert te.storage_stats() == je.storage_stats()


@pytest.mark.parametrize("storage,lazy_update", CONFIGS)
def test_tiered_is_bit_identical_to_untiered(storage, lazy_update):
    tiered = run_stream(port_engine(storage, lazy_update, **TIER))
    flat = run_stream(port_engine(storage, lazy_update), tiered=False)
    for a, b in zip(tiered["lookups"], flat["lookups"]):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(tiered["table"], flat["table"])
    np.testing.assert_array_equal(tiered["version"], flat["version"])


def test_tiered_nn_search_returns_global_ids():
    """tests/test_kb_quantized.py's case: the last wave is resident, its
    rows win their own queries, and the ids returned are global."""
    rng = np.random.default_rng(14)
    vals = rng.normal(size=(N, D)).astype(np.float32)
    results = []
    for e in (JaxEngine(N, D, backend="dense", resident_rows=96),
              KBEngine(N, D, resident_rows=96, device="cpu")):
        for lo in range(0, N, 64):
            sel = np.arange(lo, min(lo + 64, N))
            e.update(sel, vals[sel])
        hot = np.arange(N - 64, N)
        q = vals[hot[:4]]
        scores, ids = e.nn_search(q, 3)
        assert (ids[:, 0] == hot[:4]).all()
        np.testing.assert_allclose(scores[:, 0],
                                   (q * vals[hot[:4]]).sum(-1), rtol=1e-5)
        assert (ids >= -1).all() and (ids < N).all()
        results.append((scores, ids))
    assert_nn_decided(results[1], results[0], "global ids")


def test_entry_zmax_matches_jax():
    """An entry-side clip tighter than the apply-side one, against the JAX
    engine; it changes the result."""
    rng = np.random.default_rng(3)
    ids = np.array([1, 5, 1, 9, 5, 1])
    fill = rng.standard_normal((N, D)).astype(np.float32)
    grads = [rng.standard_normal((ids.size, D)).astype(np.float32)
             * np.array([1, 1, 40, 1, 1, 1], np.float32)[:, None]
             for _ in range(3)]
    outs = []
    for e in (JaxEngine(N, D, backend="dense", zmax=3.0, entry_zmax=0.5),
              KBEngine(N, D, zmax=3.0, entry_zmax=0.5, device="cpu"),
              KBEngine(N, D, zmax=3.0, device="cpu")):
        e.update(np.arange(N), fill)
        for g in grads:
            e.lazy_grad(ids, g)
        outs.append(e.lookup(ids))
    np.testing.assert_allclose(outs[1], outs[0], rtol=0, atol=ATOL_ROWS)
    assert np.abs(outs[2] - outs[0]).max() > 1e-3


@pytest.mark.parametrize("storage", ["fp32", "int8"])
def test_generator_draws_the_initial_table(storage):
    """``generator=`` is the port's ``key=``: N(0, 0.01^2) rows from the
    generator; an int8 engine quantizes the drawn table."""
    e = KBEngine(N, D, storage=storage,
                 generator=torch.Generator().manual_seed(5), device="cpu")
    want = torch.randn((N, D), generator=torch.Generator().manual_seed(5))
    want = want * 0.01
    got = torch.from_numpy(e.table_snapshot())
    if storage == "fp32":
        assert torch.equal(got, want)
    else:
        from repro_torch.core import knowledge_bank as tkb
        codes, s, o = tkb.quantize_rows(want)
        assert torch.equal(e.state.table, codes)
        assert torch.equal(e._qscale, s) and torch.equal(e._qoffset, o)
        assert torch.equal(got, tkb.dequantize_rows(codes, s, o))


# ---------------------------------------------------------------------------
# cold stores
# ---------------------------------------------------------------------------

def test_cold_store_implementations_agree(tmp_path):
    rec = {"table": np.arange(D, dtype=np.float32), "version": np.int32(7)}
    for store in (MemoryColdStore(), DiskColdStore(str(tmp_path))):
        assert store.get(3) is None and 3 not in store
        store.put(3, rec)
        assert 3 in store and len(store) == 1 and list(store.ids()) == [3]
        got = store.get(3)
        np.testing.assert_array_equal(got["table"], rec["table"])
        assert int(got["version"]) == 7
        assert store.bytes_stored() > 0
    assert isinstance(make_cold_store(None), MemoryColdStore)
    assert isinstance(make_cold_store(str(tmp_path)), DiskColdStore)


def test_tiered_disk_cold_store_round_trip(tmp_path):
    disk = port_engine("fp32", True, resident_rows=64, cold_after_rows=32,
                       cold_dir=str(tmp_path / "cold"))
    flat = port_engine("fp32", True)
    rng = np.random.default_rng(13)
    for lo in range(0, N, 48):
        sel = np.arange(lo, min(lo + 48, N))
        vals = rng.normal(size=(sel.size, D)).astype(np.float32)
        for e in (disk, flat):
            e.update(sel, vals)
    assert isinstance(disk.cold_store, DiskColdStore)
    assert len(disk.cold_store) > 0
    ids = rng.integers(0, N, 32)
    np.testing.assert_array_equal(disk.lookup(ids), flat.lookup(ids))
    assert disk.tier_faults > 0


@pytest.mark.parametrize("storage", ["fp32", "int8"])
def test_disk_tier_files_cross_packages(tmp_path, storage):
    """Rows the port spills to disk, the JAX store reads bit-identically
    (against the port's host-RAM twin); records of the JAX engine, written
    by the JAX store, a fresh port engine faults in from that directory
    bit-identically to the same records in its host-RAM store."""
    port_dir, jax_dir = str(tmp_path / "port"), str(tmp_path / "jax")
    on_disk = port_engine(storage, True, cold_dir=port_dir, **TIER)
    in_ram = port_engine(storage, True, **TIER)
    for e in (on_disk, in_ram):
        run_stream(e, n_waves=3)
    jstore = JaxDiskColdStore(port_dir)
    assert sorted(jstore.ids()) == sorted(in_ram.cold_store.ids())
    for g in in_ram.cold_store.ids():
        got, want = jstore.get(g), in_ram.cold_store.get(g)
        assert set(got) == set(want)
        for f in want:
            a, b = np.asarray(got[f]), np.asarray(want[f])
            assert a.dtype == b.dtype and a.shape == b.shape
            np.testing.assert_array_equal(a, b)
    je, _ = jax_run(storage, True)
    cold = [g for g in je.cold_store.ids() if je._slot_of[g] < 0]
    assert len(cold) > RESIDENT
    jwrite = JaxDiskColdStore(jax_dir)
    from_disk = port_engine(storage, True, cold_dir=jax_dir, **TIER)
    from_ram = port_engine(storage, True, **TIER)
    ids = np.array(cold[:RESIDENT])
    for g in ids.tolist():
        jwrite.put(g, je.cold_store.get(g))
        from_ram.cold_store.put(g, je.cold_store.get(g))
    np.testing.assert_array_equal(from_disk.lookup(ids),
                                  from_ram.lookup(ids))
    assert from_disk.tier_faults == from_ram.tier_faults == RESIDENT
    for f, a in leaves_of(from_ram, False).items():
        np.testing.assert_array_equal(leaves_of(from_disk, False)[f], a)


# ---------------------------------------------------------------------------
# refusals
# ---------------------------------------------------------------------------

def test_tiered_refusals_in_the_jax_order():
    with pytest.raises(ValueError, match="resident"):
        KBEngine(N, D, cold_after_rows=8, device="cpu")
    with pytest.raises(ValueError, match="single-device"):
        KBEngine(N, D, backend=ShardedBackend(4), resident_rows=64,
                 device="cpu")
    with pytest.raises(ValueError, match="generator=None"):
        KBEngine(N, D, resident_rows=64, generator=torch.Generator(),
                 device="cpu")
    for bad in (0, N + 1):
        with pytest.raises(ValueError, match="out of range"):
            KBEngine(N, D, resident_rows=bad, device="cpu")
    e = KBEngine(N, D, resident_rows=64, device="cpu")
    with pytest.raises(ValueError, match="slots"):
        e.update(np.arange(128), np.zeros((128, D), np.float32))
    assert e.tier_faults == e.tier_spills == 0 and len(e._free_slots) == 64
    with pytest.raises(ValueError, match="tiered"):
        e.load_state({})


def test_tiered_default_device_never_falls_back(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        KBEngine(N, D, resident_rows=64)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        KnowledgeBankServer(N, D, resident_rows=64, cold_after_rows=32)


# ---------------------------------------------------------------------------
# row export and import
# ---------------------------------------------------------------------------

def filled_pair(src, dst, storage):
    """Fill ``src`` (a server of either package) with rows and pending
    gradients; export every row; import into ``dst``; export again."""
    rng = np.random.default_rng(3)
    src.update(np.arange(32), rng.normal(size=(32, D)).astype(np.float32))
    src.lazy_grad(np.arange(0, 32, 2),
                  rng.normal(size=(16, D)).astype(np.float32))
    ids = np.arange(32)
    leaves = src.export_rows(ids)
    dst.import_rows(ids, leaves)
    return leaves, dst.export_rows(ids)


@pytest.mark.parametrize("storage", ["fp32", "int8"])
@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
def test_export_import_across_packages(storage, direction):
    jsrv = JaxServer(32, D, storage=storage, coalesce=False)
    tsrv = KnowledgeBankServer(32, D, storage=storage, device="cpu",
                               coalesce=False)
    src, dst = (jsrv, tsrv) if direction == "jax_to_port" else (tsrv, jsrv)
    try:
        leaves, back = filled_pair(src, dst, storage)
        want = set(JaxEngine.ROW_LEAVES) | (
            {"scale", "offset"} if storage == "int8" else set())
        assert set(leaves) == set(back) == want
        for f in want:
            a, b = np.asarray(back[f]), np.asarray(leaves[f])
            assert a.dtype == b.dtype and a.shape == b.shape, f
            np.testing.assert_array_equal(a, b, err_msg=f)
    finally:
        jsrv.close()
        tsrv.close()


@pytest.mark.parametrize("storage", ["fp32", "int8"])
def test_export_import_round_trip_between_port_servers(storage):
    src = KnowledgeBankServer(32, D, storage=storage, device="cpu")
    dst = KnowledgeBankServer(32, D, storage=storage, device="cpu")
    try:
        leaves, back = filled_pair(src, dst, storage)
        for f in leaves:
            np.testing.assert_array_equal(back[f], leaves[f], err_msg=f)
        assert dst.engine.total_write_rows == 32
        # the pending gradients moved: both flushed tables are equal
        src.flush()
        dst.flush()
        np.testing.assert_array_equal(src.table_snapshot(),
                                      dst.table_snapshot())
    finally:
        src.close()
        dst.close()


def test_import_refuses_a_leaf_set_mismatch_and_bad_ids():
    src = KnowledgeBankServer(8, D, device="cpu")
    dst = KnowledgeBankServer(8, D, storage="int8", device="cpu")
    try:
        leaves = src.export_rows(np.arange(8))
        with pytest.raises(ValueError, match="leaf set"):
            dst.import_rows(np.arange(8), leaves)
        with pytest.raises(ValueError, match="out of range"):
            src.export_rows(np.array([8]))
        with pytest.raises(ValueError, match="out of range"):
            src.import_rows(np.array([-1]), src.export_rows([0]))
    finally:
        src.close()
        dst.close()


def test_int8_import_drops_the_touched_masters():
    e = KBEngine(N, D, storage="int8", device="cpu")
    rows = np.random.default_rng(4).normal(size=(4, D)).astype(np.float32)
    e.update(np.arange(4), rows)
    assert set(e._masters) == {0, 1, 2, 3}
    e.import_rows([1, 2], e.export_rows([1, 2]))
    assert set(e._masters) == {0, 3}


def test_tiered_and_sharded_engines_refuse_row_export():
    for e in (KBEngine(N, D, resident_rows=64, device="cpu"),
              KBEngine(N, D, backend=ShardedBackend(4), device="cpu")):
        with pytest.raises(ValueError, match="export_rows"):
            e.export_rows([0])
        with pytest.raises(ValueError, match="import_rows"):
            e.import_rows([0], {})


# ---------------------------------------------------------------------------
# the launcher
# ---------------------------------------------------------------------------

def test_serve_tiered_on_the_cpu(capsys):
    res = serve.main(["--kb", "--device", "cpu", "--kb-entries", "300",
                      "--kb-dim", "16", "--gen", "4",
                      "--kb-resident-rows", "64", "--kb-cold-after", "32"])
    out = capsys.readouterr().out
    assert "resident=64/300 rows" in out
    st = res["engine"].storage_stats()
    assert st["resident_rows"] == 64 and st["cold_rows"] > 0
    assert st["tier_faults"] > 0 and st["tier_spills"] > 0
    assert f"tier faults/spills={st['tier_faults']}/" in out
    assert res["engine"].state.table.shape == (64, 16)
