"""The port's feature store, knowledge makers and maker runtime held
against the JAX package's on the CPU, and the runtime's lifecycle.

Both packages run the reduced yi-6b (2 layers, d 128, fp32) on JAX's
initial parameters carried across by ``convert``, the same
``SyntheticGraphCorpus`` (128 nodes, 4 clusters, 30% labeled, 30% label
noise) and the same numpy banks. The port's makers search through its
``cuda`` backend, whose kernel wrappers take their plain versions on CPU
tensors; JAX's through its dense backend.

Bounds (ROADMAP's Port conventions): ids, labels, counts and rows
written exactly; neighbour weights, search scores and bank rows written
from the model atol 1e-5 (the reduced LM's bound); confidences and the
feature store's weights otherwise atol 1e-6; labels exact where the
top-2 probabilities (or vote tallies) are more than 1e-4 apart; losses
of the trainer loop atol 1e-5 + rtol 1e-5.
"""
import os
import re
import socket
import subprocess
import sys
import time
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import MemoryCheckpointStore as JaxStore
from repro.checkpoint.checkpointing import flatten_params as jax_flatten
from repro.configs import get_config as jax_config
from repro.core import KnowledgeBankServer as JaxServer
from repro.core import MakerRuntime as JaxRuntime
from repro.core import knowledge_bank as jkbm
from repro.core import knowledge_maker as jkm
from repro.core.async_runtime import run_async_training as jax_run_async
from repro.core.kb_engine import make_kb_ops as jax_kb_ops
from repro.data import SyntheticGraphCorpus as JaxCorpus
from repro.models import build_model as jax_build
from repro.sharding.partition import DistContext
from repro_torch import convert
from repro_torch.checkpoint import MemoryCheckpointStore
from repro_torch.configs import get_config
from repro_torch.core import knowledge_bank as kbm
from repro_torch.core import knowledge_maker as km
from repro_torch.core.async_runtime import (KnowledgeBankServer,
                                            MakerRuntime, format_maker_stats,
                                            run_async_training)
from repro_torch.core.kb_engine import make_kb_ops
from repro_torch.data import SyntheticGraphCorpus
from repro_torch.launch import serve, train
from repro_torch.models import build_model
from repro_torch.models.model import LM

ROOT = Path(__file__).resolve().parents[1]
DIST = DistContext()
CORPUS = dict(num_nodes=128, seq_len=17, num_clusters=4,
              neighbors_per_node=4, labeled_frac=0.3, label_noise=0.3,
              seed=0)


@pytest.fixture(scope="module")
def pair():
    cfg = jax_config("yi-6b").reduced().replace(num_layers=2)
    jm = jax_build(cfg)
    jp = jm.init(jax.random.key(0))
    tcfg = get_config("yi-6b").reduced().replace(num_layers=2)
    flat = jax_flatten(jp)
    return dict(
        cfg=cfg, jm=jm, jp=jp, tcfg=tcfg, tm=build_model(tcfg), flat=flat,
        tp=convert.lm_params_from_numpy(flat, tcfg, device="cpu"),
        jcorpus=JaxCorpus(vocab_size=cfg.vocab_size, **CORPUS),
        corpus=SyntheticGraphCorpus(vocab_size=cfg.vocab_size, **CORPUS),
        jembed=jax.jit(jkm.make_embed_fn(jm, DIST)),
        tembed=km.make_embed_fn(build_model(tcfg)))


def _unit_rows(n, d, seed):
    x = np.random.default_rng(seed).standard_normal((n, d))
    return (x / np.linalg.norm(x, axis=1, keepdims=True)).astype(np.float32)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _fs_pair(n, k, seed=0):
    """The same feature store in both packages: some neighbours, some
    labels at random confidences."""
    rng = np.random.default_rng(seed)
    ids = rng.permutation(n)[:n // 2]
    nbr = rng.integers(-1, n, (ids.size, k)).astype(np.int32)
    w = rng.random((ids.size, k)).astype(np.float32)
    lab = rng.integers(0, 4, ids.size).astype(np.int32)
    conf = rng.random(ids.size).astype(np.float32)
    jfs = jkbm.feature_store_create(n, k)
    jfs = jkbm.fs_update_neighbors(jfs, jnp.asarray(ids), jnp.asarray(nbr),
                                   jnp.asarray(w))
    jfs = jkbm.fs_update_labels(jfs, jnp.asarray(ids), jnp.asarray(lab),
                                jnp.asarray(conf))
    tfs = kbm.feature_store_create(n, k, device="cpu")
    kbm.fs_update_neighbors(tfs, _t(ids), _t(nbr), _t(w))
    kbm.fs_update_labels(tfs, _t(ids), _t(lab), _t(conf))
    return jfs, tfs


def _assert_fs(jfs, tfs, w_atol=1e-6):
    np.testing.assert_array_equal(tfs.nbr_ids.numpy(), np.asarray(jfs.nbr_ids))
    np.testing.assert_array_equal(tfs.labels.numpy(), np.asarray(jfs.labels))
    np.testing.assert_allclose(tfs.nbr_weights.numpy(),
                               np.asarray(jfs.nbr_weights), rtol=0,
                               atol=w_atol)
    np.testing.assert_allclose(tfs.label_conf.numpy(),
                               np.asarray(jfs.label_conf), rtol=0,
                               atol=1e-6)


def _gap_ok(p):
    """Rows whose top-2 values are more than 1e-4 apart."""
    s = np.sort(np.asarray(p, np.float64), axis=-1)
    return s[:, -1] - s[:, -2] > 1e-4


# ---------------------------------------------------------------------------
# the feature store and the in-graph makers
# ---------------------------------------------------------------------------

def test_fs_ops_match_jax():
    """create, neighbour and gated label writes (a second round, half of
    it below the stored confidence), neighbour lookups."""
    n, k = 40, 6
    jfs, tfs = _fs_pair(n, k)
    rng = np.random.default_rng(9)
    ids = rng.permutation(n)[:24]
    lab = rng.integers(0, 4, ids.size).astype(np.int32)
    conf = rng.random(ids.size).astype(np.float32)
    jfs = jkbm.fs_update_labels(jfs, jnp.asarray(ids), jnp.asarray(lab),
                                jnp.asarray(conf))
    out = kbm.fs_update_labels(tfs, _t(ids), _t(lab), _t(conf))
    assert out is tfs
    _assert_fs(jfs, tfs)
    q = np.array([3, 0, 39, 17], np.int32)
    jn, jw = jkbm.fs_lookup_neighbors(jfs, jnp.asarray(q), 4)
    tn, tw = kbm.fs_lookup_neighbors(tfs, _t(q), 4)
    np.testing.assert_array_equal(tn.numpy(), np.asarray(jn))
    np.testing.assert_allclose(tw.numpy(), np.asarray(jw), rtol=0,
                               atol=1e-6)
    empty = kbm.feature_store_create(5, 3, device="cpu")
    assert (empty.nbr_ids == -1).all() and (empty.labels == -1).all()
    assert empty.nbr_weights.dtype == torch.float32


def test_label_mining_matches_jax(pair):
    """The in-graph label miner on the same tokens and class read-out."""
    w = np.random.default_rng(2).standard_normal(
        (pair["cfg"].d_model, 4)).astype(np.float32)
    ids = np.arange(8, dtype=np.int32) * 3
    toks = pair["corpus"].node_tokens(ids)[:, :-1]
    jfs, tfs = _fs_pair(128, 4)
    jstep = jkm.make_label_mining(pair["jm"], DIST, num_classes=4,
                                  conf_threshold=0.3)
    jfs, (jpred, jconf) = jstep(pair["jp"], jfs, jnp.asarray(ids),
                                jnp.asarray(toks),
                                lambda p, h, e: e @ jnp.asarray(w) * 20.0)
    tstep = km.make_label_mining(pair["tm"], num_classes=4,
                                 conf_threshold=0.3)
    tfs2, (tpred, tconf) = tstep(pair["tp"], tfs, _t(ids), _t(toks),
                                 lambda p, h, e: e @ _t(w) * 20.0)
    assert tfs2 is tfs
    emb = np.asarray(pair["jembed"](pair["jp"], jnp.asarray(toks)))
    probs = np.asarray(jax.nn.softmax(emb @ w * 20.0, -1))
    ok = _gap_ok(probs)
    assert ok.sum() >= 6
    np.testing.assert_array_equal(tpred.numpy()[ok], np.asarray(jpred)[ok])
    np.testing.assert_allclose(tconf.numpy(), np.asarray(jconf), rtol=0,
                               atol=1e-6)
    assert (np.asarray(jconf) > 0).any()
    _assert_fs(jfs, tfs)


@pytest.mark.parametrize("backend", ["cuda", "dense"])
def test_graph_agreement_and_vote_match_jax(backend):
    """The in-graph graph agreement (unlabeled rows zeroed, self
    excluded), and the vote alone with ``self_ids`` on random candidate
    sets, some with no labeled candidate."""
    n, d = 64, 16
    table = 3.0 * _unit_rows(n, d, 3)
    jfs, tfs = _fs_pair(n, 4, seed=4)
    q_ids = np.arange(0, 40, 5, dtype=np.int32)
    q = table[q_ids] + 0.05 * _unit_rows(q_ids.size, d, 5)
    jkb = jkbm.kb_create(n, d)._replace(table=jnp.asarray(table))
    tkb = kbm.kb_create(n, d, device="cpu")._replace(table=_t(table))
    jpred, jconf = jkm.graph_agreement_labels(
        jkb, jfs, jnp.asarray(q), jnp.asarray(q_ids), k=6, num_classes=4,
        kb_ops=jax_kb_ops(DIST))
    tpred, tconf = km.graph_agreement_labels(
        tkb, tfs, _t(q), _t(q_ids), k=6, num_classes=4,
        kb_ops=make_kb_ops(backend=backend))
    np.testing.assert_allclose(tconf.numpy(), np.asarray(jconf), rtol=0,
                               atol=1e-6)
    np.testing.assert_array_equal(tpred.numpy(), np.asarray(jpred))
    assert (np.asarray(jconf) > 0).any()
    np.testing.assert_array_equal(tkb.table.numpy(), table)  # untouched

    rng = np.random.default_rng(6)
    scores = rng.standard_normal((12, 5)).astype(np.float32)
    nids = rng.integers(0, 30, (12, 5)).astype(np.int32)
    labels = rng.integers(-1, 3, (12, 5)).astype(np.int32)
    labels[0] = -1                                   # nobody votes
    self_ids = nids[:, 2].copy()
    jpred, jconf = jkm.vote_agreement_labels(
        scores, nids, labels, num_classes=3, self_ids=self_ids)
    tpred, tconf = km.vote_agreement_labels(
        scores, nids, labels, num_classes=3, self_ids=self_ids)
    assert tconf[0] == 0 and np.isfinite(tconf.numpy()).all()
    np.testing.assert_allclose(tconf.numpy(), np.asarray(jconf), rtol=0,
                               atol=1e-6)
    assert tpred.dtype == torch.int32
    np.testing.assert_array_equal(tpred.numpy(), np.asarray(jpred))


@pytest.mark.parametrize("backend", ["cuda", "dense"])
def test_graph_builder_matches_jax(backend):
    n, d = 64, 16
    table = _unit_rows(n, d, 7)
    ids = np.array([1, 5, 9, 33, 60, 2], np.int32)
    jfs, tfs = _fs_pair(n, 4, seed=8)
    jkb = jkbm.kb_create(n, d)._replace(table=jnp.asarray(table))
    tkb = kbm.kb_create(n, d, device="cpu")._replace(table=_t(table))
    jfs = jkm.make_graph_builder(DIST, k=4, kb_ops=jax_kb_ops(DIST))(
        jkb, jfs, jnp.asarray(ids))
    out = km.make_graph_builder(k=4, kb_ops=make_kb_ops(backend=backend))(
        tkb, tfs, _t(ids))
    assert out is tfs
    _assert_fs(jfs, tfs, w_atol=1e-5)
    assert (tfs.nbr_ids[_t(ids).long()] != _t(ids)[:, None]).all()


# ---------------------------------------------------------------------------
# the maker runtime's steps, held against JAX's
# ---------------------------------------------------------------------------

def _runtimes(pair, bank):
    """Both packages' server, checkpoint store and runtime over ``bank``
    (every row written, source step 0)."""
    n, d = bank.shape
    js = JaxServer(n, d)
    ts = KnowledgeBankServer(n, d, device="cpu")
    js.update(np.arange(n), bank)
    ts.update(np.arange(n), bank)
    jc, tc = JaxStore(), MemoryCheckpointStore()
    jc.save(0, pair["jp"])
    tc.save(0, pair["tp"])
    jrt = JaxRuntime(js, pair["jcorpus"], ckpts=jc,
                     embed_fn=pair["jembed"])
    trt = MakerRuntime(ts, pair["corpus"], ckpts=tc,
                       embed_fn=pair["tembed"], device="cpu")
    return js, ts, jrt, trt


@pytest.mark.parametrize("kind", MakerRuntime.MAKER_KINDS)
def test_maker_steps_match_jax(pair, kind):
    """Each ``MakerRuntime._<kind>_step`` on both packages' runtimes from
    the same bank (the model's own embeddings of every node, as an
    embedding refresh leaves it), parameters and seeded feature store:
    rows written exactly, then the feature store and the bank."""
    corpus = pair["corpus"]
    bank = pair["tembed"](pair["tp"], _t(corpus.node_tokens(
        np.arange(corpus.num_nodes))[:, :-1])).numpy()
    js, ts, jrt, trt = _runtimes(pair, bank)
    try:
        for i, ids in enumerate((np.arange(16), np.arange(40, 56))):
            jrows = getattr(jrt, f"_{kind}_step")(pair["jp"], 0, ids)
            trows = getattr(trt, f"_{kind}_step")(pair["tp"], 0, ids)
            assert trows == jrows and trows > 0
            jfs, tfs = jrt.feature_store.snapshot(), \
                trt.feature_store.snapshot()
            if kind in ("label_mining", "graph_agreement"):
                np.testing.assert_allclose(
                    tfs.label_conf.numpy(), np.asarray(jfs.label_conf),
                    rtol=0, atol=1e-6)
                jl, tl = np.asarray(jfs.labels), tfs.labels.numpy()
                if kind == "label_mining":
                    emb = trt._embed(pair["tp"], ids)
                    cent = jrt._centroid_cache[1]
                    ok = _gap_ok(np.asarray(jax.nn.softmax(
                        emb @ cent.T * jrt.label_temp, -1)))
                    assert ok.sum() >= 12
                    keep = np.ones(128, bool)
                    keep[ids[~ok]] = False
                    np.testing.assert_array_equal(tl[keep], jl[keep])
                else:
                    np.testing.assert_array_equal(tl, jl)
            else:
                _assert_fs(jfs, tfs, w_atol=1e-5)
            np.testing.assert_allclose(ts.table_snapshot(),
                                       js.table_snapshot(), rtol=0,
                                       atol=1e-5)
        if kind == "label_mining":
            assert trt.centroid_cache_hits == jrt.centroid_cache_hits == 1
    finally:
        js.close()
        ts.close()


def test_run_async_training_without_makers_matches_jax(pair, monkeypatch):
    """Three steps of the trainer loop with the trainer's push, both
    packages from JAX's initial parameters (the port's ``LM.init``
    monkeypatched to return them): losses, graph losses and the bank."""
    kw = dict(steps=3, batch_size=4, use_makers=False, trainer_push=True,
              lr=2e-3, seed=0)
    jres = jax_run_async(pair["jm"], pair["jcorpus"], kb_backend="dense",
                         **kw)
    monkeypatch.setattr(LM, "init", lambda self, gen: convert.
                        lm_params_from_numpy(pair["flat"], pair["tcfg"],
                                             device="cpu"))
    tres = run_async_training(pair["tm"], pair["corpus"], device="cpu", **kw)
    np.testing.assert_allclose(tres.losses, jres.losses, rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(tres.reg_losses, jres.reg_losses, rtol=1e-5,
                               atol=1e-5)
    assert len(tres.step_times) == len(tres.loop_times) == 3
    assert tres.maker_refreshes == 0 and tres.maker_stats == {}
    np.testing.assert_allclose(tres.server.table_snapshot(),
                               jres.server.table_snapshot(), rtol=0,
                               atol=1e-5)
    assert tres.mean_staleness == pytest.approx(jres.mean_staleness)


# ---------------------------------------------------------------------------
# the runtime's lifecycle (twins of tests/test_maker_runtime.py)
# ---------------------------------------------------------------------------

def _wait_for(cond, timeout_s=60.0):
    deadline = time.time() + timeout_s
    while not cond():
        if time.time() > deadline:
            raise AssertionError("timeout waiting for maker condition")
        time.sleep(0.01)


def _filled_server(n=64, d=8):
    server = KnowledgeBankServer(n, d, device="cpu")
    server.update(np.arange(n), np.random.default_rng(0).normal(
        size=(n, d)).astype(np.float32))
    return server


def test_maker_pacing_and_shutdown():
    """min_period_s paces each job on its own; stop() joins promptly; the
    server's stats carry the runtime's counters."""
    corpus = SyntheticGraphCorpus(num_nodes=64, seq_len=9,
                                  neighbors_per_node=4)
    with _filled_server() as server:
        rt = MakerRuntime(server, corpus, builder_k=4, device="cpu")
        fast = rt.register("graph_builder", batch_size=8, name="fast")
        slow = rt.register("graph_builder", batch_size=8, name="slow",
                           min_period_s=0.25)
        rt.start()
        _wait_for(lambda: fast.steps >= 8)
        t0 = time.time()
        rt.stop()
        assert time.time() - t0 < 5.0
        assert not fast.is_alive() and not slow.is_alive()
        assert fast.steps > slow.steps
        stats = server.maker_stats
        assert stats["fast"]["maker_steps"] == fast.steps
        assert stats["slow"]["rows_written"] == slow.rows_written
        assert stats["fast"]["error"] is None
        assert server.stats()["maker_stats"]["fast"]["kind"] == \
            "graph_builder"
        lines = format_maker_stats(stats)
        assert re.fullmatch(r"maker fast: steps=\d+ rows_written=\d+ "
                            r"ckpt_version_lag=0 \(last=0, ckpt=0\)",
                            lines[0])
    assert server.num_entries == 64 and server.dim == 8


def test_ckpt_version_tagging_under_concurrent_trainer_writes(pair):
    """Maker writes carry the step of the checkpoint the maker loaded
    while a trainer thread writes other rows under its own newer steps;
    ckpt_version_lag is trainer_step less that step."""
    n = pair["corpus"].num_nodes
    with KnowledgeBankServer(n, pair["cfg"].d_model,
                             device="cpu") as server:
        ckpts = MemoryCheckpointStore()
        ckpts.save(0, pair["tp"])
        rt = MakerRuntime(server, pair["corpus"], ckpts=ckpts,
                          embed_fn=pair["tembed"], device="cpu")
        job = rt.register("embedding_refresh", batch_size=16,
                          node_slice=np.arange(64))
        rt.start()
        _wait_for(lambda: job.steps >= 2)
        ckpts.save(5, pair["tp"])
        rt.trainer_step = 7
        rng = np.random.default_rng(1)
        for s in range(7, 10):
            server.update(64 + rng.integers(0, 64, 8),
                          rng.normal(size=(8, pair["cfg"].d_model)),
                          src_step=s)
        before = job.steps
        _wait_for(lambda: job.steps >= before + 3)
        rt.stop()
        assert job.last_error is None
        assert set(job.ckpt_steps_used) <= {0, 5}
        assert job.last_lag == 2 and job.lag_sum > 0
        src = server._row_src_step
        assert set(np.unique(src[:64])) <= {-1, 0, 5}
        written = src[64:] >= 0
        assert set(np.unique(src[64:][written])) <= {7, 8, 9}
        # one cached copy for every job, re-read when the step moved
        assert rt.load_ckpt()[0] == 5


def test_idle_maker_backs_off_without_burning_steps():
    """Label mining with no labeled node idles at the back-off period."""
    corpus = SyntheticGraphCorpus(num_nodes=64, seq_len=9,
                                  neighbors_per_node=4)
    ckpts = MemoryCheckpointStore()
    ckpts.save(0, {})
    with KnowledgeBankServer(64, 8, device="cpu") as server:
        rt = MakerRuntime(server, corpus, ckpts=ckpts,
                          embed_fn=lambda p, t: np.zeros((t.shape[0], 8)),
                          seed_labels=False, device="cpu")
        job = rt.register("label_mining", batch_size=8)
        rt.start()
        time.sleep(0.3)
        rt.stop()
        assert job.steps == 0 and job.last_error is None


def test_graph_builder_narrower_than_store_width():
    """builder_k below the store's width pads with the missing marker;
    the node itself is excluded through the server's exclude_ids."""
    corpus = SyntheticGraphCorpus(num_nodes=64, seq_len=9,
                                  neighbors_per_node=8)
    with _filled_server() as server:
        rt = MakerRuntime(server, corpus, builder_k=4, device="cpu")
        job = rt.register("graph_builder", batch_size=8)
        rt.start()
        _wait_for(lambda: job.steps >= 2)
        rt.stop()
        assert job.last_error is None and job.errors == 0
        assert job.rows_written > 0
        fs = rt.feature_store.snapshot()
        written = fs.nbr_ids[job.nodes[:8]].numpy()
        assert (written[:, :4] >= 0).all()
        assert (written[:, 4:] == -1).all()
        assert (written[:, :4] != job.nodes[:8, None]).all()


def test_crashed_maker_steps_count_as_errors_not_steps():
    corpus = SyntheticGraphCorpus(num_nodes=64, seq_len=9,
                                  neighbors_per_node=4)
    ckpts = MemoryCheckpointStore()
    ckpts.save(0, {})

    def broken_embed(params, toks):
        raise RuntimeError("boom")

    with KnowledgeBankServer(64, 8, device="cpu") as server:
        rt = MakerRuntime(server, corpus, ckpts=ckpts,
                          embed_fn=broken_embed, device="cpu")
        job = rt.register("embedding_refresh", batch_size=8)
        rt.start()
        _wait_for(lambda: job.errors >= 3)
        rt.stop()
        assert job.steps == 0 and job.rows_written == 0
        s = server.maker_stats[job.name]
        assert s["errors"] >= 3 and "boom" in s["error"]
        assert "ERRORS=" in format_maker_stats(server.maker_stats)[0]


def test_label_mining_centroid_cache_invalidates_on_ckpt_change(pair):
    """The centroids are read back once per loaded checkpoint."""
    n = pair["corpus"].num_nodes
    with KnowledgeBankServer(n, pair["cfg"].d_model,
                             device="cpu") as server:
        server.update(np.arange(n), np.random.default_rng(0).normal(
            size=(n, pair["cfg"].d_model)).astype(np.float32))
        ckpts = MemoryCheckpointStore()
        ckpts.save(0, pair["tp"])
        rt = MakerRuntime(server, pair["corpus"], ckpts=ckpts,
                          embed_fn=pair["tembed"], device="cpu")
        rt._label_mining_step(pair["tp"], 0, np.arange(8))
        base = server.metrics["lookups"]
        assert base >= 1
        rt._label_mining_step(pair["tp"], 0, np.arange(8, 16))
        rt._label_mining_step(pair["tp"], 0, np.arange(16, 24))
        assert server.metrics["lookups"] == base
        assert rt.centroid_cache_hits == 2
        rt._label_mining_step(pair["tp"], 5, np.arange(24, 32))
        assert server.metrics["lookups"] == base + 1
        assert rt.centroid_cache_hits == 2


def test_short_run_with_every_maker(pair, monkeypatch):
    """run_async_training beside all four makers: every job steps, none
    fails, the checkpoints it publishes are copies, and the server
    carries the runtime's counters."""
    saved = []
    real_save = MemoryCheckpointStore.save

    def spy(self, step, params):
        saved.append(params)
        real_save(self, step, params)

    monkeypatch.setattr(MemoryCheckpointStore, "save", spy)
    res = run_async_training(
        pair["tm"], pair["corpus"], steps=8, batch_size=4,
        makers=list(MakerRuntime.MAKER_KINDS), maker_batch=16,
        ckpt_period=2, trainer_push=True, seed=0, device="cpu")
    assert len(res.losses) == 8 and np.isfinite(res.losses).all()
    assert set(res.maker_stats) == {f"{k}{i}" for i, k in
                                    enumerate(MakerRuntime.MAKER_KINDS)}
    for name, s in res.maker_stats.items():
        assert s["maker_steps"] > 0 and s["errors"] == 0, (name, s)
    assert res.maker_refreshes == sum(s["maker_steps"] for s in
                                      res.maker_stats.values())
    assert res.server.maker_stats.keys() == res.maker_stats.keys()
    leaf = res.final_params["embed"]["tok"]
    assert len(saved) == 5
    assert all(p["embed"]["tok"].data_ptr() != leaf.data_ptr()
               for p in saved)


# ---------------------------------------------------------------------------
# the launchers
# ---------------------------------------------------------------------------

def _no_card(code):
    return subprocess.run(
        [sys.executable, "-c", code], capture_output=True, text=True,
        timeout=120, env={**os.environ, "PYTHONPATH": str(ROOT / "src"),
                          "CUDA_VISIBLE_DEVICES": ""})


def test_train_makers_runs_on_the_cpu(capsys):
    out = train.main(["--device", "cpu", "--makers",
                      "label_mining,graph_agreement", "--steps", "4",
                      "--batch", "4", "--nodes", "128", "--seq", "16"])
    lines = capsys.readouterr().out.strip().splitlines()
    assert re.fullmatch(r"async CARLS: trainer \+ makers \['label_mining', "
                        r"'graph_agreement'\] \(kb backend: cuda\)",
                        lines[1])
    assert re.fullmatch(r"loss \d+\.\d{4} -> \d+\.\d{4} over 4 steps in "
                        r"\d+\.\ds; mean row staleness \d+\.\d\d trainer "
                        r"steps", lines[2])
    assert re.fullmatch(r"kb server: \d+ requests -> \d+ dispatches "
                        r"\(coalescing x\d+\.\d\)", lines[3])
    assert [ln.split(":")[0] for ln in lines[4:]] == [
        "maker label_mining0", "maker graph_agreement1"]
    res = out["result"]
    assert all(s["errors"] == 0 for s in res.maker_stats.values())
    # --kb-connect is ported: an endpoint where nothing listens fails as
    # the JAX launcher's connect_kb does (a port bound, then released)
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    with pytest.raises(ConnectionRefusedError):
        train.main(["--device", "cpu", "--makers", "graph_builder",
                    "--kb-connect", f"127.0.0.1:{port}"])


def test_serve_kb_makers_runs_on_the_cpu(capsys):
    res = serve.main(["--kb", "--device", "cpu", "--kb-entries", "300",
                      "--kb-dim", "16", "--gen", "20", "--kb-makers",
                      "graph_builder", "--kb-maker-period", "0.001"])
    lines = capsys.readouterr().out.strip().splitlines()
    assert lines[0].startswith("kb-serve backend=cuda search=exact")
    assert re.fullmatch(r"maker graph_builder0: steps=\d+ rows_written=\d+ "
                        r"ckpt_version_lag=0 \(last=0, ckpt=\S+\)", lines[2])
    s = res["maker_stats"]["graph_builder0"]
    assert s["errors"] == 0


def test_maker_modes_without_a_card_exit_with_the_no_cuda_error():
    for code in ("from repro_torch.launch.train import main; "
                 "main(['--steps', '1', '--makers', 'graph_builder'])",
                 "from repro_torch.launch.serve import main; "
                 "main(['--kb', '--kb-makers', 'graph_builder'])"):
        proc = _no_card(code)
        assert proc.returncode != 0
        assert "no CUDA device" in proc.stderr
        assert "maker " not in proc.stdout
