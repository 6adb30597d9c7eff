"""The port's data pipeline and checkpoints held against the JAX package's.

``repro_torch.data`` is a copy of the numpy-only ``repro.data``: the
batches must be equal bit for bit, every field, for two seeds. The
checkpoints must cross between the packages both ways: an npz that the
JAX ``DiskCheckpointStore`` writes loads in the port with the same keys
and the same arrays, and the reverse, bf16 leaves included (both widen
them to fp32 in the file, which narrows back exactly).
"""
import jax
import numpy as np
import pytest
import torch

from repro.checkpoint import DiskCheckpointStore as JaxStore
from repro.checkpoint.checkpointing import flatten_params as jax_flatten
from repro.configs import get_config as jax_config
from repro.data import PairedCorpus as JaxPaired
from repro.data import SyntheticGraphCorpus as JaxCorpus
from repro.models import build_model as jax_build
from repro_torch import convert
from repro_torch.checkpoint import (DiskCheckpointStore,
                                    MemoryCheckpointStore, flatten_params,
                                    unflatten_params)
from repro_torch.configs import get_config
from repro_torch.data import PairedCorpus, SyntheticGraphCorpus
from repro_torch.models import build_model
from repro_torch.tree import tree_items


@pytest.mark.parametrize("seed", [0, 5])
def test_graph_corpus_batches_equal_jax_bit_for_bit(seed):
    kw = dict(num_nodes=300, vocab_size=512, seq_len=17,
              neighbors_per_node=4, labeled_frac=0.3, label_noise=0.2,
              seed=seed)
    ours, ref = SyntheticGraphCorpus(**kw), JaxCorpus(**kw)
    np.testing.assert_array_equal(ours.neighbor_table, ref.neighbor_table)
    r1, r2 = np.random.default_rng(seed), np.random.default_rng(seed)
    for labeled_only in (False, True, False):
        a = ours.batch(r1, 8, labeled_only=labeled_only)
        b = ref.batch(r2, 8, labeled_only=labeled_only)
        assert sorted(a) == sorted(b)
        for k in b:
            assert a[k].dtype == b[k].dtype, k
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
        np.testing.assert_array_equal(
            ours.neighbor_tokens(a["neighbor_ids"]),
            ref.neighbor_tokens(b["neighbor_ids"]))


@pytest.mark.parametrize("seed", [0, 5])
def test_paired_corpus_batches_equal_jax_bit_for_bit(seed):
    ours, ref = PairedCorpus(seed=seed), JaxPaired(seed=seed)
    a = ours.batch(np.random.default_rng(seed), 6)
    b = ref.batch(np.random.default_rng(seed), 6)
    assert sorted(a) == sorted(b)
    for k in b:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


@pytest.fixture(scope="module")
def bf16_pair():
    """The reduced yi-6b in bf16 (its norms fp32), from JAX's init, and
    the port's copy of it."""
    cfg = jax_config("yi-6b").reduced().replace(dtype="bfloat16")
    jparams = jax_build(cfg).init(jax.random.key(0))
    tcfg = get_config("yi-6b").reduced().replace(dtype="bfloat16")
    tparams = convert.lm_params_from_numpy(jax_flatten(jparams), tcfg,
                                           device="cpu")
    return jparams, tparams, tcfg


def _same(port_tree, jax_tree):
    want = jax_flatten(jax_tree)
    got = flatten_params(port_tree)
    assert list(got) == list(want)          # keys, in JAX's order
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_flatten_is_jax_s_and_inverts(bf16_pair):
    jparams, tparams, _ = bf16_pair
    assert any(t.dtype == torch.bfloat16 for _, t in tree_items(tparams))
    _same(tparams, jparams)
    assert convert.lm_params_to_numpy(tparams).keys() == \
        flatten_params(tparams).keys()
    back = unflatten_params(tparams, flatten_params(tparams))
    for (k, a), (_, b) in zip(tree_items(back), tree_items(tparams)):
        assert a.dtype == b.dtype and torch.equal(a, b), k


def test_jax_checkpoint_loads_in_the_port(bf16_pair, tmp_path):
    jparams, _, tcfg = bf16_pair
    JaxStore(str(tmp_path), keep=2).save(7, jparams)
    template = build_model(tcfg).init(torch.Generator().manual_seed(3))
    store = DiskCheckpointStore(str(tmp_path), template=template)
    step, loaded = store.load_latest()
    assert step == 7
    _same(loaded, jparams)


def test_port_checkpoint_loads_in_jax(bf16_pair, tmp_path):
    jparams, tparams, _ = bf16_pair
    store = DiskCheckpointStore(str(tmp_path), keep=2)
    for s in (1, 2, 3):
        store.save(s, tparams)
    assert store.steps() == [2, 3]          # pruned past keep
    template = jax_build(jax_config("yi-6b").reduced().replace(
        dtype="bfloat16")).init(jax.random.key(9))
    step, loaded = JaxStore(str(tmp_path), template=template).load_latest()
    assert step == 3
    _same(tparams, loaded)
    with pytest.raises(ValueError, match="template"):
        DiskCheckpointStore(str(tmp_path)).load(3)


def test_memory_store_keeps_the_newest():
    store = MemoryCheckpointStore(keep=2)
    assert store.load_latest() == (None, None)
    for s in (1, 2, 3):
        store.save(s, {"w": torch.full((2,), float(s))})
    assert store.latest_step() == 3
    step, p = store.load_latest()
    assert step == 3 and float(p["w"][0]) == 3.0
    assert sorted(store.publish_times) == [1, 2, 3]
