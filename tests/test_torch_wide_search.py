"""The exact and IVF stage-2 search kernels at the trainer's width and
beyond: their planning on the CPU, and (marked ``cuda``, skipped without
a card) the kernels against their plain versions.

The exact search's 32 queries of a block ride its ring beside the bank's
rows at every D; the IVF pass keeps its queries in shared memory up to
~1.1-1.2k dims (by k) and past that carries their slice of each stage
through the ring (its streamed instance). So both take any D that meets
their alignment (D % 4 fp32, D % 16 int8), up to 16,384 and beyond.

Tolerances on the card: unit-norm rows (the pooled embeddings that the
trainer and the makers write) are held to scores within atol 1e-4 plus 8
fp32 ulps of the score; N(0, 1) rows of width D, whose scores sum D
products of either sign, to atol 1e-4 plus 2·6·√D·2^-24 times
Σ|q_d r_d|: two D-term fp32 sums taken in different orders, each within
λ·√D·u·Σ|x_d| of the exact sum but with probability below
2·D·exp(-λ²/2) (Higham and Mary's probabilistic rounding bound, λ = 6;
the worst case, 2·D·u·Σ|x_d|, would let a dropped 16-dim chunk pass at
D 8192). Ids are exact where the plain scores around them are more than
twice the bound apart; a repeated call is bit-identical. The file
imports no JAX:

    PYTHONPATH=src python -m pytest -m cuda tests/test_torch_wide_search.py
"""
import pytest
import torch

from repro_torch.kernels import ivf_stage2 as s2
from repro_torch.kernels import ops, ref
from repro_torch.kernels import nn_search as nns

WIDE = (2048, 4096, 8192, 16384)
ULPS8 = 8 * 2.0 ** -23
LAMBDA = 6.0


@pytest.mark.parametrize("k", [1, 9, 32, 128])
def test_nn_search_plans_every_dim(k):
    """The first pass's shared memory (partial_smem_bytes, which
    nn_search.cu mirrors) does not grow with D: one plan for every width,
    within the budget; a small bank takes smaller tiles."""
    for n_rows in (64, 2048, 8192, 100_003, 1_939_743):
        rows, stages = nns.tile_plan(k, n_rows)
        assert rows in nns.TILE_ROWS and stages == nns.MAX_STAGES
        assert nns.partial_smem_bytes(k, rows, stages) <= nns.SMEM_BUDGET
        assert rows == 64 or n_rows >= rows * nns.MIN_TILES
    assert nns.tile_plan(k, 2048) == (64, 4)
    assert nns.tile_plan(k, 128 * 256) == (256, 4)
    assert nns.tile_plan(k, 1_939_743) == (512, 4)


@pytest.mark.parametrize("dim", WIDE)
@pytest.mark.parametrize("int8", [False, True])
def test_stage2_plans_every_wide_dim(dim, int8):
    """smem_bytes and check_stage2 take every wide D: the streamed
    instance's shared memory does not grow with D and fits the budget for
    every k."""
    for k in (1, 8, 32, 128):
        assert s2.streams_queries(dim, k, int8)
        assert s2.smem_bytes(dim, k, 2, int8, True) <= s2.SMEM_BUDGET
        assert s2.smem_bytes(dim, k, 4, int8, True) == \
            s2.smem_bytes(128, k, 4, int8, True)
        s2.check_stage2("ivf_stage2", rows=64 * 8, dim=dim, C=64, k=k,
                        align=16 if int8 else 4, int8=int8,
                        pointers=[0, 256, 512])


def test_stage2_serve_width_keeps_resident_queries():
    """D 128 (the serve shapes) stays on the resident instance; the
    widest resident D of each kind, and the next aligned D streams."""
    for int8 in (False, True):
        for k in (8, 32, 128):
            assert not s2.streams_queries(128, k, int8)
    for int8, k, widest in ((False, 8, 1188), (False, 32, 1140),
                            (True, 8, 1104), (True, 32, 1056)):
        assert not s2.streams_queries(widest, k, int8)
        assert s2.streams_queries(widest + (16 if int8 else 4), k, int8)


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

def _require_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; chip_smoke.py runs these checks "
                    "on the card")
    return torch.device("cuda")


def _bound(q, bank, ids, scores, unit: bool):
    """Per-score tolerance (the module docstring's)."""
    if unit:
        return 1e-4 + ULPS8 * scores.abs()
    mag = torch.einsum("bd,bkd->bk", q.abs().double(),
                       bank[ids.clamp(min=0)].abs().double())
    return 1e-4 + 2 * LAMBDA * q.shape[1] ** 0.5 * 2.0 ** -24 * mag


def _check(gs, gi, ws, wi, k, q, bank, unit):
    """Scores within the bound; ids exact at each rank whose plain score
    is more than twice the bound from both neighbours'."""
    tol = _bound(q, bank, wi, ws.double(), unit)
    assert ((gs.double() - ws[:, :k].double()).abs() <= tol[:, :k]).all()
    w = ws.double()
    gap = w[:, :-1] - w[:, 1:] - 2 * torch.maximum(tol[:, :-1], tol[:, 1:])
    left = torch.cat([torch.full_like(gap[:, :1], float("inf")),
                      gap[:, :k - 1]], 1)
    ranks = (left > 0) & (gap[:, :k] > 0)
    assert int(ranks.sum()) > 0
    assert torch.equal(gi[ranks], wi[:, :k][ranks])


def _rows(n, d, dev, unit, seed):
    g = torch.Generator(device=dev).manual_seed(seed)
    x = torch.randn((n, d), generator=g, device=dev)
    return x / x.norm(dim=1, keepdim=True) if unit else x


@pytest.mark.cuda
@pytest.mark.parametrize("dim,n,unit,ks", [
    (4096, 2048, True, (9, 32)),      # the makers' search: 64 x 2048 x 4096
    (8192, 3000, False, (9, 32)),
    (1544, 5000, False, (9, 32, 128)),
    (16384, 700, False, (8,)),
])
def test_cuda_nn_search_wide_matches_plain(dim, n, unit, ks):
    dev = _require_card()
    bank = _rows(n, dim, dev, unit, 0)
    g = torch.Generator(device=dev).manual_seed(1)
    q = bank[torch.randint(0, n, (64,), generator=g, device=dev)] \
        + 0.01 * _rows(64, dim, dev, unit, 2)
    kern = ops.LAUNCHERS["nn_search"]
    for k in ks:
        gs, gi = kern(q, bank, k)
        ws, wi = ref.nn_search_ref(q, bank, k + 1)
        _check(gs, gi, ws, wi, k, q, bank, unit)
        again = kern(q, bank, k)
        assert torch.equal(again[0], gs) and torch.equal(again[1], gi)


@pytest.mark.cuda
@pytest.mark.parametrize("B", [32, 80])
@pytest.mark.parametrize("name", ["ivf_stage2", "ivf_stage2_q",
                                  "ivf_stage2_sharded",
                                  "ivf_stage2_sharded_q"])
def test_cuda_stage2_wide_matches_plain(name, B):
    """The four stage-2 entries at D 4096 on an index of 64 buckets (3
    shards of 64, sharded) over 6,144 unit-norm rows, B queries probing
    8 (80: three query tiles of 32, the last partial): scores and ids as
    the module docstring says (the int8 entries against their plain
    versions over the same codes)."""
    from repro_torch.core import ann_index
    from repro_torch.kernels.nn_search_ivf import ivf_probes, sharded_probes
    dev = _require_card()
    bank = _rows(6144, 4096, dev, True, 3)
    g = torch.Generator(device=dev).manual_seed(4)
    q = bank[torch.randint(0, 6144, (B,), generator=g, device=dev)] \
        + 0.01 * _rows(B, 4096, dev, True, 5)
    sharded, int8 = "sharded" in name, name.endswith("_q")
    if sharded:
        idx = ann_index.build_sharded_ivf_index(bank, 3, nlist=64)
        if int8:
            idx = ann_index.QuantizedShardedIVFIndex(idx)
        probes = sharded_probes(q, idx.centroids, 3, 8)
    else:
        idx = ann_index.build_ivf_index(bank, nlist=64)
        if int8:
            idx = ann_index.QuantizedIVFIndex(idx)
        probes = ivf_probes(q, idx.centroids, 8)
    rows = ((idx.packed_codes, idx.packed_scale, idx.packed_offset)
            if int8 else (idx.packed_vecs,))
    args = (*rows, idx.packed_ids, idx.bucket_occ, q, probes)
    k = 32 if int8 else 8
    kern, plain = ops.LAUNCHERS[name], getattr(ref, f"{name}_ref")
    gs, gi = kern(*args, k)
    ws, wi = plain(*args, k + 1)
    if sharded:
        gs, gi, ws, wi = (x.reshape(B * 3, -1) for x in (gs, gi, ws, wi))
    _check(gs, gi, ws, wi, k, None, None, True)
    again = kern(*args, k)
    assert torch.equal(again[0].reshape(gs.shape), gs)
    assert torch.equal(again[1].reshape(gi.shape), gi)
