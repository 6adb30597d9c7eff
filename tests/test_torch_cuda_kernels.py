"""Each CUDA kernel of the port against its plain PyTorch version, on a
card (the int8 lookup, the three IVF stage-2 kernels and flash attention
at the end). Every test is marked ``cuda`` and skips where no CUDA device
is present (it decides inside the test, so that every xdist worker
collects the same tests). The file imports no JAX, so it runs on a machine that
has only PyTorch:

    PYTHONPATH=src python -m pytest -m cuda tests/test_torch_cuda_kernels.py

Tolerances: ids exact on queries whose k-th and (k+1)-th plain scores are
more than 1e-4 apart; scores atol 1e-4 (sums of 128 products summed in
another order than the plain version's matmul); rows atol 1e-5 and state
leaves atol 1e-6 (each clip computed step by step as the plain version
does, its squares summed in another order). The IVF stage-2 kernels'
scores, at the score scale of a clustered bank of width 128 (hundreds),
are held to atol 1e-4 plus 8 fp32 ulps of the score, and their ids by
gaps of 1e-4 plus twice that. Flash attention outputs: fp32 atol 2e-5,
bf16 atol 2e-2 (tests/test_kernels.py's bounds; a bf16 output may round
one ulp the other way). The WKV recurrence's y and final state: atol 5e-5
(tests/test_kernels.py's bound) plus rtol 1e-5, since at the model's
ranges y reaches tens and its 64-term sums, and the state carried over
2048 steps, run in another order and with fused multiply-adds. The Mamba
scan's y and final state: the same bound (see its test).
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import ops, ref
from repro_torch.kernels.flash_attention import require_tma_strides
from repro_torch.kernels.nn_search import KMAX

RTOL = 8 * 2.0 ** -23     # 8 fp32 ulps of a score


def _require_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; chip_smoke.py runs these checks "
                    "on the card")
    return torch.device("cuda")


def _card_bank(dev, n=50_021, d=128):
    """(table, grad_sum, grad_cnt, grad_sqnorm) on the card: 30% of the
    rows with pending gradients, some past the outlier clip."""
    rng = np.random.default_rng(3)
    pending = rng.random(n) < 0.3
    cnt = np.where(pending, rng.integers(1, 4, n), 0).astype(np.float32)
    gsum = (0.1 * rng.standard_normal((n, d)) * cnt[:, None]).astype(
        np.float32)
    gsq = ((gsum.astype(np.float64) ** 2).sum(1) / np.maximum(cnt, 1)
           * rng.uniform(0.02, 2.0, n)).astype(np.float32)
    table = rng.standard_normal((n, d)).astype(np.float32)
    return [torch.from_numpy(a).to(dev) for a in (table, gsum, cnt, gsq)]


@pytest.mark.cuda
def test_cuda_fused_lookup_matches_plain():
    """Rows atol 1e-5, leaves atol 1e-6, versions exact, with and without
    the version bump."""
    dev = _require_card()
    base = _card_bank(dev)
    ids = torch.tensor([7, 50_020, 7, 3, 3, 1_000, -1, 12], device=dev)
    for version in (None, torch.zeros(base[0].shape[0], dtype=torch.int32,
                                      device=dev)):
        got = [t.clone() for t in base]
        want = [t.clone() for t in base]
        vk = None if version is None else version.clone()
        vp = None if version is None else version.clone()
        v1 = ops.LAUNCHERS["kb_fused_lookup"](*got, ids, lazy_lr=0.1,
                                              zmax=3.0, version=vk)
        v2 = ref.kb_fused_lookup_ref(*want, ids, lazy_lr=0.1, zmax=3.0,
                                     version=vp)
        torch.cuda.synchronize()
        assert (v1 - v2).abs().max().item() <= 1e-5
        assert torch.equal(v1[0], v1[2]) and not v1[6].any()
        for g, w in zip(got, want):
            assert (g - w).abs().max().item() <= 1e-6
        if version is not None:
            assert torch.equal(vk, vp) and int(vk.sum()) > 0


@pytest.mark.cuda
def test_cuda_gather_matches_plain():
    dev = _require_card()
    table = _card_bank(dev)[0]
    ids = torch.tensor([0, 50_020, -1, 5, 5, 50_021], device=dev)
    assert torch.equal(ops.LAUNCHERS["kb_gather"](table, ids),
                       ref.kb_gather_ref(table, ids))
    odd = torch.randn((100, 30), device=dev)      # D % 4 != 0: 4-byte copies
    ids = torch.tensor([99, 0, -1, 3], device=dev)
    assert torch.equal(ops.LAUNCHERS["kb_gather"](odd, ids),
                       ref.kb_gather_ref(odd, ids))


@pytest.mark.cuda
def test_cuda_lazy_apply_matches_plain():
    dev = _require_card()
    base = _card_bank(dev)
    got = [t.clone() for t in base]
    want = [t.clone() for t in base]
    ops.LAUNCHERS["lazy_apply"](*got, lazy_lr=0.1, zmax=3.0)
    ref.lazy_apply_ref(*want, lazy_lr=0.1, zmax=3.0)
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        assert (g - w).abs().max().item() <= 1e-6


@pytest.mark.cuda
@pytest.mark.parametrize("n,d", [
    (50_021, 128),      # no multiple of any tile
    (700, 128),         # less than one tile of 512 rows
    (4_099, 36),        # a last chunk of 4 of 16 dims
    (3_001, 8),         # rows narrower than one 16-dim chunk
])
@pytest.mark.parametrize("k", [1, 8, 64, KMAX])
def test_cuda_nn_search_matches_plain(k, n, d):
    dev = _require_card()
    table = _card_bank(dev, n, d)[0]
    q = torch.randn((37, d), device=dev,
                    generator=torch.Generator(device=dev).manual_seed(k))
    gs, gi = ops.LAUNCHERS["nn_search"](q, table, k)
    ws, wi = ref.nn_search_ref(q, table, k + 1)
    assert (gs - ws[:, :k]).abs().max().item() <= 1e-4
    decided = (ws[:, k - 1] - ws[:, k]) > 1e-4
    assert int(decided.sum()) > 0
    assert torch.equal(gi[decided], wi[decided, :k])


@pytest.mark.cuda
@pytest.mark.parametrize("d", [64, 128])
def test_cuda_nn_search_ties_go_to_the_lowest_id(d):
    """Every bank row three times over: a row and its copies score alike
    bit for bit, and come out lowest id first; a zero query ties every
    row and gets ids 0..k-1."""
    dev = _require_card()
    base = torch.randn((1000, d), device=dev)
    bank = torch.cat([base, base, base])
    q = torch.cat([torch.randn((3, d), device=dev),
                   torch.zeros((1, d), device=dev)])
    gs, gi = ops.LAUNCHERS["nn_search"](q, bank, 9)
    ws, _ = ref.nn_search_ref(q, bank, 9)
    assert (gs - ws).abs().max().item() <= 1e-4
    assert torch.equal(gi[3], torch.arange(9, device=dev))
    same = gs[:, 1:] == gs[:, :-1]
    assert bool((gi[:, 1:] > gi[:, :-1])[same].all())
    assert torch.equal(gi[:3].view(3, 3, 3) % 1000,
                       (gi[:3].view(3, 3, 3) % 1000)[:, :, :1].expand(
                           3, 3, 3))


def _card_int8_bank(dev, n=50_021, d=128):
    """(codes, scale, offset, grad_sum, grad_cnt, grad_sqnorm) on the card,
    the int8 twin of _card_bank, with two constant rows."""
    table, gsum, cnt, gsq = _card_bank(dev, n, d)
    table[1] = 2.5
    table[2] = 0.0
    from repro_torch.core.knowledge_bank import quantize_rows
    codes, s, o = quantize_rows(table)
    return [codes, s, o, gsum, cnt, gsq]


@pytest.mark.cuda
def test_cuda_fused_lookup_q_matches_plain():
    """Scale and offset rtol 1e-6 / atol 1e-6, rows atol 1e-5, codes equal
    but where a value (v - offset) / scale sits at a half-integer, caches
    zeroed alike; untouched rows unchanged; a repeated lookup of rows
    without pending gradients bit-identical."""
    dev = _require_card()
    base = _card_int8_bank(dev)
    ids = torch.tensor([7, 50_020, 7, 3, 3, 1_000, -1, 12, 1, 2],
                       device=dev)
    got = [t.clone() for t in base]
    want = [t.clone() for t in base]
    vk = torch.zeros(base[0].shape[0], dtype=torch.int32, device=dev)
    vp = vk.clone()
    v1 = ops.LAUNCHERS["kb_fused_lookup_q"](*got, ids, lazy_lr=0.1,
                                            zmax=3.0, version=vk)
    v2 = ref.kb_fused_lookup_q_ref(*want, ids, lazy_lr=0.1, zmax=3.0,
                                   version=vp)
    torch.cuda.synchronize()
    assert torch.equal(vk, vp) and int(vk.sum()) > 0
    assert (v1 - v2).abs().max().item() <= 1e-5
    assert torch.equal(v1[0], v1[2]) and not v1[6].any()
    assert torch.allclose(got[1], want[1], rtol=1e-6, atol=1e-6)
    assert torch.allclose(got[2], want[2], rtol=1e-6, atol=1e-6)
    assert (got[0].int() - want[0].int()).abs().max().item() <= 1
    for g, w in zip(got[3:], want[3:]):
        assert (g - w).abs().max().item() <= 1e-6
    again = ops.LAUNCHERS["kb_fused_lookup_q"](*got, ids, lazy_lr=0.1,
                                               zmax=3.0, version=vk)
    assert torch.equal(again[ids >= 0], v1[ids >= 0])
    assert torch.equal(vk, vp)          # nothing pending: no bump


def _lookup_batch(dev, n, b=1024, rows_per_block=8, seed=5):
    """b ids: distinct rows, a third of them repeated at a later slot of
    another block (rows_per_block slots a block), some several times, and
    two -1 paddings."""
    g = torch.Generator().manual_seed(seed)
    ids = torch.randperm(n, generator=g)[:b]
    for j in range(0, b - 2 * rows_per_block, 3):
        later = int(torch.randint(j + rows_per_block, b, (1,), generator=g))
        ids[later] = ids[j]
    ids[5] = ids[b - 1] = -1
    return ids.to(dev)


def _lookup_pair(int8, base, ids, reps=1):
    """The kernel and its plain version, ``reps`` times each on its own
    copy of the leaves and a zero version: (kernel leaves, kernel version,
    kernel rows of each rep, plain leaves, plain version, plain rows)."""
    name = "kb_fused_lookup_q" if int8 else "kb_fused_lookup"
    plain = ref.kb_fused_lookup_q_ref if int8 else ref.kb_fused_lookup_ref
    n = base[0].shape[0]
    out = []
    for fn in (ops.LAUNCHERS[name], plain):
        leaves = [t.clone() for t in base]
        version = torch.zeros(n, dtype=torch.int32, device=base[0].device)
        vals = [fn(*leaves, ids, lazy_lr=0.1, zmax=3.0, version=version)
                for _ in range(reps)]
        out += [leaves, version, vals]
    torch.cuda.synchronize()
    return out


def _assert_lookup_agrees(int8, base, ids, got, vk, vals_k, want, vp,
                          vals_p):
    """Rows atol 1e-5, fp32 leaves atol 1e-6, scale and offset rtol 1e-6,
    versions exact; int8 codes equal but where the plain version's value
    (v - offset) / scale lies within 1e-4 of a half-integer, where one may
    round the other way (the clip's sum of squares runs in another order),
    and there the row read back differs by that code's step, the scale;
    every occurrence of an id reads its owner's row bit for bit; untouched
    rows keep their bits."""
    tol = torch.full_like(vals_k, 1e-5)
    if int8:
        from repro_torch.core import knowledge_bank as kbm
        assert torch.allclose(got[1], want[1], rtol=1e-6, atol=1e-6)
        assert torch.allclose(got[2], want[2], rtol=1e-6, atol=1e-6)
        diff = (got[0].int() - want[0].int()).abs()
        assert diff.max().item() <= 1
        rows = torch.nonzero(diff.any(1)).squeeze(1)
        c, s, o, gsum, cnt, sq = (t[rows] for t in base)
        v = kbm.dequantize_rows(c, s, o) + kbm.pending_delta(
            gsum, cnt, sq, lazy_lr=0.1, zmax=3.0)
        x = ((v.double() - want[2][rows].double()[:, None])
             / want[1][rows].double()[:, None])
        near_half = ((x - torch.floor(x)) - 0.5).abs() < 1e-4
        assert not bool(((diff[rows] == 1) & ~near_half).any())
        safe = ids.clamp(min=0)
        tol += diff[safe] * want[1][safe][:, None]
    assert bool(((vals_k - vals_p).abs() <= tol).all())
    assert not vals_k[ids < 0].any()
    assert torch.equal(vk, vp)
    for g, w in zip(got[3 if int8 else 0:], want[3 if int8 else 0:]):
        assert (g - w).abs().max().item() <= 1e-6
    _, inverse = torch.unique(ids, return_inverse=True)
    pos = torch.arange(ids.numel(), device=ids.device)
    owner = torch.full_like(pos, ids.numel()).scatter_reduce(
        0, inverse, pos, "amin")
    assert torch.equal(vals_k, vals_k[owner[inverse]])
    touched = torch.zeros(base[0].shape[0], dtype=torch.bool,
                          device=ids.device)
    touched[ids[ids >= 0]] = True
    for g, b in zip(got, base):
        assert torch.equal(g[~touched], b[~touched])
    assert not vk[~touched].any()


@pytest.mark.cuda
@pytest.mark.parametrize("int8", [False, True])
@pytest.mark.parametrize("b, d", [(1024, 128), (1024, 16), (1024, 37),
                                  (40_000, 128)])
def test_cuda_fused_lookups_agree_across_blocks(int8, b, d):
    """A batch of 1024 ids in 128 blocks, duplicates owned by a warp of
    another block, at D 128 and 16 (16-byte accesses) and 37 (4-byte
    ones), and one of 40,000 ids, too many to stage in a block's shared
    memory (the dedupe scans read them in global memory): against the
    plain version with the version bump, and a second run from the same
    state bit-identical on every leaf."""
    from repro_torch import env
    dev = _require_card()
    base = (_card_int8_bank if int8 else _card_bank)(dev, d=d)
    assert env.stage_lookup_ids(b, d, env.fused_lookup_block(b, d)) == (
        b < 40_000)
    ids = _lookup_batch(dev, base[0].shape[0], b=b)
    got, vk, vals_k, want, vp, vals_p = _lookup_pair(int8, base, ids)
    _assert_lookup_agrees(int8, base, ids, got, vk, vals_k[0], want, vp,
                          vals_p[0])
    again, va, vals_a, *_ = _lookup_pair(int8, base, ids)
    assert torch.equal(vals_a[0], vals_k[0]) and torch.equal(va, vk)
    for a, g in zip(again, got):
        assert torch.equal(a, g)


@pytest.mark.cuda
@pytest.mark.parametrize("int8", [False, True])
def test_cuda_lookup_op_is_one_launch_without_a_host_sync(int8):
    """CudaBackend.lookup / lookup_q with ids on the card: one kernel
    launch, no host synchronisation (torch's sync debug mode raises on
    one), and the state the eager bump and the plain version give."""
    from repro_torch.core import knowledge_bank as kbm
    from repro_torch.core.kb_engine import CudaBackend
    dev = _require_card()
    base = (_card_int8_bank if int8 else _card_bank)(dev)
    n = base[0].shape[0]
    ids = _lookup_batch(dev, n, b=32)
    ids[ids < 0] = 11                   # the engine refuses -1 on the host
    table, rest = (base[0], base[3:]) if int8 else (base[0], base[1:])
    state = kbm.KBState(table.clone(), torch.zeros(n, dtype=torch.int32,
                                                   device=dev),
                        *(t.clone() for t in rest),
                        norm_ema=torch.zeros(n, device=dev),
                        step=torch.zeros((), dtype=torch.int32, device=dev))
    qs, qo = (base[1].clone(), base[2].clone()) if int8 else (None, None)
    bk = CudaBackend()
    torch.cuda.synchronize()
    before = ops.launch_counts()
    torch.cuda.set_sync_debug_mode("error")
    try:
        if int8:
            vals, state = bk.lookup_q(state, qs, qo, ids, lazy_lr=0.1,
                                      zmax=3.0)
        else:
            vals, state = bk.lookup(state, ids, lazy_lr=0.1, zmax=3.0)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    name = "kb_fused_lookup_q" if int8 else "kb_fused_lookup"
    assert ops.launch_counts() == {**before, name: before[name] + 1}
    _, _, _, want, vp, vals_p = _lookup_pair(int8, base, ids)
    leaves = ([state.table, qs, qo] if int8 else [state.table]) + [
        state.grad_sum, state.grad_cnt, state.grad_sqnorm]
    _assert_lookup_agrees(int8, base, ids, leaves, state.version, vals,
                          want, vp, vals_p[0])


def _card_index(dev, quantized, n=60_000, d=128, nlist=16):
    from repro_torch.core import ann_index
    table = torch.from_numpy(ann_index.clustered_bank(
        n, d, 40, seed=4, noise=0.5)).to(dev)
    idx = ann_index.build_ivf_index(table, nlist=nlist, iters=4)
    if quantized:
        idx = ann_index.QuantizedIVFIndex(idx)
    q = table[::1500][:37] + 0.01
    return table, idx, q


# (quantized, case) of the stage-2 tests: "nearest" probes each query's
# nearest buckets (37 queries: two query tiles); "all32" adds one bucket to
# every query's probes (32 queries of a tile in one bucket); "one" probes a
# bucket from one query alone; "ragged" empties the most probed bucket
# and cuts the fullest other one to a tile and one row (or one row fewer
# than it holds), probed by every other query; "codes" plants int8 rows
# whose codes reach -128 and 127, the ends of the kernel's code
# conversion, and rounds the queries to integers, so that every q . c is
# exact in any order and the conversion is held bit for bit; "zeros" makes
# the last 4 queries zero, as the engine pads a batch, so every row they
# probe ties at 0 and their lists must be the lowest ids, exactly.
STAGE2_CASES = ([(False, c) for c in ("nearest", "all32", "one", "ragged",
                                      "zeros")]
                + [(True, c) for c in ("nearest", "all32", "one", "ragged",
                                       "codes", "zeros")])


def _stage2_queries(case, q):
    """The queries of one stage-2 case: rounded to integers for "codes",
    the last 4 zeroed for "zeros"."""
    if case == "codes":
        return torch.round(q)
    if case == "zeros":
        return torch.cat([q[:-4], torch.zeros_like(q[-4:])])
    return q


def _stage2_case(case, q, probes, packed_ids, bucket_occ, args):
    """(probes, packed_ids, bucket_occ, row args) of one stage-2 case. The
    probes' first shard (the last axis of ``probes[:, 0]`` where they
    are per shard) names buckets 0 .. nb - 1 of the packed layout; the
    inputs are copied where a case changes them."""
    from repro_torch.kernels.ivf_stage2 import tile_rows
    probes = probes.clone()
    view = probes if probes.dim() == 2 else probes[:, 0]
    B, nprobe = view.shape
    nb = bucket_occ.shape[0] // (1 if probes.dim() == 2 else probes.shape[1])
    cap = packed_ids.shape[0] // bucket_occ.shape[0]

    def add(bucket, rows):              # bucket into these queries' probes
        for b in rows:
            if not bool((view[b] == bucket).any()):
                view[b, -1] = bucket

    if case == "all32":
        add(int(view[0, 0]), range(B))
    elif case == "one":
        rng = np.random.default_rng(5)
        for b in range(B):
            view[b] = torch.from_numpy(rng.choice(
                np.arange(1, nb), nprobe, replace=False).astype(np.int32))
        view[0, 0] = 0
    elif case == "ragged":
        packed_ids, bucket_occ = packed_ids.clone(), bucket_occ.clone()
        common = torch.bincount(view.reshape(-1).long(), minlength=nb)
        empty = int(torch.argmax(common))
        fullest = bucket_occ[:nb].clone()
        fullest[empty] = -1
        cut = int(torch.argmax(fullest))
        add(cut, range(0, B, 2))
        keep = min(tile_rows(len(args) == 3) + 1, int(bucket_occ[cut]) - 1)
        packed_ids[empty * cap:(empty + 1) * cap] = -1
        packed_ids[cut * cap + keep:(cut + 1) * cap] = -1
        bucket_occ[empty], bucket_occ[cut] = 0, keep
    elif case == "codes":
        codes = args[0].clone()
        x = int(view[0, 0])
        add(x, range(4))
        row = x * cap
        for j in range(4):              # rows near the top of queries 0-3
            codes[row + j] = torch.where(q[j] > 0, 127, -128).to(torch.int8)
        codes[row + 4], codes[row + 5] = -128, 127
        codes[row + 6, ::2], codes[row + 6, 1::2] = -128, 127
        args = (codes, *args[1:])
    return probes.contiguous(), packed_ids, bucket_occ, args


def _check_stage2(gs, gi, ws, wi, k):
    """Scores within atol 1e-4 plus 8 ulps of the score; the top-k ids the
    same set where the k-th and (k+1)-th plain scores are apart by more
    than 1e-4 plus twice that, and the same id at each rank whose plain
    score is that far from both neighbours' (nearer scores may swap: their
    sums are rounded in another order)."""
    assert ((gs - ws[:, :k]).abs() <= 1e-4 + RTOL * ws[:, :k].abs()).all()
    w = ws.double()
    near = 1e-4 + 2 * RTOL * torch.maximum(w[:, :-1].abs(), w[:, 1:].abs())
    gap = w[:, :-1] - w[:, 1:] - near       # > 0: apart
    sets = gap[:, k - 1] > 0
    assert int(sets.sum()) > 0
    assert torch.equal(torch.sort(gi[sets], 1).values,
                       torch.sort(wi[sets, :k], 1).values)
    left = torch.cat([torch.full_like(gap[:, :1], float("inf")),
                      gap[:, :k - 1]], 1)
    ranks = (left > 0) & (gap[:, :k] > 0)
    assert int(ranks.sum()) > 0
    assert torch.equal(gi[ranks], wi[:, :k][ranks])


@pytest.mark.cuda
@pytest.mark.parametrize("quantized,case", STAGE2_CASES)
@pytest.mark.parametrize("k", [1, 8, 32, 128])
def test_cuda_ivf_stage2_matches_plain(quantized, case, k):
    """The kernel against its plain version in each case of STAGE2_CASES,
    with _check_stage2's tolerances; a second identical call is
    bit-identical."""
    from repro_torch.kernels.nn_search_ivf import ivf_probes
    dev = _require_card()
    _, idx, q = _card_index(dev, quantized)
    q = _stage2_queries(case, q)
    if quantized:
        args = (idx.packed_codes, idx.packed_scale, idx.packed_offset)
        kern, plain = ops.LAUNCHERS["ivf_stage2_q"], ref.ivf_stage2_q_ref
    else:
        args = (idx.packed_vecs,)
        kern, plain = ops.LAUNCHERS["ivf_stage2"], ref.ivf_stage2_ref
    probes, ids, occ, args = _stage2_case(
        case, q, ivf_probes(q, idx.centroids, 4), idx.packed_ids,
        idx.bucket_occ, args)
    gs, gi = kern(*args, ids, occ, q, probes, k)
    ws, wi = plain(*args, ids, occ, q, probes, k + 1)
    _check_stage2(gs, gi, ws, wi, k)
    if case == "zeros":
        assert torch.equal(gs[-4:], ws[-4:, :k])
        assert torch.equal(gi[-4:], wi[-4:, :k])
    again = kern(*args, ids, occ, q, probes, k)
    assert torch.equal(again[0], gs) and torch.equal(again[1], gi)


@pytest.mark.cuda
def test_cuda_ivf_stage2_pads_short_lists_and_breaks_ties_low():
    """A bucket of three rows probed alone: k = 8 leaves five padding
    entries (-1e30, 2**31 - 1); duplicated rows score alike and come out
    lowest id first."""
    from repro_torch.core.ann_index import IVFIndex
    dev = _require_card()
    rows = torch.randn((3, 64), device=dev)
    vecs = torch.zeros((2 * 8, 64), device=dev)
    vecs[:3] = rows
    vecs[8:11] = rows                       # bucket 1: the same rows
    ids = torch.full((16,), -1, dtype=torch.int32, device=dev)
    ids[:3] = torch.tensor([5, 9, 2], dtype=torch.int32, device=dev)
    ids[8:11] = torch.tensor([1, 7, 3], dtype=torch.int32, device=dev)
    idx = IVFIndex(torch.zeros((2, 64), device=dev), vecs, ids, nlist=2,
                   bucket_cap=8, n_rows=12)
    q = torch.randn((2, 64), device=dev)
    one = torch.tensor([[0], [1]], dtype=torch.int32, device=dev)
    both = torch.tensor([[0, 1], [1, 0]], dtype=torch.int32, device=dev)
    for probes in (one, both):
        gs, gi = ops.LAUNCHERS["ivf_stage2"](vecs, idx.packed_ids,
                                             idx.bucket_occ, q, probes, 8)
        ws, wi = ref.ivf_stage2_ref(vecs, idx.packed_ids, idx.bucket_occ, q,
                                    probes, 8)
        assert torch.equal(gi, wi)
        assert (gs - ws).abs().max().item() <= 1e-4
    assert (gi[:, 6:] == 2 ** 31 - 1).all() and (gs[:, 6:] == -1e30).all()


@pytest.mark.cuda
def test_cuda_ivf_stage2_unwritten_slots_merge_as_padding():
    """A query that lists one bucket twice, or a bucket id outside
    [0, C), leaves a partial slot that no block writes: it must merge as
    padding, so the result is that of the valid, distinct probes alone."""
    dev = _require_card()
    _, idx, q = _card_index(dev, False, n=4000, d=64, nlist=8)
    q = q[:3]
    clean = torch.tensor([[0, 1], [2, 3], [4, 5]], dtype=torch.int32,
                         device=dev)
    odd = torch.tensor([[0, 1, 1], [2, 3, 99], [-7, 4, 5]],
                       dtype=torch.int32, device=dev)
    kern = ops.LAUNCHERS["ivf_stage2"]
    for k in (8, 32):
        ws, wi = kern(idx.packed_vecs, idx.packed_ids, idx.bucket_occ, q,
                      clean, k)
        gs, gi = kern(idx.packed_vecs, idx.packed_ids, idx.bucket_occ, q,
                      odd, k)
        assert torch.equal(gi, wi) and torch.equal(gs, ws)



@pytest.mark.cuda
def test_cuda_ivf_stage2_refuses_what_it_cannot_take():
    """k outside [1, 128], D % 4 (also at a wide D), a bucket capacity
    that is no multiple of 4 and packed ids off a 16-byte boundary are
    refused before any launch; queries too wide to sit in shared memory
    are taken (the streamed instance)."""
    dev = _require_card()
    kern = ops.LAUNCHERS["ivf_stage2"]

    def call(C=4, cap=8, D=64, k=8, ids_offset=0):
        vecs = torch.zeros((C * cap, D), device=dev)
        ids = torch.zeros(C * cap + ids_offset, dtype=torch.int32,
                          device=dev)[ids_offset:]
        occ = torch.full((C,), cap, dtype=torch.int32, device=dev)
        q = torch.zeros((2, D), device=dev)
        probes = torch.zeros((2, 1), dtype=torch.int32, device=dev)
        return kern(vecs, ids, occ, q, probes, k)

    call()
    for bad in (dict(k=0), dict(k=129), dict(D=66), dict(cap=6),
                dict(ids_offset=1), dict(D=2050, k=128)):
        with pytest.raises(ValueError):
            call(**bad)
    s, i = call(D=2048, k=128)
    assert s.shape == i.shape == (2, 128)


@pytest.mark.cuda
@pytest.mark.parametrize("quantized,case", STAGE2_CASES)
@pytest.mark.parametrize("k", [1, 8, 32, 128])
def test_cuda_ivf_stage2_sharded_matches_plain(quantized, case, k):
    """The sharded kernel (per-(query, shard) top-k) against its plain
    version on a 3-shard index in each case of STAGE2_CASES (applied to
    shard 0's buckets), with the stage-2 tolerances above; a second
    identical call is bit-identical; a query that lists a bucket twice in
    one shard, or a local id outside [0, nlist), gives the result of its
    valid, distinct probes alone."""
    from repro_torch.core import ann_index
    from repro_torch.kernels.nn_search_ivf import sharded_probes
    dev = _require_card()
    table = torch.from_numpy(ann_index.clustered_bank(
        60_000, 128, 40, seed=4, noise=0.5)).to(dev)
    idx = ann_index.build_sharded_ivf_index(table, 3, nlist=16, iters=4)
    if quantized:
        idx = ann_index.QuantizedShardedIVFIndex(idx)
        args = (idx.packed_codes, idx.packed_scale, idx.packed_offset)
        kern = ops.LAUNCHERS["ivf_stage2_sharded_q"]
        plain = ref.ivf_stage2_sharded_q_ref
    else:
        args = (idx.packed_vecs,)
        kern = ops.LAUNCHERS["ivf_stage2_sharded"]
        plain = ref.ivf_stage2_sharded_ref
    q = _stage2_queries(case, table[::1500][:37] + 0.01)
    probes, ids, occ, args = _stage2_case(
        case, q, sharded_probes(q, idx.centroids, 3, 4), idx.packed_ids,
        idx.bucket_occ, args)
    tail = (ids, occ, q)
    gs, gi = kern(*args, *tail, probes, k)
    ws, wi = plain(*args, *tail, probes, k + 1)
    assert gs.shape == gi.shape == (37, 3, k)
    again = kern(*args, *tail, probes, k)
    assert torch.equal(again[0], gs) and torch.equal(again[1], gi)
    _check_stage2(*(x.reshape(37 * 3, -1) for x in (gs, gi, ws, wi)), k)
    if case == "zeros":
        assert torch.equal(gs[-4:], ws[-4:, :, :k])
        assert torch.equal(gi[-4:], wi[-4:, :, :k])
    clean = probes[:3, :, :2].contiguous()
    dup, outside = clean[:, :, 1:], torch.full_like(clean[:, :, 1:], 16)
    which = (torch.arange(3, device=dev)[:, None]
             + torch.arange(3, device=dev)[None, :])[:, :, None] % 3
    extra = torch.where(which == 0, dup,
                        torch.where(which == 1, outside, -3 + 0 * dup))
    odd = torch.cat([extra, clean], 2).contiguous()
    for kk in (8, 32):
        ws, wi = kern(*args, *tail[:2], q[:3], clean, kk)
        gs, gi = kern(*args, *tail[:2], q[:3], odd, kk)
        assert torch.equal(gi, wi) and torch.equal(gs, ws)


FLASH_CASES = [  # (B, S, H, KV, d, causal, window, softcap)
    (2, 128, 2, 2, 64, True, 0, 0.0),
    (2, 256, 2, 2, 64, False, 0, 0.0),
    (2, 256, 2, 2, 64, True, 64, 0.0),
    (2, 256, 2, 2, 64, True, 0, 30.0),
    (1, 512, 2, 2, 64, True, 100, 20.0),
    (2, 200, 4, 2, 128, True, 0, 0.0),       # GQA, a ragged edge
    (1, 300, 8, 1, 32, False, 50, 0.0),      # MQA, window, not causal
    (1, 2048, 8, 2, 128, True, 0, 0.0),
    (2, 333, 16, 2, 128, True, 0, 0.0),      # S no multiple of 128, H/KV 8
    (2, 300, 4, 4, 64, False, 0, 0.0),       # not causal at d 64, ragged
    (1, 257, 16, 2, 32, False, 64, 0.0),     # d 32, window, H/KV 8
]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,atol", [(torch.float32, 2e-5),
                                        (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("case", FLASH_CASES)
def test_cuda_flash_attention_matches_plain(case, dtype, atol):
    dev = _require_card()
    B, S, H, KV, d, causal, window, softcap = case
    g = torch.Generator(device=dev).manual_seed(S + H)
    q, k, v = (torch.randn((B, S, n, d), generator=g, device=dev).to(dtype)
               for n in (H, KV, KV))
    kern = ops.LAUNCHERS["flash_attention"]
    before = kern.launches
    got = kern(q, k, v, causal=causal, window=window, softcap=softcap)
    want = ref.flash_attention_ref(q, k, v, causal=causal, window=window,
                                   softcap=softcap)
    torch.cuda.synchronize()
    assert kern.launches == before + 1
    assert got.dtype == dtype and got.shape == q.shape
    assert (got.float() - want.float()).abs().max().item() <= atol


# kimi-k2's head dim 112 and whisper's encoder on the card: the kernel
# against its plain version (chip_smoke.py phase 2 runs the full-width ones)
FLASH_ZOO_CASES = [  # (B, S, H, KV, d, causal, softcap)
    (1, 256, 4, 2, 112, True, 0.0),
    (2, 333, 8, 1, 112, True, 0.0),          # MQA, ragged
    (1, 512, 4, 2, 112, True, 30.0),
    (1, 300, 4, 4, 112, False, 0.0),
    (2, 1500, 6, 6, 64, False, 0.0),         # whisper's encoder
]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,atol", [(torch.float32, 2e-5),
                                        (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("case", FLASH_ZOO_CASES)
def test_cuda_flash_d112_and_encoder_match_plain(case, dtype, atol):
    dev = _require_card()
    B, S, H, KV, d, causal, softcap = case
    g = torch.Generator(device=dev).manual_seed(S + H)
    q, k, v = (torch.randn((B, S, n, d), generator=g, device=dev).to(dtype)
               for n in (H, KV, KV))
    kern = ops.LAUNCHERS["flash_attention"]
    before = kern.launches
    got = kern(q, k, v, causal=causal, softcap=softcap)
    want = ref.flash_attention_ref(q, k, v, causal=causal, softcap=softcap)
    torch.cuda.synchronize()
    assert kern.launches == before + 1
    assert got.dtype == dtype and got.shape == q.shape
    assert (got.float() - want.float()).abs().max().item() <= atol


def _grad_close(got, want, label, atol, rtol):
    """Each entry of ``got`` within atol plus rtol of the largest entry of
    ``want``."""
    got, want = got.detach().float(), want.detach().float()
    err = (got - want).abs()
    assert bool((err <= atol + rtol * want.abs().max()).all()), (
        f"{label}: max abs err {float(err.max())}, largest entry "
        f"{float(want.abs().max())}")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", [c for c in FLASH_ZOO_CASES if c[4] == 112])
def test_cuda_flash_d112_bwd_matches_plain(case, dtype):
    """The backward kernel at kimi-k2's head dim 112 against the plain
    backward on the forward's own output and log-sum-exp: atol 1e-4 plus
    1e-4 of the gradient's largest entry, two runs bit-identical; then
    the Function (one forward and one backward launch) against autograd
    of the plain forward: fp32 atol 1e-4 plus 1e-4 of the largest entry,
    bf16 gradients atol 2e-2 plus 2e-2 of the entry (the bf16 forward's
    bound; tests/test_torch_backward_cuda.py's)."""
    dev = _require_card()
    B, S, H, KV, d, causal, softcap = case
    g = torch.Generator(device=dev).manual_seed(S + H)
    q, k, v, dout = (torch.randn((B, S, n, d), generator=g,
                                 device=dev).to(dtype)
                     for n in (H, KV, KV, H))
    kw = dict(causal=causal, softcap=softcap)
    fwd = ops.LAUNCHERS["flash_attention"]
    bwd = ops.LAUNCHERS["flash_attention_bwd"]
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    f0, b0 = fwd.launches, bwd.launches
    out = fwd(*leaves, **kw)
    _, _, _, o_saved, lse = out.grad_fn.saved_tensors
    out.backward(dout)
    torch.cuda.synchronize()
    assert (fwd.launches - f0, bwd.launches - b0) == (1, 1)
    want = ref.flash_attention_bwd_ref(q, k, v, o_saved, lse, dout, **kw)
    got = bwd(q, k, v, o_saved, lse, dout, **kw)
    again = bwd(q, k, v, o_saved, lse, dout, **kw)
    for name, a, b, c in zip(("dq", "dk", "dv"), got, want, again):
        assert a.shape == b.shape and a.dtype == torch.float32
        _grad_close(a, b, f"d 112 {name}", 1e-4, 1e-4)
        assert torch.equal(a, c), f"d 112 {name} differs between two runs"
    plain = [t.clone().float().requires_grad_() for t in (q, k, v)]
    ref.flash_attention_ref(*plain, **kw).backward(dout.float())
    for name, a, b in zip(("dq", "dk", "dv"), leaves, plain):
        assert a.grad.dtype == dtype
        if dtype == torch.float32:
            _grad_close(a.grad, b.grad, f"d 112 {name} vs autograd", 1e-4,
                        1e-4)
        else:
            err = (a.grad.float() - b.grad).abs()
            assert bool((err <= 2e-2 + 2e-2 * b.grad.abs()).all()), (
                f"d 112 {name} vs autograd: max abs err {float(err.max())}")


@pytest.mark.cuda
def test_cuda_flash_attention_refuses_what_it_cannot_take():
    dev = _require_card()
    q = torch.randn((1, 64, 4, 64), device=dev)
    kv = torch.randn((1, 64, 2, 64), device=dev)
    with pytest.raises(ValueError, match="head dim"):
        ops.flash_attention(q[..., :48].contiguous(),
                            kv[..., :48].contiguous(), kv[..., :48]
                            .contiguous())
    with pytest.raises(ValueError, match="multiple"):
        ops.flash_attention(q[:, :, :3].contiguous(), kv, kv)
    with pytest.raises(ValueError, match="contiguous"):
        ops.flash_attention(q.transpose(1, 2), kv, kv)
    with pytest.raises(ValueError, match="fp32 or bf16"):
        ops.flash_attention(q.half(), kv.half(), kv.half())
    # the bf16 kernel's tensor maps take byte strides below 2**40: a
    # (B, S, 64, 128) bf16 tensor with S = 2**26 has a batch stride of 2**40
    require_tma_strides("q", 2 ** 26 - 1, 64, 128)
    with pytest.raises(ValueError, match="TMA"):
        require_tma_strides("q", 2 ** 26, 64, 128)


WKV_CASES = [  # (B, S, H, d, decays): the rwkv6-7b prefill's, then smaller
    (4, 2048, 64, 64, "model"),
    (2, 200, 4, 16, "model"),          # a ragged last chunk
    (3, 333, 8, 32, "model"),
    (1, 1000, 2, 64, "model"),
    (2, 1, 3, 32, "model"),            # one step
    (2, 2048, 4, 64, "extreme"),
    (1, 333, 3, 32, "extreme"),
]


def wkv_inputs(B, S, H, d, dtype, dev, seed=0, decays="model"):
    """r, k, v N(0, 1) in ``dtype``, u 0.1 N(0, 1) in fp32 and w
    = exp(-exp(dec)): with ``decays="model"`` dec = N(-2, 0.5) per entry,
    the rwkv6 model's ranges (dec_0 = -2 plus a low-rank term; the
    projections of a normed input); with ``"extreme"`` dec = N(0, 2) per
    (h, i), the same at every step, so that w runs from 0 (underflowed) to
    ~0.9997 and the state of the rows with w near 1 grows over thousands
    of steps."""
    g = torch.Generator(device=dev).manual_seed(seed)
    r, k, v = (torch.randn((B, S, H, d), generator=g, device=dev).to(dtype)
               for _ in range(3))
    if decays == "model":
        w = torch.exp(-torch.exp(-2.0 + 0.5 * torch.randn(
            (B, S, H, d), generator=g, device=dev)))
    else:
        dec = 2.0 * torch.randn((H, d), generator=g, device=dev)
        w = torch.exp(-torch.exp(dec)).expand(B, S, H, d).contiguous()
    u = 0.1 * torch.randn((H, d), generator=g, device=dev)
    return r, k, v, w, u


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", WKV_CASES)
def test_cuda_rwkv_wkv_matches_plain(case, dtype):
    dev = _require_card()
    *shape, decays = case
    args = wkv_inputs(*shape, dtype, dev, seed=sum(shape), decays=decays)
    kern = ops.LAUNCHERS["rwkv_wkv"]
    before = kern.launches
    y, s_fin = kern(*args)
    want_y, want_s = ref.rwkv_wkv_ref(*args)
    torch.cuda.synchronize()
    assert kern.launches == before + 1
    B, S, H, d = shape
    assert y.dtype == s_fin.dtype == torch.float32
    assert y.shape == (B, S, H, d) and s_fin.shape == (B, H, d, d)
    for got, want in ((y, want_y), (s_fin, want_s)):
        assert bool(((got - want).abs() <= 5e-5 + 1e-5 * want.abs()).all())


@pytest.mark.cuda
def test_cuda_rwkv_wkv_refuses_what_it_cannot_take():
    dev = _require_card()
    r, k, v, w, u = wkv_inputs(1, 8, 2, 32, torch.float32, dev)
    with pytest.raises(ValueError, match="head dim"):
        ops.rwkv_wkv(*wkv_inputs(1, 8, 2, 128, torch.float32, dev))
    with pytest.raises(ValueError, match="float32"):
        ops.rwkv_wkv(r, k, v, w.bfloat16(), u)
    with pytest.raises(ValueError, match="contiguous"):
        ops.rwkv_wkv(r.transpose(1, 2).contiguous().transpose(1, 2), k, v,
                     w, u)
    with pytest.raises(ValueError, match="fp32 or bf16"):
        ops.rwkv_wkv(r.half(), k.half(), v.half(), w, u)


MAMBA_CASES = [  # (B, S, di, ds, x dtype, A): the jamba prefill's, smaller
    (4, 2048, 16384, 16, torch.bfloat16, "init"),
    (2, 333, 256, 16, torch.float32, "init"),    # S no multiple of the chunk
    (3, 100, 200, 8, torch.bfloat16, "init"),    # di no multiple of the block
    (2, 1, 128, 32, torch.float32, "init"),      # one step
    (1, 64, 40, 4, torch.float32, "init"),
    (4, 2048, 16384, 16, torch.bfloat16, "trained"),
    (2, 333, 256, 16, torch.bfloat16, "trained"),
    (2, 50, 37, 8, torch.float32, "trained"),    # di no multiple of 8
]


def mamba_inputs(B, S, di, ds, dtype, dev, seed=0, A_kind="init"):
    """x N(0, 1) in ``dtype``, B and C N(0, 1), all but x fp32. With
    ``A_kind="init"`` delta = softplus(N(-4.6, 1)) (the model's dt_bias
    plus a projection) and A = -(1 .. ds) on every channel (the model's
    init); with ``"trained"`` delta = softplus(N(0, 1)) and a per-channel
    A = -exp(0.3 N(0, 1)), the ranges of tests/test_torch_jamba.py."""
    g = torch.Generator(device=dev).manual_seed(seed)
    mu = -4.6 if A_kind == "init" else 0.0
    delta = torch.nn.functional.softplus(
        mu + torch.randn((B, S, di), generator=g, device=dev))
    x = torch.randn((B, S, di), generator=g, device=dev).to(dtype)
    bm, cm = (torch.randn((B, S, ds), generator=g, device=dev)
              for _ in range(2))
    if A_kind == "init":
        A = -torch.arange(1, ds + 1, dtype=torch.float32,
                          device=dev).expand(di, ds).contiguous()
    else:
        A = -torch.exp(0.3 * torch.randn((di, ds), generator=g, device=dev))
    return delta, bm, cm, x, A


@pytest.mark.cuda
@pytest.mark.parametrize("case", MAMBA_CASES)
def test_cuda_mamba_scan_matches_plain(case):
    """y and the final state within 5e-5 plus 1e-5 of the value (WKV's
    bound): each step's multiply and add run as the plain version's in
    fp32, but with fused multiply-adds, the 16-state sum in another order
    and each exp as exp2 by ``ex2.approx`` (relative error at most
    2^-22); the decay keeps the state from growing those errors."""
    dev = _require_card()
    *shape, dtype, A_kind = case
    args = mamba_inputs(*shape, dtype, dev, seed=sum(shape), A_kind=A_kind)
    kern = ops.LAUNCHERS["mamba_scan"]
    before = kern.launches
    y, h_fin = kern(*args)
    want_y, want_h = ref.mamba_scan_ref(*args)
    torch.cuda.synchronize()
    assert kern.launches == before + 1
    B, S, di, ds = shape
    assert y.dtype == h_fin.dtype == torch.float32
    assert y.shape == (B, S, di) and h_fin.shape == (B, di, ds)
    for got, want in ((y, want_y), (h_fin, want_h)):
        assert bool(((got - want).abs() <= 5e-5 + 1e-5 * want.abs()).all())


@pytest.mark.cuda
def test_cuda_mamba_scan_refuses_what_it_cannot_take():
    dev = _require_card()
    delta, bm, cm, x, A = mamba_inputs(1, 8, 64, 16, torch.float32, dev)
    with pytest.raises(ValueError, match="state dim"):
        ops.mamba_scan(*mamba_inputs(1, 8, 64, 12, torch.float32, dev))
    with pytest.raises(ValueError, match="float32"):
        ops.mamba_scan(delta.bfloat16(), bm, cm, x, A)
    with pytest.raises(ValueError, match="contiguous"):
        ops.mamba_scan(delta, bm.transpose(1, 2).contiguous().transpose(
            1, 2), cm, x, A)
    with pytest.raises(ValueError, match="fp32 or bf16"):
        ops.mamba_scan(delta, bm, cm, x.half(), A)
