"""Each CUDA kernel of the port against its plain PyTorch version, on a
card. Every test is marked ``cuda`` and skips where no CUDA device is
present (it decides inside the test, so that every xdist worker collects
the same tests). The file imports no JAX, so it runs on a machine that
has only PyTorch:

    PYTHONPATH=src python -m pytest -m cuda tests/test_torch_cuda_kernels.py

Tolerances: ids exact on queries whose k-th and (k+1)-th plain scores are
more than 1e-4 apart; scores atol 1e-4 (sums of 128 products summed in
another order than the plain version's matmul); rows atol 1e-5 and state
leaves atol 1e-6 (each clip computed step by step as the plain version
does, its squares summed in another order).
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import ops, ref
from repro_torch.kernels.nn_search import KMAX


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
    dev = _require_card()
    base = _card_bank(dev)
    ids = torch.tensor([7, 50_020, 7, 3, 3, 1_000, -1, 12], device=dev)
    got = [t.clone() for t in base]
    want = [t.clone() for t in base]
    v1 = ops.LAUNCHERS["kb_fused_lookup"](*got, ids, lazy_lr=0.1, zmax=3.0)
    v2 = ref.kb_fused_lookup_ref(*want, ids, lazy_lr=0.1, zmax=3.0)
    torch.cuda.synchronize()
    assert (v1 - v2).abs().max().item() <= 1e-5
    assert torch.equal(v1[0], v1[2]) and not v1[6].any()
    for g, w in zip(got, want):
        assert (g - w).abs().max().item() <= 1e-6


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
@pytest.mark.parametrize("k", [1, 8, 64, KMAX])
def test_cuda_nn_search_matches_plain(k):
    dev = _require_card()
    table = _card_bank(dev)[0]
    q = torch.randn((37, 128), device=dev,
                    generator=torch.Generator(device=dev).manual_seed(k))
    gs, gi = ops.LAUNCHERS["nn_search"](q, table, k)
    ws, wi = ref.nn_search_ref(q, table, k + 1)
    assert (gs - ws[:, :k]).abs().max().item() <= 1e-4
    decided = (ws[:, k - 1] - ws[:, k]) > 1e-4
    assert int(decided.sum()) > 0
    assert torch.equal(gi[decided], wi[decided, :k])


@pytest.mark.cuda
def test_cuda_nn_search_ties_go_to_the_lowest_id():
    """Every bank row three times over: a row and its copies score alike
    bit for bit, and come out lowest id first; a zero query ties every
    row and gets ids 0..k-1."""
    dev = _require_card()
    base = torch.randn((1000, 64), device=dev)
    bank = torch.cat([base, base, base])
    q = torch.cat([torch.randn((3, 64), device=dev),
                   torch.zeros((1, 64), device=dev)])
    gs, gi = ops.LAUNCHERS["nn_search"](q, bank, 9)
    ws, _ = ref.nn_search_ref(q, bank, 9)
    assert (gs - ws).abs().max().item() <= 1e-4
    assert torch.equal(gi[3], torch.arange(9, device=dev))
    same = gs[:, 1:] == gs[:, :-1]
    assert bool((gi[:, 1:] > gi[:, :-1])[same].all())
    assert torch.equal(gi[:3].view(3, 3, 3) % 1000,
                       (gi[:3].view(3, 3, 3) % 1000)[:, :, :1].expand(
                           3, 3, 3))
