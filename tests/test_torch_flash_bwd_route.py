"""The flash backward launcher's plumbing on the CPU, its device check and
its launch set aside: what it hands ``csrc/flash_attention_bwd.cu``.

The bf16 kernels read each 64-entry tile of D and of the log-sum-exp by
one 256-byte TMA copy, so for bf16 inputs the launcher passes both in
rows of SP = S rounded up to 128 entries, zeros past S (D written there by
the kernels' pre-pass, lse copied beside it); the fp32 kernels take D in
rows of S and no copy of lse. Every other argument is the input's: the
shapes, the masks, the soft cap and 1/sqrt(d). The outputs are fp32 in
the shapes of q, k and v. An off-boundary dout is refused before any
launch.
"""
import math

import pytest
import torch

from repro_torch.kernels import flash_attention as fa


def _stub(monkeypatch):
    calls = []
    monkeypatch.setattr(fa, "sm_count", lambda device: 132)
    monkeypatch.setattr(fa, "require_cuda", lambda *a: None)
    monkeypatch.setattr(fa, "launch", lambda *a: calls.append(a))
    return calls


@pytest.mark.parametrize("S, sp", [(1, 128), (128, 128), (129, 256),
                                   (333, 384), (2048, 2048)])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_bwd_launcher_passes_padded_stats_rows(S, sp, dtype, monkeypatch):
    calls = _stub(monkeypatch)
    B, H, KV, d = 2, 4, 2, 32
    q, dout, out = (torch.zeros((B, S, H, d), dtype=dtype) for _ in range(3))
    k, v = (torch.zeros((B, S, KV, d), dtype=dtype) for _ in range(2))
    lse = torch.zeros((B, H, S), dtype=torch.float32)
    dq, dk, dv = fa.flash_attention_bwd_cuda(q, k, v, out, lse, dout,
                                             causal=True, window=7,
                                             softcap=3.0)
    assert len(calls) == 1
    name, symbol, argtypes, _, *args = calls[0]
    assert (name, symbol) == ("flash_attention_bwd",
                              "flash_attention_bwd_launch")
    assert len(args) == len(argtypes) == 24
    ptrs, ints, floats = args[:12], args[12:22], args[22:]
    bf16 = dtype == torch.bfloat16
    # the query heads' groups: on 132 SMs, at most ceil(S / 128) * 4 blocks
    # of one group, so the dK/dV kernel splits the 2 heads of a KV head
    groups = 2 if bf16 else 1
    assert ints == [B, S, sp if bf16 else S, H, KV, groups, d, int(bf16), 1,
                    7]
    assert floats == [3.0, 1.0 / math.sqrt(d)]
    assert ptrs[:6] == [t.data_ptr() for t in (q, k, v, out, dout, lse)]
    assert ptrs[8:11] == [t.data_ptr() for t in (dq, dk, dv)]
    assert (ptrs[7] is None) != bf16 and (ptrs[11] is None) != bf16
    for t, like in ((dq, q), (dk, k), (dv, v)):
        assert t.dtype == torch.float32 and t.shape == like.shape


def test_bwd_launcher_refuses_off_boundary_dout(monkeypatch):
    calls = _stub(monkeypatch)
    q = torch.zeros((1, 8, 2, 32), dtype=torch.bfloat16)
    kv = torch.zeros((1, 8, 2, 32), dtype=torch.bfloat16)
    lse = torch.zeros((1, 2, 8))
    flat = torch.zeros(q.numel() + 8, dtype=torch.bfloat16)
    dout = flat[1:1 + q.numel()].view(q.shape)
    with pytest.raises(ValueError, match="dout"):
        fa.flash_attention_bwd_cuda(q, kv, kv, q, lse, dout)
    assert not calls


@pytest.mark.parametrize("B, S, KV, G, want", [
    (4, 2048, 4, 8, 2),      # yi-6b's prefill shape: 256 blocks unsplit
    (2, 2048, 4, 8, 4),      # its training shape: 128 blocks unsplit
    (8, 2048, 4, 8, 1),
    (1, 64, 1, 1, 1),        # no GQA: nothing to split
    (1, 333, 2, 6, 6),       # the fewest divisor of G, else G
    (16, 4096, 8, 3, 1),
])
def test_heads_split_takes_the_fewest_groups_for_two_blocks_an_sm(
        B, S, KV, G, want):
    assert fa.heads_split(B, S, KV, G, 132) == want
