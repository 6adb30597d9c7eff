"""The three backward kernels (flash attention, the WKV recurrence, the
Mamba scan) on a card: each against its plain backward on the same inputs,
each autograd Function against ``torch.autograd`` of the plain forward,
and a repeated run bit-identical. Every test is marked ``cuda`` and skips
where no CUDA device is present (it decides inside the test, so that every
xdist worker collects the same tests). The file imports no JAX:

    PYTHONPATH=src python -m pytest -m cuda tests/test_torch_backward_cuda.py

Tolerances (gradients of O(1) inputs; the kernels sum in another order
than the plain versions, with fused multiply-adds):

- kernel against plain backward, same inputs (the forward's output and
  log-sum-exp or checkpoints): atol 1e-4 + rtol 1e-4 in fp32; the flash
  sums run over up to S keys, the recurrences' over S steps. The bf16
  inputs are widened to fp32 by both, so the same bound holds.
- at S >= LONG_S (cases added for the redesigned kernels), an entry can
  be a small difference of terms as large as the tensor's largest entry,
  each a sum over up to 2048 steps taken in another order: kernel against
  plain backward there holds atol 1e-4 + 1e-4 of the tensor's largest
  entry, chip_smoke.py's bound for the same comparison.
- Function against autograd of the plain forward: the fp32 bound above;
  with bf16 inputs the Function's forward output, and the gradients it
  returns, are rounded to bf16 (8 bits of mantissa): atol 2e-2 + rtol
  2e-2, the flash forward's bf16 bound.
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import mamba_scan, ops, ref, rwkv_wkv

ATOL = RTOL = 1e-4
ATOL_BF16 = RTOL_BF16 = 2e-2
LONG_S = 1024


def _require_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; chip_smoke.py runs these checks "
                    "on the card")
    return torch.device("cuda")


def _close(got, want, label, atol=ATOL, rtol=RTOL):
    got, want = got.detach().float().cpu(), want.detach().float().cpu()
    over = (got - want).abs() - rtol * want.abs() > atol
    assert not bool(over.any()), (
        f"{label}: {int(over.sum())} entries off, max abs err "
        f"{float((got - want).abs().max())}")


def _close_bwd(got, want, label, S):
    """A backward kernel against the plain backward: per entry, or, at
    S >= LONG_S, against the tensor's largest entry."""
    if S < LONG_S:
        return _close(got, want, label)
    scale = float(want.detach().float().abs().max())
    _close(got, want, label, atol=ATOL + RTOL * scale, rtol=0.0)


FLASH_CASES = [  # (B, S, H, KV, d, causal, window, softcap)
    (2, 200, 4, 2, 64, True, 0, 0.0),       # GQA
    (1, 333, 8, 2, 128, True, 100, 0.0),    # window, S ragged
    (2, 150, 4, 4, 32, True, 0, 20.0),      # soft cap
    (1, 257, 4, 1, 64, False, 64, 0.0),     # not causal, window
]


@pytest.mark.cuda
@pytest.mark.parametrize("case", FLASH_CASES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_flash_attention_bwd_matches_plain(case, dtype):
    dev = _require_card()
    B, S, H, KV, d, causal, window, softcap = case
    g = torch.Generator(device=dev).manual_seed(0)
    q, k, v = (torch.randn((B, S, n, d), generator=g, device=dev).to(dtype)
               for n in (H, KV, KV))
    dout = torch.randn((B, S, H, d), generator=g, device=dev).to(dtype)
    kw = dict(causal=causal, window=window, softcap=softcap)
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    out = ops.LAUNCHERS["flash_attention"](*leaves, **kw)
    # the kernel against the plain backward on the Function's own saved
    # output and log-sum-exp
    _, _, _, o_saved, lse = out.grad_fn.saved_tensors
    out.backward(dout)
    want = ref.flash_attention_bwd_ref(q, k, v, o_saved, lse, dout, **kw)
    got = ops.LAUNCHERS["flash_attention_bwd"](q, k, v, o_saved, lse, dout,
                                                **kw)
    again = ops.LAUNCHERS["flash_attention_bwd"](q, k, v, o_saved, lse,
                                                  dout, **kw)
    for name, a, b, c in zip(("dq", "dk", "dv"), got, want, again):
        _close(a, b, f"flash {name}")
        assert torch.equal(a, c), f"flash {name} differs between two runs"
    # the Function against autograd of the plain forward
    plain = [t.clone().float().requires_grad_() for t in (q, k, v)]
    ref.flash_attention_ref(*plain, **kw).backward(dout.float())
    tol = (ATOL, RTOL) if dtype == torch.float32 else (ATOL_BF16, RTOL_BF16)
    for name, a, b in zip(("dq", "dk", "dv"), leaves, plain):
        assert a.grad.dtype == dtype
        _close(a.grad, b.grad, f"flash {name} vs autograd", *tol)


WKV_CASES = [  # (B, S, H, d, dtype, decays)
    (2, 100, 4, 64, torch.float32, "mixed"),
    (3, 33, 2, 32, torch.bfloat16, "mixed"),
    (2, 1, 3, 16, torch.float32, "mixed"),   # one step
    (1, 7, 2, 64, torch.bfloat16, "mixed"),  # S < 16: one ragged chunk
    (2, 17, 2, 64, torch.float32, "mixed"),  # a full chunk and one step
    (1, 2048, 2, 64, torch.bfloat16, "extreme"),   # B H 2, long
    (2, 70, 2, 32, torch.float32, "extreme"),
]


def _wkv_decays(B, S, H, d, kind, g, dev):
    """"mixed": w in [0.5, 1) with every 7th step 0 (decays that vanish);
    "extreme": w = exp(-exp(2 N(0, 1))) per (h, i) at every step, from 0
    (underflowed) to ~0.9997, so rows with w near 1 keep their state over
    the whole sequence."""
    if kind == "mixed":
        w = 0.5 + 0.5 * torch.rand((B, S, H, d), generator=g, device=dev)
        w[:, ::7] = 0.0
        return w
    dec = 2.0 * torch.randn((H, d), generator=g, device=dev)
    return torch.exp(-torch.exp(dec)).expand(B, S, H, d).contiguous()


@pytest.mark.cuda
@pytest.mark.parametrize("case", WKV_CASES)
def test_cuda_rwkv_wkv_bwd_matches_plain(case):
    dev = _require_card()
    B, S, H, d, dtype, decays = case
    g = torch.Generator(device=dev).manual_seed(1)
    r, k, v = ((0.5 * torch.randn((B, S, H, d), generator=g,
                                  device=dev)).to(dtype) for _ in range(3))
    w = _wkv_decays(B, S, H, d, decays, g, dev)
    u = 0.1 * torch.randn((H, d), generator=g, device=dev)
    dy = torch.randn((B, S, H, d), generator=g, device=dev)
    ds = torch.randn((B, H, d, d), generator=g, device=dev)
    y, s_fin, ckpt = rwkv_wkv.rwkv_wkv_checkpoints(r, k, v, w, u)
    want = ref.rwkv_wkv_bwd_ref(r, k, v, w, u, dy, ds)
    got = ops.LAUNCHERS["rwkv_wkv_bwd"](r, k, v, w, u, ckpt, dy, ds)
    again = ops.LAUNCHERS["rwkv_wkv_bwd"](r, k, v, w, u, ckpt, dy, ds)
    for name, a, b, c in zip(("dr", "dk", "dv", "dw", "du"), got, want,
                             again):
        _close_bwd(a, b, f"wkv {name}", S)
        assert torch.equal(a, c), f"wkv {name} differs between two runs"
    leaves = [t.clone().requires_grad_() for t in (r, k, v, w, u)]
    y, s_fin = ops.LAUNCHERS["rwkv_wkv"](*leaves)
    ((y * dy).sum() + (s_fin * ds).sum()).backward()
    plain = [t.clone().float().requires_grad_() for t in (r, k, v, w, u)]
    yp, sp = ref.rwkv_wkv_ref(*plain)
    ((yp * dy).sum() + (sp * ds).sum()).backward()
    tol = (ATOL, RTOL) if dtype == torch.float32 else (ATOL_BF16, RTOL_BF16)
    for name, a, b in zip(("dr", "dk", "dv", "dw", "du"), leaves, plain):
        _close(a.grad, b.grad, f"wkv {name} vs autograd", *tol)


SCAN_CASES = [  # (B, S, di, ds, x dtype, delta)
    (2, 100, 256, 16, torch.float32, "small"),
    (2, 50, 37, 8, torch.bfloat16, "small"),     # di padded to 40
    (1, 1, 200, 16, torch.float32, "small"),     # one step, a ragged block
    (1, 7, 64, 16, torch.bfloat16, "small"),     # S < 16: one ragged chunk
    (2, 17, 136, 16, torch.float32, "large"),    # a chunk and a step; 128 + 8
    (1, 2048, 64, 16, torch.bfloat16, "small"),  # long
    (2, 40, 200, 4, torch.float32, "small"),     # ds 4: a lane a channel
    (1, 50, 72, 32, torch.bfloat16, "large"),    # ds 32: 64 channels a block
]


@pytest.mark.cuda
@pytest.mark.parametrize("case", SCAN_CASES)
def test_cuda_mamba_scan_bwd_matches_plain(case):
    dev = _require_card()
    B, S, di, ds, dtype, kind = case
    g = torch.Generator(device=dev).manual_seed(2)
    # "large": delta up to 5, so that a_t = exp(delta A) runs down to ~0
    scale = 0.1 if kind == "small" else 5.0
    delta = scale * torch.rand((B, S, di), generator=g, device=dev)
    bm, cm = (torch.randn((B, S, ds), generator=g, device=dev)
              for _ in range(2))
    x = torch.randn((B, S, di), generator=g, device=dev).to(dtype)
    A = -torch.exp(torch.randn((di, ds), generator=g, device=dev))
    dy = torch.randn((B, S, di), generator=g, device=dev)
    dh = torch.randn((B, di, ds), generator=g, device=dev)
    pd, px, pA = mamba_scan.pad_channels(delta, x, A)
    pad = pd.shape[-1] - di
    pdy = torch.nn.functional.pad(dy, (0, pad))
    pdh = torch.nn.functional.pad(dh, (0, 0, 0, pad))
    _, _, ckpt = mamba_scan.mamba_scan_checkpoints(pd, bm, cm, px, pA)
    want = ref.mamba_scan_bwd_ref(pd, bm, cm, px, pA, pdy, pdh)
    got = ops.LAUNCHERS["mamba_scan_bwd"](pd, bm, cm, px, pA, ckpt, pdy, pdh)
    again = ops.LAUNCHERS["mamba_scan_bwd"](pd, bm, cm, px, pA, ckpt, pdy,
                                            pdh)
    for name, a, b, c in zip(("ddelta", "dbm", "dcm", "dx", "dA"), got, want,
                             again):
        _close_bwd(a, b, f"scan {name}", S)
        assert torch.equal(a, c), f"scan {name} differs between two runs"
    leaves = [t.clone().requires_grad_() for t in (delta, bm, cm, x, A)]
    y, h = ops.LAUNCHERS["mamba_scan"](*leaves)
    ((y * dy).sum() + (h * dh).sum()).backward()
    plain = [t.clone().float().requires_grad_() for t in (delta, bm, cm, x, A)]
    yp, hp = ref.mamba_scan_ref(*plain)
    ((yp * dy).sum() + (hp * dh).sum()).backward()
    tol = (ATOL, RTOL) if dtype == torch.float32 else (ATOL_BF16, RTOL_BF16)
    for name, a, b in zip(("ddelta", "dbm", "dcm", "dx", "dA"), leaves,
                          plain):
        assert a.grad.shape == b.grad.shape
        _close(a.grad, b.grad, f"scan {name} vs autograd", *tol)


@pytest.mark.cuda
def test_cuda_backward_runs_on_the_forwards_stream():
    """A forward on a side stream: autograd runs the backward on that
    stream too, and the Function's check passes."""
    dev = _require_card()
    side = torch.cuda.Stream(dev)
    g = torch.Generator(device=dev).manual_seed(3)
    q = torch.randn((1, 64, 2, 32), generator=g, device=dev)
    with torch.cuda.stream(side):
        leaves = [q.clone().requires_grad_() for _ in range(3)]
        out = ops.LAUNCHERS["flash_attention"](*leaves)
        out.sum().backward()
    torch.cuda.synchronize()
    assert all(bool(torch.isfinite(t.grad).all()) for t in leaves)
    assert np.isfinite(float(out.float().sum()))
