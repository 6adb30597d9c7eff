"""The AdamW kernel (``kernels/adamw.py``, ``csrc/adamw.cu``) on a card,
against its plain version (``ref.adamw_ref`` and ``ref.adamw_update_ref``)
on the same inputs. Every test is marked ``cuda`` and skips where no CUDA
device is present (it decides inside the test, so that every xdist
worker collects the same tests). The file imports no JAX:

    PYTHONPATH=src python -m pytest -m cuda tests/test_torch_adamw_cuda.py

Bounds: the global norm within rtol 1e-6 of the plain ``global_norm``
(both sum the squares in their own fixed orders, the kernel in fp64);
given the kernel's own clip scale, the new parameters and moments equal
the plain version's bit for bit (each entry's operations are the eager
ones, each rounded on its own); two runs of the kernel bit-identical; no
host synchronisation in a step.
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import ops, ref
from repro_torch.kernels.adamw import adamw_cuda
from repro_torch.optim import AdamW, constant_lr

RTOL_GN = 1e-6
# leaf sizes, none a multiple of 8 but one: the vector loop and its tail
SHAPES = [(37,), (5, 13), (1031,), (64, 129), (8,), (3, 7, 11), (1,)]
HYPER = dict(b1=0.9, b2=0.95, eps=1e-8, weight_decay=0.1)


def _require_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; chip_smoke.py runs these checks "
                    "on the card")
    return torch.device("cuda")


def _leaves(dev, p_dtype, m_dtype, seed=0, offset=False):
    """(grads, mus, nus, params) lists at SHAPES; with ``offset`` every
    tensor starts 2 bytes past a 16-byte boundary (the kernel's one-entry
    path)."""
    rng = np.random.default_rng(seed)

    def make(shape, scale, dtype, positive=False):
        x = rng.standard_normal(shape).astype(np.float32) * scale
        t = torch.from_numpy(np.abs(x) if positive else x).to(dev).to(dtype)
        if not offset:
            return t
        flat = torch.zeros(t.numel() + 8, dtype=dtype, device=dev)
        out = flat[1:1 + t.numel()].view(shape)
        out.copy_(t)
        return out

    out = ([], [], [], [])
    for shape in SHAPES:
        out[0].append(make(shape, 0.05, p_dtype))
        out[1].append(make(shape, 0.01, m_dtype))
        out[2].append(make(shape, 1e-4, m_dtype, positive=True))
        out[3].append(make(shape, 1.0, p_dtype))
    return out


def _scalars(dev, count=3, lr=1e-3):
    c = torch.tensor(count, dtype=torch.int32, device=dev)
    return (1 - HYPER["b1"] ** c, 1 - HYPER["b2"] ** c,
            torch.tensor(lr, dtype=torch.float32, device=dev))


def _clone(leaves):
    return [[t.clone() for t in col] for col in leaves]


@pytest.mark.cuda
@pytest.mark.parametrize("p_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("m_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("clip", [1.0, 0.0, 1e3])
@pytest.mark.parametrize("offset", [False, True])
def test_cuda_adamw_matches_plain_bit_for_bit(p_dtype, m_dtype, clip,
                                              offset):
    dev = _require_card()
    leaves = _leaves(dev, p_dtype, m_dtype, offset=offset)
    bc1, bc2, lr = _scalars(dev)
    kw = dict(HYPER, clip_norm=clip)
    got = _clone(leaves)
    gn, scale = adamw_cuda(*got, bc1, bc2, lr, **kw)
    again = _clone(leaves)
    gn2, scale2 = adamw_cuda(*again, bc1, bc2, lr, **kw)
    want = _clone(leaves)
    gn_plain = ref.global_norm_ref(want[0], 1 << 24)
    torch.cuda.synchronize()
    assert abs(float(gn) - float(gn_plain)) <= RTOL_GN * float(gn_plain)
    assert torch.equal(gn, gn2) and torch.equal(scale, scale2)
    if clip > 0:
        plain_scale = torch.clamp(clip / torch.clamp(gn, min=1e-12), max=1.0)
        assert torch.equal(scale, plain_scale)
    else:
        assert float(scale) == 1.0
    for g, m, v, p in zip(*want):
        ref.adamw_update_ref(g, m, v, p, scale if clip > 0 else None, bc1,
                             bc2, lr, chunk=1 << 24, **HYPER)
    for col, name in zip(range(1, 4), ("mu", "nu", "param")):
        for i, (a, b, c) in enumerate(zip(got[col], want[col], again[col])):
            assert torch.equal(a, b), f"{name} {i} differs from the plain"
            assert torch.equal(a, c), f"{name} {i} differs between runs"


@pytest.mark.cuda
def test_cuda_adamw_step_makes_no_host_sync():
    """``AdamW.update`` on the card: one launch of the kernel, no plain
    pass, and no synchronisation with the host (torch's sync debug mode
    raises on one)."""
    dev = _require_card()
    grads, _, _, params = _leaves(dev, torch.bfloat16, torch.float32)
    tree = {f"l{i}": p for i, p in enumerate(params)}
    gtree = {f"l{i}": g for i, g in enumerate(grads)}
    opt = AdamW(lr=constant_lr(1e-3))
    state = opt.init(tree)
    opt.update(gtree, state, tree)            # builds and loads the kernel
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    torch.cuda.set_sync_debug_mode("error")
    try:
        _, state, gn = opt.update(gtree, state, tree)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert ops.launch_counts()["adamw"] == 1
    assert int(state.count) == 2 and bool(torch.isfinite(gn))
