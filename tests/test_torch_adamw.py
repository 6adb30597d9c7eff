"""The AdamW kernel's plain half on the CPU: its plain version
(``ref.adamw_ref``, ``ref.adamw_update_ref``) against ``AdamW.update`` and
against the JAX package's AdamW, and the launcher's route and refusals
with the device check set aside.

- ``ref.adamw_update_ref``, given the scale ``AdamW.update`` clips with,
  is bit-identical to ``AdamW.update`` on the CPU (fp32 and bf16
  parameters and gradients, fp32 and bf16 moments);
- ``AdamW.update`` with bf16 parameters and gradients matches JAX's over
  three steps at ``tests/test_torch_optim.py``'s bounds (global norm rtol
  1e-6, leaves atol 1e-6);
- on a CUDA route (``AdamW.update`` told its leaves are on the card, the
  launcher's device check and its launch set aside) the update goes to
  the AdamW launcher alone, once, with the bias corrections and the
  learning rate passed as pointers to 0-d fp32 tensors, and never to the
  plain version; the launcher refuses every dtype combination it does not
  take, naming it, before it launches.
"""
import ctypes

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint.checkpointing import flatten_params as jax_flatten
from repro.optim import AdamW as JAdamW
from repro.optim import warmup_cosine as j_cosine
from repro_torch.kernels import adamw as adamw_mod
from repro_torch.kernels import ops, ref
from repro_torch.optim import AdamW, constant_lr, global_norm, optimizer
from repro_torch.optim import warmup_cosine
from repro_torch.tree import tree_items, tree_leaves

ATOL = 1e-6
SHAPES = {"emb": (32, 8), "a": {"w": (8, 16), "b": (16,)}, "z": (5,)}
DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _tree(rng, shapes, scale):
    if isinstance(shapes, dict):
        return {k: _tree(rng, v, scale) for k, v in shapes.items()}
    return (rng.standard_normal(shapes) * scale).astype(np.float32)


def _torch(tree, dtype=torch.float32):
    if isinstance(tree, dict):
        return {k: _torch(v, dtype) for k, v in tree.items()}
    return torch.from_numpy(np.array(tree)).to(dtype)


@pytest.mark.parametrize("p_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("moments", ["float32", "bfloat16"])
@pytest.mark.parametrize("clip", [1.0, 0.0])
def test_update_ref_given_the_scale_is_bit_identical_to_update(
        p_dtype, moments, clip):
    rng = np.random.default_rng(7)
    params = _tree(rng, SHAPES, 1.0)
    grads = [_tree(rng, SHAPES, 2.0) for _ in range(2)]
    opt = AdamW(lr=warmup_cosine(1e-2, 1, 3), clip_norm=clip,
                moments_dtype=moments)
    dt = DTYPES[p_dtype]
    tp, pp = _torch(params, dt), _torch(params, dt)
    st, sp = opt.init(tp), opt.init(pp)
    for g in grads:
        _, st, gn = opt.update(_torch(g, dt), st, tp)
        # the plain update with the scale the update clipped with
        gt = _torch(g, dt)
        gn_plain = global_norm(gt)
        assert torch.equal(gn, gn_plain)
        scale = (torch.clamp(clip / torch.clamp(gn_plain, min=1e-12),
                             max=1.0) if clip else None)
        sp.count.add_(1)
        bc1, bc2 = 1 - opt.b1 ** sp.count, 1 - opt.b2 ** sp.count
        lr = opt.lr(sp.count)
        for g_, m, v, p in zip(tree_leaves(gt), tree_leaves(sp.mu),
                               tree_leaves(sp.nu), tree_leaves(pp)):
            ref.adamw_update_ref(g_, m, v, p, scale, bc1, bc2, lr,
                                 b1=opt.b1, b2=opt.b2, eps=opt.eps,
                                 weight_decay=opt.weight_decay,
                                 chunk=optimizer.CHUNK)
    for a, b in zip(tree_items(tp) + tree_items(st.mu) + tree_items(st.nu),
                    tree_items(pp) + tree_items(sp.mu) + tree_items(sp.nu)):
        assert a[1].dtype == b[1].dtype and torch.equal(a[1], b[1]), a[0]


@pytest.mark.parametrize("moments", ["float32", "bfloat16"])
def test_bf16_params_match_jax_over_three_steps(moments):
    """bf16 parameters and gradients, as the trainer's at full width."""
    rng = np.random.default_rng(3)
    params = _tree(rng, SHAPES, 1.0)
    grads = [_tree(rng, SHAPES, 2.0) for _ in range(3)]
    kw = dict(b1=0.9, b2=0.95, eps=1e-8, weight_decay=0.1, clip_norm=1.0,
              moments_dtype=moments)
    jopt = JAdamW(lr=j_cosine(1e-2, 1, 3), **kw)
    topt = AdamW(lr=warmup_cosine(1e-2, 1, 3), **kw)
    to_j = lambda t: {k: to_j(v) for k, v in t.items()} \
        if isinstance(t, dict) else jnp.asarray(t, jnp.bfloat16)
    jp = to_j(params)
    js = jopt.init(jp)
    tp = _torch(params, torch.bfloat16)
    ts = topt.init(tp)
    for g in grads:
        jp, js, jgn = jopt.update(to_j(g), js, jp)
        _, ts, tgn = topt.update(_torch(g, torch.bfloat16), ts, tp)
        np.testing.assert_allclose(float(tgn), float(jgn), rtol=1e-6)
    for got, want, label in ((tp, jp, "params"), (ts.mu, js.mu, "mu"),
                             (ts.nu, js.nu, "nu")):
        want = jax_flatten(want)
        got = dict(tree_items(got))
        assert sorted(got) == sorted(want)
        for k, w in want.items():
            np.testing.assert_allclose(
                got[k].float().numpy(), np.asarray(w, np.float32), atol=ATOL,
                rtol=0, err_msg=f"{label} {k}")


def _cuda_route(monkeypatch):
    """``AdamW.update`` takes the card's route for CPU tensors: its device
    test says "not the CPU", the launcher's device check passes and its
    launch is recorded instead of run; the plain versions raise."""
    calls, given = [], []
    monkeypatch.setattr(optimizer, "on_cpu", lambda t: False)
    monkeypatch.setattr(adamw_mod, "require_cuda", lambda *a: None)


    def record(*a):
        # the host arrays live for the launch's call only: read them now
        n = a[4]
        calls.append((a, [list((ctypes.c_void_p * n).from_address(x))
                          for x in a[5:9]],
                      list((ctypes.c_int * n).from_address(a[10]))))
    monkeypatch.setattr(adamw_mod, "launch", record)
    real = optimizer.adamw_cuda

    def spy(*args, **kw):
        given.append((args, kw))
        return real(*args, **kw)
    monkeypatch.setattr(optimizer, "adamw_cuda", spy)

    def plain(*a, **kw):
        raise AssertionError("the plain version ran on the card's route")
    for name in ("adamw_ref", "adamw_update_ref", "global_norm_ref"):
        monkeypatch.setattr(ref, name, plain)
    return calls, given


def test_cuda_route_launches_the_kernel_with_device_scalars(monkeypatch):
    rng = np.random.default_rng(5)
    params = _torch(_tree(rng, SHAPES, 1.0), torch.bfloat16)
    grads = _torch(_tree(rng, SHAPES, 2.0), torch.bfloat16)
    opt = AdamW(lr=constant_lr(1e-3))
    st = opt.init(params)
    ops.reset_launch_counts()
    calls, given = _cuda_route(monkeypatch)
    opt.update(grads, st, params)
    assert len(calls) == 1 and len(given) == 1
    assert ops.launch_counts()["adamw"] == 1
    # (name, symbol, argtypes, device, leaves, the four pointer arrays,
    # the sizes, the kinds, slots, out, bc1, bc2, lr, b1, ...)
    args, pointers, kinds = calls[0]
    assert args[:2] == ("adamw", "adamw_launch")
    assert args[4] == len(tree_leaves(params)) == 4
    (g, m, v, p, bc1, bc2, lr), kw = given[0]
    for t in (bc1, bc2, lr):
        assert t.dim() == 0 and t.dtype == torch.float32
    assert args[13:16] == (bc1.data_ptr(), bc2.data_ptr(), lr.data_ptr())
    for got, col in zip(pointers, (g, m, v, p)):
        assert got == [t.data_ptr() for t in col]
    assert [t.data_ptr() for t in p] == [t.data_ptr()
                                         for t in tree_leaves(params)]
    assert kinds == [3] * 4      # bf16 gradients and parameters
    assert kw["clip_norm"] == opt.clip_norm and kw["b1"] == opt.b1


@pytest.mark.parametrize("g, p, m, v", [
    (torch.float16, torch.float16, torch.float32, torch.float32),
    (torch.bfloat16, torch.float16, torch.float32, torch.float32),
    (torch.float16, torch.bfloat16, torch.float32, torch.float32),
    (torch.bfloat16, torch.bfloat16, torch.float16, torch.float16),
    (torch.float32, torch.float32, torch.float64, torch.float64),
    (torch.float64, torch.float64, torch.float32, torch.float32),
    (torch.bfloat16, torch.bfloat16, torch.float32, torch.bfloat16),
])
def test_launcher_refuses_dtype_combinations_naming_them(g, p, m, v,
                                                         monkeypatch):
    calls, _ = _cuda_route(monkeypatch)
    ops.reset_launch_counts()
    leaf = lambda dt: torch.zeros(5, dtype=dt)
    scalar = torch.ones((), dtype=torch.float32)
    with pytest.raises(ValueError) as err:
        adamw_mod.adamw_cuda([leaf(g)], [leaf(m)], [leaf(v)], [leaf(p)],
                             scalar, scalar, scalar, b1=0.9, b2=0.95,
                             eps=1e-8, weight_decay=0.1, clip_norm=1.0)
    msg = str(err.value)
    for dt in (g, p, m, v):
        assert str(dt) in msg
    assert not calls and ops.launch_counts()["adamw"] == 0


@pytest.mark.parametrize("p_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("m_dtype", [torch.float32, torch.bfloat16])
def test_leaf_kind_codes_each_taken_combination(p_dtype, m_dtype):
    t = lambda dt: torch.zeros(3, dtype=dt)
    for g_dtype in (torch.float32, torch.bfloat16):
        kind = adamw_mod.leaf_kind(t(g_dtype), t(p_dtype), t(m_dtype),
                                   t(m_dtype))
        assert kind == (int(g_dtype == torch.bfloat16)
                        | int(p_dtype == torch.bfloat16) << 1
                        | int(m_dtype == torch.bfloat16) << 2)
