"""The port's AdamW and schedules (repro_torch.optim) held against the JAX
package's (repro.optim) on the CPU.

Both optimizers take the same numpy gradients for three steps from the
same parameters, with fp32 and bf16 moments and with clipping active and
off. The update is the same fp32 arithmetic in both, so parameters and
moments agree within atol 1e-6 (the bank state's bound; one fp32 ulp of
the largest values is ~1e-7; on these inputs they come out bit for bit,
bf16 moments included). ``count`` is exact, the global norm
within 1e-6 relative (the per-leaf sums run in another order), and the
schedules agree within ``peak_lr`` times one fp32 ulp of 1 at every count
checked (the two cosines may differ in their last bit).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint.checkpointing import flatten_params as jax_flatten
from repro.optim import AdamW as JAdamW
from repro.optim import constant_lr as j_constant
from repro.optim import global_norm as j_global_norm
from repro.optim import warmup_cosine as j_cosine
from repro.optim import warmup_stable_decay as j_wsd
from repro_torch import convert
from repro_torch.optim import (AdamW, constant_lr, global_norm,
                               warmup_cosine, warmup_stable_decay)
from repro_torch.tree import tree_items

ATOL = 1e-6
SHAPES = {"emb": (32, 8), "a": {"w": (8, 16), "b": (16,)}, "z": (5,)}


def _tree(rng, shapes, scale):
    if isinstance(shapes, dict):
        return {k: _tree(rng, v, scale) for k, v in shapes.items()}
    return (rng.standard_normal(shapes) * scale).astype(np.float32)


def _jax(tree):
    return jax.tree.map(jnp.asarray, tree)


def _torch(tree):
    if isinstance(tree, dict):
        return {k: _torch(v) for k, v in tree.items()}
    return torch.from_numpy(np.array(tree))


def _close_tree(got, want, label):
    want = jax_flatten(want)
    got = dict(tree_items(got))
    assert sorted(got) == sorted(want)
    for k, w in want.items():
        np.testing.assert_allclose(got[k].float().numpy(), w, atol=ATOL,
                                   rtol=0, err_msg=f"{label} {k}")


@pytest.mark.parametrize("moments", ["float32", "bfloat16"])
@pytest.mark.parametrize("clip", [1.0, 0.0])
def test_adamw_matches_jax_over_three_steps(moments, clip):
    rng = np.random.default_rng(0)
    params = _tree(rng, SHAPES, 1.0)
    lr_args = (1e-2, 1, 3)
    jopt = JAdamW(lr=j_cosine(*lr_args), clip_norm=clip,
                  moments_dtype=moments)
    topt = AdamW(lr=warmup_cosine(*lr_args), clip_norm=clip,
                 moments_dtype=moments)
    jp, tp = _jax(params), _torch(params)
    jst, tst = jopt.init(jp), topt.init(tp)
    assert tst.count.dtype == torch.int32 and int(tst.count) == 0
    for step in range(3):
        grads = _tree(rng, SHAPES, 0.5 + step)
        jp, jst, jgn = jopt.update(_jax(grads), jst, jp)
        tp, tst, tgn = topt.update(_torch(grads), tst, tp)
        if clip:
            assert float(jgn) > clip          # the clip is active
        np.testing.assert_allclose(float(tgn), float(jgn), rtol=1e-6)
        assert int(tst.count) == int(jst.count) == step + 1
        _close_tree(tp, jp, f"params step {step + 1}")
        for name in ("mu", "nu"):
            _close_tree(getattr(tst, name), getattr(jst, name),
                        f"{name} step {step + 1}")
            assert all(t.dtype == getattr(torch, moments)
                       for _, t in tree_items(getattr(tst, name)))


def test_adamw_updates_in_place_and_rounds_to_the_param_dtype():
    rng = np.random.default_rng(1)
    p = {"w": torch.from_numpy(rng.standard_normal((64,)).astype(
        np.float32)).to(torch.bfloat16)}
    before = p["w"]
    opt = AdamW(lr=constant_lr(1e-2), weight_decay=0.0, clip_norm=0.0)
    st = opt.init(p)
    g = {"w": torch.from_numpy(rng.standard_normal((64,)).astype(
        np.float32)).to(torch.bfloat16)}
    want = (p["w"].float() - 1e-2 * g["w"].float()
            / (g["w"].float().abs() + 1e-8)).to(torch.bfloat16)
    out, st2, _ = opt.update(g, st, p)
    assert out is p and out["w"] is before and st2.mu is st.mu
    assert out["w"].dtype == torch.bfloat16
    torch.testing.assert_close(out["w"], want, atol=0, rtol=0)


def test_global_norm_adds_leaves_in_jax_order():
    rng = np.random.default_rng(2)
    tree = _tree(rng, SHAPES, 3.0)
    np.testing.assert_allclose(float(global_norm(_torch(tree))),
                               float(j_global_norm(_jax(tree))), rtol=1e-6)


def test_schedules_match_jax():
    pairs = [(3e-4, warmup_cosine(3e-4, 5, 40), j_cosine(3e-4, 5, 40)),
             (1e-3, warmup_cosine(1e-3, 0, 7, min_frac=0.0),
              j_cosine(1e-3, 0, 7, min_frac=0.0)),
             (2e-3, warmup_stable_decay(2e-3, 4, 30), j_wsd(2e-3, 4, 30)),
             (2e-3, constant_lr(2e-3), j_constant(2e-3))]
    for peak, ours, ref in pairs:
        for c in range(0, 45):
            got = ours(torch.tensor(c, dtype=torch.int32))
            want = ref(jnp.int32(c))
            assert got.dtype == torch.float32 and got.shape == ()
            # the two cosines may differ in their last bit; near cos = -1
            # the sum 1 + cos keeps that error absolute: peak * 2^-23
            assert abs(float(got) - float(want)) <= peak * 2.0 ** -23, (
                c, got, want)


def test_adamw_state_converts_both_ways():
    rng = np.random.default_rng(3)
    params = _tree(rng, SHAPES, 1.0)
    jopt = JAdamW(lr=j_constant(1e-3), moments_dtype="bfloat16")
    jp = _jax(params)
    jst = jopt.init(jp)
    jp, jst, _ = jopt.update(_jax(_tree(rng, SHAPES, 1.0)), jst, jp)
    flat = {"count": int(jst.count), "mu": jax_flatten(jst.mu),
            "nu": jax_flatten(jst.nu)}
    st = convert.adamw_state_from_numpy(flat, moments_dtype="bfloat16",
                                        device="cpu")
    back = convert.adamw_state_to_numpy(st)
    assert back["count"] == 1
    for name in ("mu", "nu"):
        assert sorted(back[name]) == sorted(flat[name])
        for k, v in flat[name].items():
            np.testing.assert_array_equal(back[name][k], v)


def test_chunked_update_equals_whole_leaves(monkeypatch):
    """The update runs ``CHUNK`` entries at a time; each entry's arithmetic
    does not depend on the chunking (the global norm's sum does, in its
    last bits, so the clip is off here)."""
    from repro_torch.optim import optimizer
    rng = np.random.default_rng(4)
    params = _tree(rng, SHAPES, 1.0)
    grads = _tree(rng, SHAPES, 2.0)
    out = []
    for chunk in (optimizer.CHUNK, 7):
        monkeypatch.setattr(optimizer, "CHUNK", chunk)
        opt = AdamW(lr=warmup_cosine(1e-2, 1, 3), clip_norm=0.0,
                    moments_dtype="bfloat16")
        tp = _torch(params)
        st = opt.init(tp)
        for _ in range(2):
            _, st, gn = opt.update(_torch(grads), st, tp)
        out.append((tree_items(tp) + tree_items(st.mu) + tree_items(st.nu),
                    gn))
    (a, gn_a), (b, gn_b) = out
    np.testing.assert_allclose(float(gn_a), float(gn_b), rtol=1e-6)
    for (k, x), (_, y) in zip(a, b):
        assert torch.equal(x, y), k
