"""The plain version of the port's flash-attention kernel
(``repro_torch.kernels.ops.flash_attention`` on CPU tensors, i.e.
``ref.flash_attention_ref``) against the JAX package: the Pallas kernel in
interpret mode (``repro.kernels.ops.flash_attention``, heads repeated and
flattened into its (B, H, S, d) layout, as tests/test_kernels.py runs it)
and the model path's ``flash_attention_jax`` in the JAX layout.

Inputs are made with numpy from a seed. Tolerances are
tests/test_kernels.py's: fp32 atol 2e-5, bf16 atol 2e-2. The Pallas kernel
takes only S that its 128-row blocks divide, so the ragged S = 200 is held
against ``flash_attention_jax`` and the naive attention alone. The cases
include kimi-k2's head dim 112 (causal, soft-capped, ragged) and
whisper's encoder (6 heads of 64, not causal).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.models.layers import flash_attention_jax, naive_attention
from repro_torch.kernels import ops

CASES = [  # (B, S, H, KV, d, causal, window, softcap)
    # the six of tests/test_kernels.py::test_flash_attention_variants
    (2, 128, 2, 2, 64, True, 0, 0.0),
    (2, 256, 2, 2, 64, True, 0, 0.0),
    (2, 256, 2, 2, 64, False, 0, 0.0),
    (2, 256, 2, 2, 64, True, 64, 0.0),
    (2, 256, 2, 2, 64, True, 0, 30.0),
    (2, 512, 2, 2, 64, True, 100, 20.0),
    (2, 256, 4, 2, 32, True, 0, 0.0),        # GQA
    (2, 200, 4, 2, 32, True, 0, 0.0),        # S not a multiple of 64
    (1, 200, 4, 1, 32, False, 50, 10.0),
    # kimi-k2's head dim 112, causal and soft-capped (grok's cap of 30)
    (2, 256, 4, 2, 112, True, 0, 0.0),
    (1, 256, 4, 2, 112, True, 0, 30.0),
    (1, 200, 4, 1, 112, True, 0, 0.0),       # d 112 with a ragged end
    # whisper's encoder: 6 heads of 64, not causal
    (1, 384, 6, 6, 64, False, 0, 0.0),
]


def _inputs(B, S, H, KV, d, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, S, H, d)).astype(np.float32),
            rng.standard_normal((B, S, KV, d)).astype(np.float32),
            rng.standard_normal((B, S, KV, d)).astype(np.float32))


def _pallas(q, k, v, H, **kw):
    """Pallas interpret mode on the JAX layout: KV heads repeated, (B, S,
    H, d) <-> (B, H, S, d)."""
    rep = H // k.shape[2]
    k, v = (np.repeat(a, rep, axis=2) for a in (k, v))
    t = (jnp.asarray(a.transpose(0, 2, 1, 3)) for a in (q, k, v))
    return np.asarray(jops.flash_attention(*t, **kw),
                      np.float32).transpose(0, 2, 1, 3)


@pytest.mark.parametrize("dtype,atol", [(torch.float32, 2e-5),
                                        (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("case", CASES)
def test_flash_plain_matches_jax(case, dtype, atol):
    B, S, H, KV, d, causal, window, softcap = case
    q, k, v = _inputs(B, S, H, KV, d, seed=S + H + KV)
    if dtype == torch.bfloat16:         # both sides see the same bf16 values
        q, k, v = (torch.from_numpy(a).to(dtype).float().numpy()
                   for a in (q, k, v))
    kw = dict(causal=causal, window=window, softcap=softcap)
    got = ops.flash_attention(*(torch.from_numpy(a).to(dtype)
                                for a in (q, k, v)), **kw)
    assert got.dtype == dtype and got.shape == (B, S, H, d)
    got = got.float().numpy()
    jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    jq, jk, jv = (jnp.asarray(a, jdt) for a in (q, k, v))
    wants = [flash_attention_jax(jq, jk, jv, **kw),
             naive_attention(jq, jk, jv, **kw)]
    if S % 128 == 0:
        wants.append(_pallas(*(np.asarray(a) for a in (jq, jk, jv)), H,
                             **kw))
    for want in wants:
        np.testing.assert_allclose(got, np.asarray(want, np.float32),
                                   atol=atol)


def test_flash_plain_reads_gqa_heads_in_place():
    """Query head h reads KV head h // (H / KV): the same as repeating the
    KV heads, which the plain version never does."""
    q, k, v = (torch.from_numpy(a) for a in _inputs(1, 96, 6, 2, 32, 3))
    got = ops.flash_attention(q, k, v, causal=True)
    rep = ops.flash_attention(q, k.repeat_interleave(3, 2),
                              v.repeat_interleave(3, 2), causal=True)
    torch.testing.assert_close(got, rep, atol=1e-6, rtol=0)


def test_flash_on_cpu_launches_nothing():
    q, k, v = (torch.from_numpy(a) for a in _inputs(1, 64, 2, 1, 32, 4))
    before = ops.launch_counts()["flash_attention"]
    ops.flash_attention(q, k, v)
    assert ops.launch_counts()["flash_attention"] == before
    with pytest.raises(ValueError, match="CUDA"):
        ops.LAUNCHERS["flash_attention"](q, k, v)
    with pytest.raises(ValueError, match=r"\(B, S, KV, d\)"):
        ops.flash_attention(q, k[:, :32], v[:, :32])   # Skv != Sq

