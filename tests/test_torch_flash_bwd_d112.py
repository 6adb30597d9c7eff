"""The flash backward's plain version (``repro_torch.kernels.ref.
flash_attention_bwd_ref``) at kimi-k2's head dim 112, which the backward
kernel now takes, held against ``jax.vjp`` of the JAX package's flash
function (``repro.models.layers.flash_attention_jax``) on the same seeded
numpy inputs: causal GQA, the soft cap, a ragged sequence, MQA not
causal. Bounds: tests/test_torch_backward.py's against ``jax.vjp`` (its
cases reach d 32), 1e-5 of the value plus an atol of 1e-6 scaled by
d / 32. The atol covers the entries whose exact value cancels to 0: the
first query's dS = P (dP - D) with P = 1 and dP = D, two d-term fp32
sums taken in other orders, so their difference, and the dq row it
scales, grow with d (1.8e-6 seen at d 112, on 4 of 17,920 dq entries
of the ragged case). The kernel against this plain version on the card:
tests/test_torch_cuda_kernels.py and chip_smoke.py phase 2.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models.layers import flash_attention_jax
from repro_torch.kernels import ref

ATOL_VJP, RTOL_VJP = 1e-6 * 112 / 32, 1e-5
CASES = [  # (B, S, H, KV, d, causal, softcap)
    (2, 64, 4, 2, 112, True, 0.0),       # causal GQA
    (1, 96, 4, 2, 112, True, 30.0),      # grok's soft cap at d 112
    (1, 80, 2, 2, 112, True, 0.0),       # S no multiple of the key tile
    (2, 48, 4, 1, 112, False, 0.0),      # MQA, not causal
]


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _close(got, want, label):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               atol=ATOL_VJP, rtol=RTOL_VJP, err_msg=label)


@pytest.mark.parametrize("case", CASES)
def test_flash_bwd_plain_at_d112_matches_jax_vjp(case):
    B, S, H, KV, d, causal, softcap = case
    rng = np.random.default_rng(S + H)
    q, do = (rng.standard_normal((B, S, H, d)).astype(np.float32)
             for _ in range(2))
    k, v = (rng.standard_normal((B, S, KV, d)).astype(np.float32)
            for _ in range(2))
    kw = dict(causal=causal, softcap=softcap)
    out_j, vjp = jax.vjp(
        lambda a, b, c: flash_attention_jax(a, b, c, q_chunk=16,
                                            kv_chunk=16, **kw),
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    out, lse = ref.flash_attention_ref(_t(q), _t(k), _t(v), return_lse=True,
                                       **kw)
    grads = ref.flash_attention_bwd_ref(_t(q), _t(k), _t(v), out, lse,
                                        _t(do), **kw)
    _close(out, out_j, "out")
    for name, g, gj, shape in zip(("dq", "dk", "dv"), grads,
                                  vjp(jnp.asarray(do)),
                                  (q.shape, k.shape, v.shape)):
        assert g.dtype == torch.float32 and tuple(g.shape) == shape
        _close(g, gj, name)
