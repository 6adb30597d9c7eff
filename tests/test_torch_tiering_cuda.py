"""Tiered residency on the card: the kernels on slot ids give each row
what they give it at its global id, so a tiered cuda engine's lookups,
table and versions are bit-identical to an untiered one's on the same op
stream, and a repeat is bit-identical (tests/test_torch_tiering.py holds
the same engines against the JAX package on the CPU; chip_smoke.py phase
3 runs these checks at the serve width). No JAX here: the tests run on
the card's machine.
"""
import numpy as np
import pytest
import torch

from repro_torch.core.kb_engine import KBEngine
from repro_torch.kernels import ops

N, D = 512, 32
RESIDENT, COLD_AFTER, WAVE = 96, 48, 64


def _require_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; chip_smoke.py runs these checks "
                    "on the card")


def run_stream(e, seed: int = 12) -> dict:
    """Waves of update, lazy_grad and a lookup that faults cold rows back;
    the snapshots before the flush (a tiered flush leaves cold rows'
    pending gradients for their fault-in); then exact searches."""
    rng = np.random.default_rng(seed)
    out = {}
    for lo in range(0, N, WAVE):
        sel = np.arange(lo, lo + WAVE)
        e.update(sel, rng.standard_normal((WAVE, D)).astype(np.float32))
        e.lazy_grad(sel[:WAVE // 2], rng.standard_normal(
            (WAVE // 2, D)).astype(np.float32))
        cold = rng.choice(lo, 16, replace=False) if lo else sel[:16]
        out[f"lookup{lo}"] = e.lookup(np.concatenate(
            [cold, rng.choice(sel, 8)]))
    out["table"], out["version"] = e.table_snapshot(), e.version_snapshot()
    e.flush()
    q = rng.standard_normal((4, D)).astype(np.float32)
    out["nn_s"], out["nn_i"] = e.nn_search(q, 5)
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("storage,lazy_update",
                         [("fp32", True), ("fp32", False), ("int8", True)])
def test_cuda_tiered_is_bit_identical_to_untiered(storage, lazy_update):
    _require_card()

    def engine(**kw):
        return KBEngine(N, D, storage=storage, lazy_update=lazy_update,
                        device="cuda", **kw)

    tier = dict(resident_rows=RESIDENT, cold_after_rows=COLD_AFTER)
    ops.reset_launch_counts()
    tiered = run_stream(engine(**tier))
    counts = ops.launch_counts()
    again = run_stream(engine(**tier))
    flat = run_stream(engine())
    for key in tiered:
        np.testing.assert_array_equal(tiered[key], again[key], err_msg=key)
        if not key.startswith("nn"):
            np.testing.assert_array_equal(tiered[key], flat[key],
                                          err_msg=key)
    kern = {("fp32", True): "kb_fused_lookup", ("fp32", False): "kb_gather",
            ("int8", True): "kb_fused_lookup_q"}[(storage, lazy_update)]
    assert counts[kern] == N // WAVE
