"""The rest of the LM zoo's text archs train on the port: one CARLS step
of each reduced config (minitron-4b, granite-34b, command-r-plus-104b,
grok-1-314b, kimi-k2-1t-a32b) held against
``repro.core.make_carls_train_step`` on the CPU, at the trainer tests'
bounds (tests/_torch_train_parity.py). The MoE archs' routing is exact
only where each token's k-th and (k+1)-th router probabilities are more
than 1e-4 apart: the test asserts that of its batch, so that the bounds
apply. internvl2-2b and whisper-tiny: tests/test_torch_frontend_train.py.
"""
import pytest

from _torch_train_parity import (MOE_GAP, bank_leaves, check_against_jax,
                                 configs, jax_step, make_batch, port_step)

TEXT_ZOO = ("minitron-4b", "granite-34b", "command-r-plus-104b",
            "grok-1-314b", "kimi-k2-1t-a32b")


@pytest.mark.parametrize("arch", TEXT_ZOO)
def test_zoo_carls_step_matches_jax(arch, monkeypatch):
    jcfg, tcfg = configs(arch)
    batch = make_batch(jcfg)
    leaves = bank_leaves(jcfg.carls.kb_entries, jcfg.d_model)
    want = jax_step(jcfg, batch, leaves)
    got = port_step(tcfg, want["p0"], batch, leaves, monkeypatch)
    if tcfg.is_moe:
        assert got["gap"] > MOE_GAP, got["gap"]
    check_against_jax(got, want)
