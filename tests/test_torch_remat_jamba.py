"""``cfg.remat`` on the reduced jamba (one group of 7 Mamba layers and an
attention layer, MoE on the odd positions): a CARLS step with remat
``nothing`` or ``dots`` bit-identical to the port's step without remat,
and against JAX's step with the same remat at the trainer tests' bounds
(tests/_torch_train_parity.py). The neighbour
gradient is held through the bank's lazy cache, which sums it by row
(each JAX compile of this model takes ~12 s on the CPU, the async core's
another 12).
"""
import pytest

from test_torch_remat import JAMBA, POLICIES, remat_step_case


@pytest.mark.parametrize("policy", POLICIES)
def test_remat_jamba_step_is_bit_identical_and_matches_jax(policy):
    remat_step_case(JAMBA, policy, with_gn=False)
