"""internvl2-2b and whisper-tiny train on the port with their front-ends'
inputs in the batch: one CARLS step of each reduced config (16 N(0, 1)
patch embeddings before internvl's text, 16 N(0, 1) frames under
whisper's encoder) held against ``repro.core.make_carls_train_step`` on
the CPU, at the trainer tests' bounds (tests/_torch_train_parity.py).

The inputs ride in the batch, as JAX's ``_extra_from_batch`` reads them,
and the loss, the pool and the graph regulariser run on the text
positions after internvl's prefix. Before this was repaired the port's
step called the model without them: both steps raised a ``TypeError``
(``None["patch_embs"]``, ``None["frames"]``), and with the input given
internvl's cross-entropy would have run over the patch positions too.
"""
import numpy as np
import pytest
import torch

from _torch_train_parity import (bank_leaves, check_against_jax, configs,
                                 jax_step, make_batch, port_step)
from repro_torch.core.trainer import extra_from_batch, model_loss
from repro_torch.models import build_model

FRONT_ENDS = ("internvl2-2b", "whisper-tiny")


@pytest.mark.parametrize("arch", FRONT_ENDS)
def test_front_end_carls_step_matches_jax(arch):
    jcfg, tcfg = configs(arch)
    batch = make_batch(jcfg)
    leaves = bank_leaves(jcfg.carls.kb_entries, jcfg.d_model)
    want = jax_step(jcfg, batch, leaves)
    check_against_jax(port_step(tcfg, want["p0"], batch, leaves), want)


@pytest.mark.parametrize("arch", FRONT_ENDS)
def test_front_end_inputs_reach_the_loss(arch):
    """The step's loss reads the batch's front-end input: another input
    moves it; internvl's prefix is cut before the loss, so its
    cross-entropy counts the batch's text tokens alone; without the
    input the model raises JAX's KeyError."""
    _, tcfg = configs(arch)
    model = build_model(tcfg)
    params = model.init(torch.Generator().manual_seed(0))
    batch = {k: torch.from_numpy(v) for k, v in make_batch(tcfg).items()}
    (key,) = extra_from_batch(batch)
    with torch.no_grad():
        loss, (m, pooled) = model_loss(model, params, batch)
        other = dict(batch, **{key: batch[key] + 1.0})
        loss2 = model_loss(model, params, other)[0]
    assert np.isfinite(float(loss)) and float(loss) != float(loss2)
    assert float(m["tokens"]) == float(batch["mask"].sum())
    assert pooled.shape == (batch["tokens"].shape[0], tcfg.d_model)
    del batch[key]
    with pytest.raises(KeyError, match=key):
        model_loss(model, params, batch)
