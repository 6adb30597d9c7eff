"""Bank state carried between the JAX package and the port, as numpy.

The dict is keyed by the JAX ``KBState`` field names
(``repro/core/knowledge_bank.py:43-50``): ``table``, ``version``,
``grad_sum``, ``grad_cnt``, ``grad_sqnorm``, ``norm_ema``, ``step``. The
tests start both packages from one such dict; ``KBEngine.load_state``
takes one too.
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from repro_torch.core.knowledge_bank import KBState
from repro_torch.env import resolve_device

_DTYPES = {"table": np.float32, "version": np.int32, "grad_sum": np.float32,
           "grad_cnt": np.float32, "grad_sqnorm": np.float32,
           "norm_ema": np.float32, "step": np.int32}


def kb_state_from_numpy(leaves: Dict[str, np.ndarray],
                        device="cuda") -> KBState:
    """A ``KBState`` on ``device`` holding copies of ``leaves``."""
    device = resolve_device(device)
    missing = set(KBState._fields) - set(leaves)
    if missing:
        raise ValueError(f"state leaves missing: {sorted(missing)}")
    return KBState(**{
        f: torch.tensor(np.asarray(leaves[f], dtype=_DTYPES[f]),
                        device=device)
        for f in KBState._fields})


def kb_state_to_numpy(state: KBState) -> Dict[str, np.ndarray]:
    """Host copies of every leaf of ``state``."""
    return {f: getattr(state, f).detach().to("cpu", copy=True).numpy()
            for f in KBState._fields}
