"""``repro_torch.core`` re-exports the port's half of ``repro.core``'s API.

Every name of ``repro.core.__all__`` that the port's submodules define is
on ``repro_torch.core``, is the same object as the submodule's, and is in
``repro_torch.core.__all__`` in the reference's order; the names of the
slices not ported yet are absent. Importing the package, or any module of
the port first, works in a fresh interpreter and imports neither JAX, the
JAX package nor Triton.
"""
import os
import subprocess
import sys
from pathlib import Path

import pytest

import repro.core as jcore
import repro_torch.core as tcore

ROOT = Path(__file__).resolve().parents[1]
# the names of repro.core.__all__ that wait for their slices (ROADMAP "Not
# ported"): the shard_map ops and the Pallas backend (the port's kernel
# backend is CudaBackend)
UNPORTED = {
    "kb_axes", "kb_pspecs", "sharded_kb_flush", "sharded_kb_lazy_grad",
    "sharded_kb_lookup", "sharded_kb_update", "PallasBackend",
}
PORTED = [n for n in jcore.__all__ if n not in UNPORTED]


def test_all_lists_the_ported_names_in_the_reference_order():
    assert tcore.__all__ == PORTED
    assert len(PORTED) == 82 and len(jcore.__all__) == 89


@pytest.mark.parametrize("name", PORTED)
def test_each_ported_name_is_the_submodules_object(name):
    obj = getattr(tcore, name)
    if hasattr(obj, "__module__"):
        mod = sys.modules[obj.__module__]
        # the JAX package's submodule of the same name defines it too
        jmod = sys.modules[getattr(jcore, name).__module__]
    else:
        # a constant of the wire protocol (PROTOCOL_VERSION, the lanes):
        # the submodule that holds it, and its JAX twin's value, equal
        mod = sys.modules[f"repro_torch.core.{tcore._MODULE_OF[name]}"]
        jmod = sys.modules[f"repro.core.{tcore._MODULE_OF[name]}"]
        assert getattr(jmod, name) is getattr(jcore, name)
        assert obj == getattr(jcore, name)
    assert mod.__name__.startswith("repro_torch.core.")
    assert getattr(mod, name) is obj
    assert mod.__name__.rsplit(".", 1)[1] == jmod.__name__.rsplit(".", 1)[1]


@pytest.mark.parametrize("name", sorted(UNPORTED))
def test_unported_names_are_absent(name):
    assert not hasattr(tcore, name)
    with pytest.raises(ImportError):
        exec(f"from repro_torch.core import {name}", {})


def test_star_import_gives_the_ported_names():
    ns = {}
    exec("from repro_torch.core import *", ns)
    assert sorted(set(ns) - {"__builtins__"}) == sorted(PORTED)


@pytest.mark.parametrize("module", ["repro_torch.kernels.ops",
                                    "repro_torch.launch.train",
                                    "repro_torch.core",
                                    "repro_torch.core.kb_router",
                                    "repro_torch.launch.maker_worker",
                                    "repro_torch.launch.fleet"])
def test_cold_import_in_a_fresh_interpreter(module):
    code = (f"import sys, {module}, repro_torch.core as c; "
            "assert c.KBEngine is "
            "sys.modules['repro_torch.core.kb_engine'].KBEngine; "
            "bad = [m for m in ('jax', 'repro', 'triton') if m in "
            "sys.modules]; assert not bad, bad; print('ok')")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         env={**os.environ,
                              "PYTHONPATH": str(ROOT / "src")},
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr
