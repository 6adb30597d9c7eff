"""The port's training launcher (repro_torch.launch.train) on the CPU: the
JAX launcher's printed lines, its refusals, the device rule, and that on
the card every ported arch reaches parameter building (the device check
monkeypatched away, as the kernel wrappers' routes are tested): each
sequence kernel its training forward reaches has a backward."""
import os
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.checkpoint import DiskCheckpointStore
from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.core import KBTransportServer, KnowledgeBankServer, trainer
from repro_torch.kernels import ops
from repro_torch.launch import train
from repro_torch.models import build_model
from repro_torch.models.model import LM

ROOT = Path(__file__).resolve().parents[1]
CPU_RUN = ["--device", "cpu", "--steps", "3", "--batch", "2", "--seq", "16",
           "--nodes", "64"]
# the JAX launcher's line shapes (repro/launch/train.py)
STEP = (r"step +{} loss=\d+\.\d{{4}} acc=\d\.\d{{3}} reg=\d+\.\d{{4}} "
        r"gnorm=\d+\.\d{{2}}")
LINES = [r"arch=yi-6b params=\d+\.\dM \(reduced=True\)",
         r"actual params: \d+\.\dM",
         STEP.format(1), STEP.format(2), STEP.format(3),
         r"done: 3 steps in \d+\.\ds \(\d+ ms/step\)"]


def test_cpu_run_prints_the_jax_launchers_lines(capsys, tmp_path):
    res = train.main(CPU_RUN + ["--maker-every", "2", "--ckpt-dir",
                                str(tmp_path), "--ckpt-every", "2"])
    out = capsys.readouterr().out.strip().splitlines()
    assert len(out) == len(LINES), out
    for line, pat in zip(out, LINES):
        assert re.fullmatch(pat, line), (line, pat)
    cfg = get_config("yi-6b").reduced()
    assert out[1] == f"actual params: {cfg.param_count()/1e6:.1f}M"
    assert len(res["losses"]) == len(res["step_ms"]) == 3
    assert np.isfinite(res["losses"]).all()
    loop = res["loop"]
    assert loop.kb.table.shape == (64, cfg.d_model)
    assert loop.done == 3 and int(loop.kb.version.max()) >= 1
    assert int(loop.opt_state.count) == 3
    store = DiskCheckpointStore(str(tmp_path), template=loop.params)
    assert store.steps() == [2]
    step, params = store.load_latest()
    assert step == 2 and params["embed"]["tok"].shape == (
        cfg.vocab_size, cfg.d_model)


def test_without_a_card_the_launcher_exits_with_the_no_cuda_error():
    code = ("from repro_torch.launch.train import main; "
            "main(['--steps', '1'])")
    proc = subprocess.run(
        [sys.executable, "-c", code], capture_output=True, text=True,
        timeout=120, env={**os.environ, "PYTHONPATH": str(ROOT / "src"),
                          "CUDA_VISIBLE_DEVICES": ""})
    assert proc.returncode != 0
    assert "no CUDA device" in proc.stderr
    assert "arch=" not in proc.stdout


def test_unported_modes_raise_naming_their_items(capsys):
    # --kb-connect is ported: with --makers the trainer takes 2 steps
    # against a port bank served on the wire
    d = get_config("yi-6b").reduced().d_model
    bank = KnowledgeBankServer(64, d, device="cpu")
    wire = KBTransportServer(bank, "127.0.0.1", 0)
    try:
        out = train.main(CPU_RUN[:2] + ["--steps", "2"] + CPU_RUN[4:]
                         + ["--makers", "graph_builder", "--kb-connect",
                            f"127.0.0.1:{wire.port}"])
    finally:
        wire.close()
        bank.close()
    lines = capsys.readouterr().out.splitlines()
    assert lines[1] == (f"async CARLS: trainer + makers ['graph_builder'] "
                        f"over the wire (bank at 127.0.0.1:{wire.port}: "
                        f"64x{d})")
    res = out["result"]
    assert len(res.losses) == 2 and np.isfinite(res.losses).all()
    assert wire.requests_served > 0 and bank.metrics["lookups"] >= 2
    with pytest.raises(SystemExit):     # JAX's argument error comes first
        train.main(CPU_RUN + ["--kb-connect", "127.0.0.1:7787"])


@pytest.fixture
def fake_card(monkeypatch):
    """A CUDA device that the launcher believes in, a generator for it
    (this torch has none for CUDA), and an LM.init that fails the test if
    any parameter is built."""
    monkeypatch.setattr(train, "resolve_device",
                        lambda device="cuda": torch.device(device))
    cpu_generator = torch.Generator
    monkeypatch.setattr(torch, "Generator",
                        lambda device=None: cpu_generator())

    def no_init(self, gen):
        raise AssertionError("parameters were built")

    monkeypatch.setattr(LM, "init", no_init)


@pytest.mark.parametrize("argv", [["--arch", "rwkv6-7b"],
                                  ["--arch", "jamba-1.5-large-398b"],
                                  ["--seq", "2048"]])
def test_card_refuses_configs_without_a_backward_before_params(fake_card,
                                                               argv):
    """The configs this test once saw refused (an rwkv6 or Mamba mixer,
    attention over 2048 tokens) now reach parameter building on the card:
    nothing refuses them up front."""
    with pytest.raises(AssertionError, match="parameters were built"):
        train.main(argv + ["--steps", "1"])


# the kernel each mixer's training forward reaches on the card
MIXER_KERNEL = {"attn": "flash_attention", "rwkv6": "rwkv_wkv",
                "mamba": "mamba_scan"}


def test_trainable_rule():
    """The rule that once refused configs on the card is gone: every mixer
    of the ten archs reaches a kernel that has a backward launcher, and
    the trainer keeps no refusal."""
    assert not hasattr(trainer, "require_trainable_on_device")
    assert train.TRAINED_ARCHS == tuple(ARCH_IDS)
    mixers = set()
    for arch in ARCH_IDS:
        mixers |= {m for m, _ in build_model(get_config(arch).reduced()).spec}
    assert mixers == set(MIXER_KERNEL)
    for kernel in MIXER_KERNEL.values():
        assert f"{kernel}_bwd" in ops.LAUNCHERS, kernel
    yi = get_config("yi-6b")
    assert build_model(yi.reduced()).spec == [("attn", "swiglu")]
