"""The port's cross-process launchers on the CPU (``--device cpu``), each
bank, member, worker and trainer its own OS process:

- ``serve --kb --listen 127.0.0.1:0`` with ``maker_worker --connect
  --makers graph_builder --steps N``: the worker writes rows and exits 0,
  and the bank serves its wire requests;
- ``train --makers graph_builder --kb-connect`` against that bank: losses
  finite, the "over the wire" line of the JAX launcher;
- members ``--kb-join 0/2`` and ``1/2`` and a ``--replica-of`` standby of
  member 0 behind a port ``KBRouter``: SIGKILL member 0 while writes
  stream, the router promotes the standby, and every acknowledged write
  reads back;
- ``fleet --partitions 2 --replicas 1 --seconds`` with a graph-builder
  pack: every child's exit code printed, and 0;
- the serve launcher's fleet refusals in the JAX launcher's words, and
  ``--kb-partitions 3 --kb-replicas 2`` in one process.

Every subprocess is waited on with a timeout, and killed past it.
"""
import os
import re
import select
import signal
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest

from repro_torch.core import PartitionMap, connect_kb
from repro_torch.launch import serve

ROOT = Path(__file__).resolve().parents[1]
ENV = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
BOOT_S = 120.0
RUN_S = 180.0
D = 128                 # the reduced yi-6b's d_model


def _boot(argv, name):
    """Start ``serve`` with ``argv``; return (proc, port) once it prints
    its listening line, within BOOT_S."""
    proc = subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.serve", "--kb",
         "--device", "cpu", "--listen", "127.0.0.1:0", *argv],
        env=ENV, cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        stdin=subprocess.DEVNULL, text=True)
    lines, deadline = [], time.time() + BOOT_S
    while time.time() < deadline:
        ready, _, _ = select.select([proc.stdout], [], [], 1.0)
        if not ready:
            if proc.poll() is not None:
                break
            continue
        line = proc.stdout.readline()
        if not line:
            break
        lines.append(line)
        m = re.search(r"listening on 127\.0\.0\.1:(\d+)", line)
        if m:
            return proc, int(m.group(1))
    proc.kill()
    proc.communicate(timeout=30)
    raise AssertionError(f"{name} never listened:\n{''.join(lines)}")


def _stop(proc, sig=signal.SIGTERM):
    """Signal a child and collect its output, killing it past RUN_S."""
    if proc.poll() is None:
        proc.send_signal(sig)
    try:
        out, _ = proc.communicate(timeout=RUN_S)
    except subprocess.TimeoutExpired:
        proc.kill()
        out, _ = proc.communicate(timeout=30)
    return out


def _run(module, argv):
    return subprocess.run([sys.executable, "-m", module, *argv], env=ENV,
                          cwd=ROOT, capture_output=True, text=True,
                          stdin=subprocess.DEVNULL, timeout=RUN_S)


@pytest.fixture(scope="module")
def bank():
    """One ``serve --listen`` bank of 64 x 128 for the module's clients."""
    proc, port = _boot(["--kb-entries", "64", "--kb-dim", str(D)], "bank")
    yield port
    out = _stop(proc)
    assert proc.returncode == 0, out
    assert re.search(r"kb-serve backend=cuda search=exact coalesce=True "
                     r"\d+ connections, \d+ wire requests", out), out
    assert "kb device: type=cpu launches=" in out


def test_maker_worker_process_writes_rows_over_the_wire(bank):
    proc = _run("repro_torch.launch.maker_worker",
                ["--connect", f"127.0.0.1:{bank}", "--makers",
                 "graph_builder", "--steps", "3", "--batch", "8"])
    assert proc.returncode == 0, proc.stderr
    m = re.search(r"maker-worker done: steps=(\d+) rows_written=(\d+) "
                  r"errors=0 reconnects=0 reissued=0", proc.stdout)
    assert m and int(m.group(1)) >= 3 and int(m.group(2)) > 0, proc.stdout
    assert (f"maker-worker connected to 127.0.0.1:{bank} (bank: 64 x {D}, "
            "corpus nodes: 64)") in proc.stdout


def test_trainer_process_trains_against_the_bank(bank):
    proc = _run("repro_torch.launch.train",
                ["--device", "cpu", "--makers", "graph_builder",
                 "--kb-connect", f"127.0.0.1:{bank}", "--steps", "3",
                 "--batch", "2", "--seq", "16", "--nodes", "64",
                 "--maker-period", "0.05"])
    assert proc.returncode == 0, proc.stderr
    lines = proc.stdout.splitlines()
    assert lines[1] == ("async CARLS: trainer + makers ['graph_builder'] "
                        f"over the wire (bank at 127.0.0.1:{bank}: 64x{D})")
    m = re.search(r"loss (\d+\.\d+) -> (\d+\.\d+) over 3 steps", lines[2])
    assert m and all(np.isfinite(float(x)) for x in m.groups())
    assert lines[4] == "kb transport: reconnects=0 reissued=0"
    assert lines[5].startswith("maker graph_builder0: steps=")


def test_sigkilled_member_is_replaced_by_its_standby():
    """Members 0/2, 1/2 and a standby of 0 booted from it; writes stream
    through a router, member 0 is SIGKILLed between two of them, and
    every acknowledged write reads back from the healed fleet."""
    n = 200
    common = ["--kb-entries", str(n), "--kb-dim", "8"]
    p0, port0 = _boot(common + ["--kb-join", "0/2"], "p0")
    p1, port1 = _boot(common + ["--kb-join", "1/2"], "p1")
    s0, sport = _boot(common + ["--kb-join", "0/2", "--replica-of",
                                f"127.0.0.1:{port0}"], "s0")
    router = connect_kb(f"127.0.0.1:{port0}|127.0.0.1:{sport},"
                        f"127.0.0.1:{port1}", connect_timeout_s=10.0,
                        max_retries=0)
    try:
        assert router.standby_status() == [True, False]
        rng = np.random.default_rng(0)
        acked = {}
        for i in range(12):
            if i == 6:
                p0.kill()
                p0.wait(timeout=30)
            ids = rng.choice(n, 8, replace=False)
            vals = rng.normal(size=(8, 8)).astype(np.float32)
            router.update(ids, vals, src_step=i)
            acked.update({int(g): v for g, v in zip(ids, vals)})
        assert router.router_metrics["promotions"] == 1
        ids = np.array(sorted(acked))
        np.testing.assert_array_equal(router.lookup(ids),
                                      np.stack([acked[g] for g in ids]))
        owners = PartitionMap(n, 2).owner[ids]
        assert (owners == 0).any() and (owners == 1).any()
    finally:
        router.close()
        outs = [_stop(p) for p in (p1, s0)]
        _stop(p0, signal.SIGKILL)
    assert p1.returncode == 0 and s0.returncode == 0, outs


def test_fleet_launcher_boots_serves_and_tears_down():
    proc = _run("repro_torch.launch.fleet",
                ["--device", "cpu", "--partitions", "2", "--replicas", "1",
                 "--kb-entries", "300", "--kb-dim", "16", "--makers",
                 "graph_builder x2", "--maker-batch", "8", "--maker-steps",
                 "3", "--seconds", "12"])
    assert proc.returncode == 0, proc.stdout + proc.stderr
    codes = dict(re.findall(r"^fleet child (.+): exit (-?\d+)$", proc.stdout,
                            re.M))
    assert codes == {"maker graph_builder-0": "0",
                     "maker graph_builder-1": "0", "s0": "0", "s1": "0",
                     "p0": "0", "p1": "0"}, proc.stdout
    assert re.search(r"fleet ready: --kb-connect 127\.0\.0\.1:\d+\|"
                     r"127\.0\.0\.1:\d+,127\.0\.0\.1:\d+\|127\.0\.0\.1:\d+",
                     proc.stdout)
    assert "(ring-aligned)" in proc.stdout
    assert "fleet done: 2 members, 2 standbys, 2 makers (0 restarts)" \
        in proc.stdout


@pytest.mark.parametrize("argv,match", [
    (["--kb-join", "0/2"], "--kb-join requires --listen"),
    (["--kb-join", "2/2", "--listen", "127.0.0.1:0"], "index out of range"),
    (["--kb-join", "x", "--listen", "127.0.0.1:0"], "wants I/N"),
    (["--replica-of", "127.0.0.1:1"], "--replica-of requires --kb-join"),
])
def test_serve_refuses_a_malformed_member_in_the_jax_words(argv, match):
    with pytest.raises(SystemExit, match=match):
        serve.main(["--kb", "--device", "cpu", "--kb-entries", "64",
                    "--kb-dim", "8", *argv])


@pytest.mark.parametrize("argv", [
    ["--kb-replicas", "1"],
    ["--kb-partitions", "2", "--listen", "127.0.0.1:0"],
    ["--kb-partitions", "2", "--kb-search", "ivf"],
])
def test_serve_refuses_fleet_options_it_cannot_pair(argv, capsys):
    with pytest.raises(SystemExit):
        serve.main(["--kb", "--device", "cpu", "--kb-entries", "64",
                    "--kb-dim", "8", *argv])
    assert "--kb-" in capsys.readouterr().err


def test_in_process_partitions_with_standbys_and_spares(capsys):
    res = serve.main(["--kb", "--device", "cpu", "--kb-entries", "300",
                      "--kb-dim", "16", "--kb-partitions", "3",
                      "--kb-replicas", "2", "--clients", "3", "--gen", "3"])
    out = capsys.readouterr().out.splitlines()
    assert out[0].startswith("kb-serve partitions=3 backend=cuda "
                             "replicas=2 reorder=False clients=3: ")
    pm = PartitionMap(300, 3)
    for p in range(3):
        assert out[2 + p].startswith(f"  partition {p}/3: "
                                     f"{int(pm.counts[p])} rows, ")
    st = res["stats"]
    assert st["router"]["standbys"] == 3 and st["router"]["spares"] == 3
    assert res["calls"] == 3 * 3 * 3
    # each standby holds its primary's rows, every teed write included
    for p in range(3):
        np.testing.assert_array_equal(res["standbys"][2 * p].table_snapshot(),
                                      res["servers"][p].table_snapshot())
