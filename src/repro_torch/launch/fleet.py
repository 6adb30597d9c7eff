"""Fleet launcher: a self-healing partitioned Knowledge-Bank deployment in
one command; the port of ``repro.launch.fleet``.

  PYTHONPATH=src python -m repro_torch.launch.fleet --partitions 2 \\
      --replicas 1 --makers "graph_builder x8" --seconds 30

Boots, supervises and tears down the cross-process serving side, each
child a fresh ``python -m`` process started by ``subprocess`` (never a
fork of a process that holds a CUDA context), each on ``--device``:

1. N partition members, ``repro_torch.launch.serve --kb --kb-join p/N
   --listen host:0``, one process each, their ephemeral ports read from
   their "listening on" lines (``--kb-entries`` is the GLOBAL bank size;
   each member hosts only its slice of the ring).
2. With ``--replicas 1``, one standby a member, ``serve --kb-join p/N
   --replica-of host:port_p``: it copies its primary's full row state
   (every leaf, bit for bit) and serves beside it. Clients dial the fleet
   with the ``host:p0|host:s0,...`` ``--kb-connect`` syntax; their routers
   attach the standbys and promote one when its primary dies.
3. Maker packs, ``--makers "graph_builder x8"`` (a comma list for several
   kinds): that many ``repro_torch.launch.maker_worker`` processes a
   kind, each pinned to ``--node-slice i/M``, ring-aligned so that every
   maker batch lands on one member.

The supervisor restarts makers that CRASH (a non-zero exit; a clean
``--steps`` / ``--seconds`` exit stays down) and logs member deaths (a
member with a standby needs no restart: its clients promote the
standby). SIGINT/SIGTERM (or ``--seconds``) tears everything down, makers
first, and prints each child's exit code and the restart count.

The connect spec is printed on boot (``fleet ready: --kb-connect ...``),
so that trainers can attach: ``repro_torch.launch.train --makers ...
--kb-connect <spec>``.
"""
from __future__ import annotations

import argparse
import os
import re
import select
import signal
import subprocess
import sys
import time
from pathlib import Path

STARTUP_TIMEOUT_S = 300         # a member's fill, kernel build and warm-up
SRC = Path(__file__).resolve().parents[2]


def _parse_maker_packs(spec: str):
    """'graph_builder x8,embedding_refresh x2' -> [(kind, count), ...]"""
    packs = []
    for item in spec.split(","):
        item = item.strip()
        if not item:
            continue
        m = re.fullmatch(r"(\w+)(?:\s*x\s*(\d+))?", item)
        if not m:
            raise ValueError(f"bad --makers pack {item!r} "
                             "(want 'kind' or 'kind xN')")
        packs.append((m.group(1), int(m.group(2) or 1)))
    return packs


class Fleet:
    def __init__(self, args):
        self.args = args
        self.members = []       # (proc, port) per partition, ring order
        self.standbys = []      # (proc, port) or None per partition
        self.makers = []        # dicts: proc / cmd / name / restarts
        self.maker_restarts = 0
        self._dead_members = set()
        self.env = dict(os.environ)
        self.env["PYTHONPATH"] = (str(SRC) + os.pathsep
                                  + self.env.get("PYTHONPATH", ""))

    # -- child bootstrapping ----------------------------------------------

    def _serve_cmd(self, slot: int, extra):
        a = self.args
        return [sys.executable, "-m", "repro_torch.launch.serve", "--kb",
                "--kb-entries", str(a.kb_entries), "--kb-dim",
                str(a.kb_dim), "--kb-storage", a.kb_storage,
                "--seed", str(a.seed), "--device", a.device,
                "--kb-join", f"{slot}/{a.partitions}",
                "--listen", f"{a.host}:0", "--serve-seconds", "0",
                *extra]

    def _boot_server(self, cmd, name):
        """Start a serve child; return (proc, port) once it reports
        listening. A select with a deadline: a wedged child fails at the
        start-up budget with its output attached, not silently."""
        proc = subprocess.Popen(cmd, env=self.env, stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)
        lines = []
        deadline = time.time() + STARTUP_TIMEOUT_S
        while True:
            if time.time() > deadline:
                proc.kill()
                proc.wait()
                raise RuntimeError(
                    f"{name} never reported listening within "
                    f"{STARTUP_TIMEOUT_S}s:\n" + "".join(lines))
            ready, _, _ = select.select([proc.stdout], [], [], 5.0)
            if not ready:
                if proc.poll() is not None:
                    raise RuntimeError(
                        f"{name} exited early:\n{''.join(lines)}")
                continue
            line = proc.stdout.readline()
            if not line:
                proc.wait()
                raise RuntimeError(f"{name} exited early (exit "
                                   f"{proc.returncode}):\n" + "".join(lines))
            lines.append(line)
            print(f"[{name}]", line, end="", flush=True)
            m = re.search(r"listening on [\d.]+:(\d+)", line)
            if m:
                return proc, int(m.group(1))

    def connect_spec(self) -> str:
        legs = []
        for p, (_, port) in enumerate(self.members):
            leg = f"{self.args.host}:{port}"
            if self.standbys[p] is not None:
                leg += f"|{self.args.host}:{self.standbys[p][1]}"
            legs.append(leg)
        return ",".join(legs)

    def _maker_cmd(self, kind: str, idx: int, total: int):
        a = self.args
        cmd = [sys.executable, "-m", "repro_torch.launch.maker_worker",
               "--connect", self.connect_spec(), "--makers", kind,
               "--node-slice", f"{idx}/{total}",
               "--batch", str(a.maker_batch), "--steps",
               str(a.maker_steps), "--period", str(a.maker_period),
               "--seed", str(a.seed + idx), "--device", a.device,
               "--client-name", f"fleet-{kind}-{idx}"]
        if a.ckpt_dir:
            cmd += ["--ckpt-dir", a.ckpt_dir, "--arch", a.arch]
        return cmd

    def start(self):
        a = self.args
        for p in range(a.partitions):
            self.members.append(self._boot_server(
                self._serve_cmd(p, []), f"p{p}"))
            self.standbys.append(None)
        if a.replicas:
            for p, (_, port) in enumerate(self.members):
                self.standbys[p] = self._boot_server(
                    self._serve_cmd(
                        p, ["--replica-of", f"{a.host}:{port}"]),
                    f"s{p}")
        print(f"fleet ready: --kb-connect {self.connect_spec()}",
              flush=True)
        for kind, count in _parse_maker_packs(a.makers):
            for i in range(count):
                cmd = self._maker_cmd(kind, i, count)
                self.makers.append({
                    "name": f"{kind}-{i}", "cmd": cmd,
                    "proc": subprocess.Popen(cmd, env=self.env),
                    "restarts": 0})
        if self.makers:
            print(f"fleet makers: {len(self.makers)} workers", flush=True)

    # -- supervision -------------------------------------------------------

    def supervise_once(self):
        """One supervision tick: restart crashed makers, log member deaths
        (a member with a standby heals client-side, with no restart)."""
        for m in self.makers:
            rc = m["proc"].poll()
            if rc is None or rc == 0:
                continue
            m["restarts"] += 1
            self.maker_restarts += 1
            print(f"fleet: maker {m['name']} crashed (exit {rc}), "
                  f"restarting (x{m['restarts']})", flush=True)
            m["proc"] = subprocess.Popen(m["cmd"], env=self.env)
        for p, (proc, port) in enumerate(self.members):
            if proc.poll() is not None and p not in self._dead_members:
                self._dead_members.add(p)
                sb = ("standby takes over on the next client request"
                      if self.standbys[p] is not None
                      else "NO standby: clients owning its rows fail")
                print(f"fleet: member p{p} ({self.args.host}:{port}) "
                      f"exited {proc.returncode}; {sb}", flush=True)

    def shutdown(self) -> dict:
        """Makers first (they dial the members), then the bank fleet.
        Returns {child name: exit code}, also printed."""
        codes = {}
        for m in self.makers:
            if m["proc"].poll() is None:
                m["proc"].send_signal(signal.SIGTERM)
        for m in self.makers:
            try:
                m["proc"].wait(timeout=60)
            except subprocess.TimeoutExpired:
                m["proc"].kill()
                m["proc"].wait()
            codes[f"maker {m['name']}"] = m["proc"].returncode
        for group in (self.standbys, self.members):
            for item in group:
                if item is not None and item[0].poll() is None:
                    item[0].send_signal(signal.SIGTERM)
        for group, tag in ((self.standbys, "s"), (self.members, "p")):
            for i, item in enumerate(group):
                if item is None:
                    continue
                proc, _ = item
                try:
                    out, _ = proc.communicate(timeout=60)
                except subprocess.TimeoutExpired:
                    proc.kill()
                    out, _ = proc.communicate()
                if out:
                    print(f"[{tag}{i}]", out, flush=True)
                codes[f"{tag}{i}"] = proc.returncode
        for name, rc in codes.items():
            print(f"fleet child {name}: exit {rc}", flush=True)
        print(f"fleet done: {len(self.members)} members, "
              f"{sum(s is not None for s in self.standbys)} standbys, "
              f"{len(self.makers)} makers "
              f"({self.maker_restarts} restarts)", flush=True)
        return codes


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--partitions", type=int, default=2,
                    help="fleet members (consistent-hash ring slots)")
    ap.add_argument("--replicas", type=int, default=0, choices=[0, 1],
                    help="standbys a member (serve --replica-of): routers "
                         "promote one when its primary dies")
    ap.add_argument("--makers", default="",
                    help="maker packs, e.g. 'graph_builder x8' or "
                         "'embedding_refresh x4,graph_builder x2': each "
                         "pack spawns count maker_worker processes with "
                         "ring-aligned --node-slice i/count")
    ap.add_argument("--kb-entries", type=int, default=4096,
                    help="GLOBAL bank rows (split across members)")
    ap.add_argument("--kb-dim", type=int, default=64)
    ap.add_argument("--kb-storage", choices=["fp32", "int8"],
                    default="fp32")
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--maker-batch", type=int, default=64)
    ap.add_argument("--maker-steps", type=int, default=0,
                    help="per-worker step cap (0 = run until shutdown)")
    ap.add_argument("--maker-period", type=float, default=0.0,
                    help="per-maker pacing floor in seconds")
    ap.add_argument("--ckpt-dir", default="",
                    help="checkpoint dir for checkpoint-loading maker kinds")
    ap.add_argument("--arch", default="yi-6b",
                    help="model arch for checkpoint-loading maker kinds")
    ap.add_argument("--seconds", type=float, default=0.0,
                    help="run this long then tear down (0 = until "
                         "SIGINT/SIGTERM)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="every child's device: cuda (default) or cpu")
    return ap


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    fleet = Fleet(args)
    stop = {"flag": False}
    for sig in (signal.SIGINT, signal.SIGTERM):
        signal.signal(sig, lambda *_: stop.update(flag=True))
    try:
        fleet.start()
        deadline = (time.time() + args.seconds) if args.seconds else None
        while not stop["flag"]:
            if deadline is not None and time.time() > deadline:
                break
            fleet.supervise_once()
            time.sleep(0.2)
    finally:
        fleet.shutdown()
    return 0


if __name__ == "__main__":
    sys.exit(main())
