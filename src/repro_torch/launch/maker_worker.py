"""Standalone knowledge-maker worker: any maker kind as its own OS process
against a remote Knowledge Bank; the port of ``repro.launch.maker_worker``.

  # terminal 1: host the bank
  PYTHONPATH=src python -m repro_torch.launch.serve --kb \\
      --listen 127.0.0.1:7787

  # terminal 2..N: a maker fleet, one process each
  PYTHONPATH=src python -m repro_torch.launch.maker_worker \\
      --connect 127.0.0.1:7787 --makers graph_builder --steps 50

The paper's deployment shape for knowledge makers (§2: independent jobs
"across hardware platforms" sharing the bank): the worker dials the bank
over the TCP transport (``repro_torch.core.kb_transport``; a bank of
either package), polls its OWN checkpoint directory (``--ckpt-dir``, the
cross-process weight channel, needed by every maker kind except
``graph_builder``), paces itself and crashes alone. The makers are the
unchanged ``MakerRuntime`` jobs: the only difference from an in-process
run is the ``KBClient`` they hold.

``graph_builder`` builds no model: its lookups and searches run in the
bank's process. The checkpoint-loading kinds build the reduced config of
``--arch`` (``--layers`` cuts it), as the JAX worker does, on
``--device`` (default ``cuda``; ``cpu`` when asked), where their
embedding pass runs.

Exit status: 0 after a clean run, 2 when the makers produced no steps and
only errors (so supervisors can tell a dead worker from a quiet one).
"""
from __future__ import annotations

import argparse
import signal
import sys
import threading
import time

import numpy as np
import torch

from repro_torch.checkpoint import DiskCheckpointStore
from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.core.async_runtime import MakerRuntime, format_maker_stats
from repro_torch.core.kb_router import connect_kb
from repro_torch.core.knowledge_maker import make_embed_fn
from repro_torch.data import SyntheticGraphCorpus
from repro_torch.env import resolve_device
from repro_torch.models import build_model


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--connect", required=True,
                    metavar="HOST:PORT[,HOST:PORT,...]",
                    help="knowledge-bank endpoint (serve --listen); a comma "
                         "list names a partitioned fleet in ring order "
                         "(serve --kb-join), routed through a KBRouter")
    ap.add_argument("--makers", default="graph_builder",
                    help="comma list of maker kinds to run in this process "
                         "(embedding_refresh,label_mining,graph_agreement,"
                         "graph_builder)")
    ap.add_argument("--arch", choices=ARCH_IDS, default="yi-6b",
                    help="model arch for checkpoint-loading makers")
    ap.add_argument("--layers", type=int, default=0)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--nodes", type=int, default=0,
                    help="corpus nodes; 0 = the bank's num_entries (from "
                         "the wire handshake)")
    ap.add_argument("--clusters", type=int, default=4)
    ap.add_argument("--labeled-frac", type=float, default=0.3)
    ap.add_argument("--label-noise", type=float, default=0.3)
    ap.add_argument("--batch", type=int, default=64)
    ap.add_argument("--period", type=float, default=0.0,
                    help="per-maker pacing floor in seconds")
    ap.add_argument("--node-slice", default="", metavar="I/N",
                    help="be worker I of an N-worker pack: touch only slice "
                         "I of the node space (ring-aligned against a "
                         "fleet whose member count divides N, else "
                         "round-robin)")
    ap.add_argument("--steps", type=int, default=0,
                    help="stop after this many maker steps in all (0 = run "
                         "until SIGINT/SIGTERM)")
    ap.add_argument("--seconds", type=float, default=0.0,
                    help="wall-clock cap (0 = none)")
    ap.add_argument("--ckpt-dir", default=None,
                    help="checkpoint directory to poll (needed by the "
                         "checkpoint-loading makers)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--client-name", default="",
                    help="free-form label sent in the wire handshake")
    ap.add_argument("--max-retries", type=int, default=3,
                    help="transport redials per request (at-least-once)")
    ap.add_argument("--reconnect-backoff", type=float, default=0.05,
                    help="exponential-backoff base (s) between redials")
    ap.add_argument("--sock-buf", type=int, default=0,
                    help="SO_SNDBUF/SO_RCVBUF bytes (0 = OS default)")
    ap.add_argument("--device", default="cuda",
                    help="where checkpoint-loading makers embed: cuda "
                         "(default) or cpu")
    return ap


def _node_slice(ap, args, client, n: int):
    """``--node-slice I/N``: this worker's node ids, ring-aligned against a
    fleet whose member count divides N (each batch stays on one member,
    the router's no-copy path), else a round-robin 1-in-N slice."""
    try:
        w_idx, w_total = (int(x) for x in args.node_slice.split("/"))
    except ValueError:
        ap.error(f"--node-slice wants I/N, got {args.node_slice!r}")
    if not (0 <= w_idx < w_total):
        ap.error(f"--node-slice {args.node_slice}: index out of range")
    slices = getattr(client, "partition_slices", None)
    parts = slices() if slices is not None else []
    if parts and w_total % len(parts) == 0:
        mine = parts[w_idx % len(parts)]
        node_slice = mine[w_idx // len(parts)::w_total // len(parts)]
    else:
        node_slice = np.arange(n)[w_idx::w_total]
    node_slice = node_slice[node_slice < n]
    print(f"maker-worker node-slice {args.node_slice}: {node_slice.size} of "
          f"{n} nodes{' (ring-aligned)' if parts else ''}", flush=True)
    return node_slice


def main(argv=None) -> int:
    ap = build_parser()
    args = ap.parse_args(argv)
    kinds = [k.strip() for k in args.makers.split(",") if k.strip()]
    needs_ckpt = any(k != "graph_builder" for k in kinds)
    # the device is checked first: a worker that would embed on a card it
    # lacks stops before it dials the bank
    device = resolve_device(args.device) if needs_ckpt else None
    client = connect_kb(
        args.connect,
        client_name=args.client_name or f"maker-worker:{','.join(kinds)}",
        max_retries=args.max_retries,
        reconnect_backoff_s=args.reconnect_backoff, sock_buf=args.sock_buf)
    n = args.nodes or client.num_entries
    if n > client.num_entries:
        client.close()
        ap.error(f"--nodes {n} exceeds the bank's {client.num_entries} "
                 "entries")
    print(f"maker-worker connected to {args.connect} (bank: "
          f"{client.num_entries} x {client.dim}, corpus nodes: {n})",
          flush=True)

    corpus = ckpts = embed = None
    if needs_ckpt:
        if not args.ckpt_dir:
            client.close()
            ap.error(f"makers {kinds} load checkpoints: pass --ckpt-dir")
        cfg = get_config(args.arch).reduced()
        if args.layers:
            cfg = cfg.replace(num_layers=args.layers)
        if cfg.d_model != client.dim:
            client.close()
            ap.error(f"model d_model {cfg.d_model} != bank dim {client.dim}")
        model = build_model(cfg)
        # the init parameters are a template of shapes, dtypes and the
        # device only: every loaded checkpoint replaces the values
        ckpts = DiskCheckpointStore(args.ckpt_dir, template=model.init(
            torch.Generator(device=device).manual_seed(args.seed)))
        embed = make_embed_fn(model)
        corpus = SyntheticGraphCorpus(
            num_nodes=n, vocab_size=cfg.vocab_size, seq_len=args.seq + 1,
            neighbors_per_node=cfg.carls.num_neighbors,
            num_clusters=args.clusters, labeled_frac=args.labeled_frac,
            label_noise=args.label_noise, seed=args.seed)

    node_slice = (_node_slice(ap, args, client, n) if args.node_slice
                  else None)
    rt = MakerRuntime(client, corpus,
                      num_entries=None if corpus is not None else n,
                      ckpts=ckpts, embed_fn=embed,
                      device=device if device is not None else "cpu")
    for kind in kinds:
        rt.register(kind, batch_size=args.batch, min_period_s=args.period,
                    node_slice=node_slice)

    stop = threading.Event()
    for sig in (signal.SIGINT, signal.SIGTERM):
        signal.signal(sig, lambda *_: stop.set())
    deadline = time.time() + args.seconds if args.seconds else None
    rt.start()
    while not stop.is_set():
        if args.steps and sum(j.steps for j in rt.jobs) >= args.steps:
            break
        if deadline is not None and time.time() > deadline:
            break
        stop.wait(0.05)
    rt.stop()

    for line in format_maker_stats(rt.stats()):
        print(line)
    steps = sum(j.steps for j in rt.jobs)
    rows = sum(j.rows_written for j in rt.jobs)
    errors = sum(j.errors for j in rt.jobs)
    try:
        tstats = client.stats().get("transport", {})
    except Exception:       # the bank is gone already: the counters are
        tstats = {}         # the client's but ride on a stats() round trip
    extra = (f" reconnects={tstats.get('reconnects', 0)}"
             f" reissued={tstats.get('reissued', 0)}" if tstats else "")
    print(f"maker-worker done: steps={steps} rows_written={rows} "
          f"errors={errors}{extra}", flush=True)
    client.close()
    return 2 if (steps == 0 and errors > 0) else 0


if __name__ == "__main__":
    sys.exit(main())
