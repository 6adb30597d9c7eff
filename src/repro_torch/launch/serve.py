"""Serving on the port: LM prefill + greedy decode, and the in-process
client mode of ``repro.launch.serve --kb``.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch yi-6b \
      --batch 2 --prompt-len 8 --gen 4
  PYTHONPATH=src python -m repro_torch.launch.serve --arch rwkv6-7b \
      --batch 2 --prompt-len 16 --gen 4
  PYTHONPATH=src python -m repro_torch.launch.serve \
      --arch jamba-1.5-large-398b --batch 2 --prompt-len 16 --gen 4
  PYTHONPATH=src python -m repro_torch.launch.serve --arch whisper-tiny \
      --batch 2 --prompt-len 8 --gen 4

LM mode (no ``--kb``) does what the JAX launcher's does: the reduced
config of ``--arch``, random weights from ``--seed`` (here a
``torch.Generator`` on the device), prompts from
``np.random.default_rng(seed)``, the front-end's inputs as zeros of
(batch, ``num_frontend_tokens``, d_model) (internvl2-2b's patch
embeddings, whisper-tiny's frames), prefill into a cache of
``prompt_len + gen + prefix + 1`` slots (the prefix: internvl's patches),
then ``--gen`` greedy decode steps fed the prompt's last token first (so,
as in the JAX launcher, that token is seen twice: at its position and at
position ``prompt_len``). It prints the JAX launcher's two lines. Every
arch of ``ARCH_IDS`` serves (``repro_torch.models.PORTED_ARCHS``). On the
card each prefill attention layer over at least 2048^2 (query, key)
pairs runs on the flash-attention kernel (kimi-k2's heads of 112
included), and whisper's encoder layers always do; rwkv6-7b's WKV
recurrence runs on the WKV kernel and jamba's Mamba layers on the scan
kernel; the MoE feed-forwards, cross-attention and decode are plain
products. ``serve_lm`` takes any config of the archs, the unreduced one
or a cut of it included (a published config that does not fit one card
serves cut in depth and experts, e.g. ``get_config(
"jamba-1.5-large-398b").replace(num_layers=8, num_experts=8)``), and
optional parameters and front-end inputs.

  PYTHONPATH=src python -m repro_torch.launch.serve --kb

stands up the request-coalescing ``KnowledgeBankServer`` on the CUDA
kernel backend, fills the bank with N(0, 1) rows from ``--seed``, and
drives it with ``--clients`` threads, each looping lookup ->
lazy_grad(0.01 * vals) -> nn_search(k=8) ``--gen`` times. It prints the
JAX launcher's summary lines and ends with a ``flush`` of the served
bank. The default bank is ogbn-mag sized: 1,939,743 rows (all node types
of OGB's ogbn-mag) of width 128 (its feature width), fp32, 2.02 GB with
its gradient caches.

``--kb-storage int8`` stores the rows as int8 codes with a per-row scale
and offset; ``--kb-search ivf`` serves nn_search from the IVF index that a
background refresher builds (``--nlist`` buckets, ``--nprobe`` probed per
query): the launcher waits for the first build before the clients start.

  PYTHONPATH=src python -m repro_torch.launch.serve --kb \
      --kb-storage int8 --kb-search ivf

``--kb-backend sharded --kb-shards S`` serves the bank as S logical shards
of one device (``repro_torch.core.kb_engine.ShardedBackend``; the JAX
launcher's shard count is its mesh's size): with ``--kb-search ivf`` each
shard has its own sub-index of ``--nlist`` buckets, probed ``--nprobe`` at
a time, the refresher rebuilds only the shards written past their own
budget, and the summary ends with one line per shard. ogbn-mag's
1,939,743 rows divide by 3 (and 9, 13, 39, 59), not by 2 or 4:

  PYTHONPATH=src python -m repro_torch.launch.serve --kb \
      --kb-backend sharded --kb-shards 3 --kb-search ivf

``--kb-resident-rows R`` keeps R rows of the bank in device slots and
the rest in a host-RAM cold store (``--kb-cold-dir DIR``: one file a row
on disk), faulting rows in as requests touch them; ``--kb-cold-after A``
spills rows untouched for A written rows. The fill then goes in chunks
of R rows, and the storage line shows the slots, the cold rows and the
tier's faults and spills. ogbn-mag at four times its device tier:

  PYTHONPATH=src python -m repro_torch.launch.serve --kb \
      --kb-resident-rows 484936 --kb-cold-after 242468

``--kb-makers KIND[,KIND...]`` runs the checkpoint-free knowledge makers
(``graph_builder``) beside the serving bank, as background clients of the
same server paced by ``--kb-maker-period`` seconds (their traffic shares
the server, so the timed req/s includes it); their counters print after
the summary:

  PYTHONPATH=src python -m repro_torch.launch.serve --kb --device cpu \
      --kb-entries 300 --kb-dim 16 --gen 4 --kb-makers graph_builder

``--listen HOST:PORT`` exposes the same bank on the TCP wire protocol v4
(``repro_torch.core.kb_transport``) instead of driving local clients:
trainers (``launch/train.py --kb-connect``) and maker workers
(``launch/maker_worker.py --connect``) in other processes, of either
package, connect to it and their requests coalesce with any in-process
traffic. Port 0 binds an ephemeral port, printed on the "listening"
line. It serves until SIGINT/SIGTERM or ``--serve-seconds``, then prints
the serving summary and a ``kb device:`` line (this process's kernel
launches and peak device memory). The v4 knobs are the JAX launcher's:
``--max-inflight``, ``--max-inflight-control``, ``--max-inflight-bulk``,
``--cork-us``, ``--scheduler`` and ``--sock-buf``.

  PYTHONPATH=src python -m repro_torch.launch.serve --kb \
      --listen 127.0.0.1:7787

Scale-out (``repro_torch.core.kb_router``): ``--kb-join I/N`` makes this
process partition I of an N-member fleet: it hosts only the rows the
consistent-hash ring assigns to slot I, filled by global id from the
same N(0, 1) table a single server would hold (``--kb-entries`` is the
global bank size), labels its handshake "I/N" and needs ``--listen``.
``--replica-of HOST:PORT`` boots a standby of that member: the same ring
slot, every row's full state copied from it bit for bit through
``ExportRowsRequest`` / ``import_rows``. Clients name the fleet in ring
order, a standby after ``|``: ``--kb-connect host:p0|host:s0,host:p1``.
``--kb-partitions N`` (with ``--kb-replicas R``: a warm standby and R - 1
cold spares a partition) runs the same fleet in one process, N servers
behind a ``KBRouter`` of in-process transports, and drives the router
with the local clients.

The run is on the CUDA device unless ``--device cpu`` is given: servers
and fleet members run their kernels on the card, and a member that
cannot launch them fails rather than serve a plain path. The JAX
launcher's ``--kb-autotuned`` is not ported yet: it raises
``NotImplementedError`` naming ROADMAP Q1 item 5c.
"""
from __future__ import annotations

import argparse
import signal
import threading
import time

import numpy as np
import torch

from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.core.async_runtime import (KnowledgeBankServer,
                                            MakerRuntime, format_maker_stats)
from repro_torch.core.kb_engine import make_backend
from repro_torch.core.kb_protocol import (PROTOCOL_VERSION,
                                          ExportRowsRequest,
                                          InProcessTransport)
from repro_torch.core.kb_router import KBRouter, PartitionMap
from repro_torch.core.kb_transport import (KBTransportServer,
                                           SocketTransport, parse_hostport)
from repro_torch.env import resolve_device
from repro_torch.kernels import ops
from repro_torch.models import build_model

OGBN_MAG_ROWS = 1_939_743
OGBN_MAG_DIM = 128
NN_K = 8


INDEX_BUILD_DEADLINE_S = 300.0
REPLICA_COPY_ROWS = 1024            # rows a replica boot copies a request


def _first_index(server, refresher) -> float:
    """Wait for the refresher's first index; returns the seconds it took.
    Raises on a failed build or past the deadline."""
    t0 = time.perf_counter()
    while server.engine.ann_index is None:
        if refresher.last_error is not None or not refresher.is_alive():
            raise RuntimeError("IVF index build failed") \
                from refresher.last_error
        if time.perf_counter() - t0 > INDEX_BUILD_DEADLINE_S:
            raise RuntimeError("IVF index build timed out")
        time.sleep(0.01)
    return time.perf_counter() - t0


def _member_slot(args):
    """``--kb-join I/N`` and ``--replica-of`` checked in the JAX
    launcher's order; returns (ring map or None, slot label, rows)."""
    pmap, label, rows = None, "", args.kb_entries
    if args.kb_join:
        try:
            idx, total = (int(x) for x in args.kb_join.split("/"))
        except ValueError:
            raise SystemExit(f"--kb-join wants I/N, got {args.kb_join!r}")
        if not (0 <= idx < total):
            raise SystemExit(f"--kb-join {args.kb_join}: index out of range")
        if not args.listen:
            raise SystemExit("--kb-join requires --listen (a fleet member "
                             "exists to serve remote routers)")
        # every member and router computes the same ring from
        # (kb_entries, N), so sizing agrees without a config channel
        pmap = PartitionMap(args.kb_entries, total)
        rows, label = int(pmap.counts[idx]), f"{idx}/{total}"
    elif args.replica_of:
        raise SystemExit("--replica-of requires --kb-join I/N (a standby "
                         "mirrors one ring slot)")
    return pmap, label, rows


def _replica_boot(server, args, label: str, rows: int) -> None:
    """A standby's boot: copy every row's full state (every leaf, bit for
    bit) from the member at ``--replica-of``, pinned to its ring slot."""
    host, port = parse_hostport(args.replica_of)
    src = SocketTransport(host, port, expect_partition=label)
    try:
        for lo in range(0, rows, REPLICA_COPY_ROWS):
            lids = np.arange(lo, min(lo + REPLICA_COPY_ROWS, rows))
            server.import_rows(lids,
                               src.request(ExportRowsRequest(lids)).leaves)
    finally:
        src.close()
    print(f"replica boot: copied {rows} rows from {args.replica_of} (slot "
          f"{label})", flush=True)


def _wire_serve(server, args, label: str, rows: int) -> dict:
    """Host ``server`` on the wire until SIGINT/SIGTERM or
    ``--serve-seconds``; returns the transport's counters."""
    host, port = parse_hostport(args.listen)
    transport = KBTransportServer(
        server, host, port, max_inflight=args.max_inflight,
        max_inflight_control=args.max_inflight_control or None,
        max_inflight_bulk=args.max_inflight_bulk or None,
        cork_us=args.cork_us, scheduler=args.scheduler,
        sock_buf=args.sock_buf, partition=label)
    part = (f"partition {label}, {rows} of {args.kb_entries} rows, "
            if label else "")
    print(f"kb server listening on {transport.host}:{transport.port} "
          f"(protocol v{PROTOCOL_VERSION}, backend={args.kb_backend}, "
          f"{part}bank {args.kb_entries}x{args.kb_dim}, "
          f"search={args.kb_search})", flush=True)
    stop = threading.Event()
    if threading.current_thread() is threading.main_thread():
        for sig in (signal.SIGINT, signal.SIGTERM):
            signal.signal(sig, lambda *_: stop.set())
    stop.wait(args.serve_seconds or None)
    out = {"connections": transport.connections_accepted,
           "wire_requests": transport.requests_served,
           "sendalls": transport.sendalls, "port": transport.port}
    transport.close()
    return out


def _drive(client, args):
    """``--clients`` threads, each looping lookup -> lazy_grad(0.01 *
    vals) -> nn_search(k=8) ``--gen`` times over ``client``; returns
    (seconds, calls)."""
    def run(t: int):
        crng = np.random.default_rng(args.seed + 1 + t)
        for _ in range(args.gen):
            ids = crng.integers(0, args.kb_entries, (args.batch,))
            vals = client.lookup(ids)
            client.lazy_grad(ids, 0.01 * vals)
            client.nn_search(vals, k=NN_K)

    threads = [threading.Thread(target=run, args=(t,))
               for t in range(args.clients)]
    t0 = time.perf_counter()
    for th in threads:
        th.start()
    for th in threads:
        th.join()
    return time.perf_counter() - t0, args.clients * args.gen * 3


def serve_kb(args) -> dict:
    """KB serving on the coalescing server: concurrent local clients, or
    (``--listen``) the wire for other processes, as a whole bank or as
    one fleet member (``--kb-join``, ``--replica-of``). Returns the run's
    numbers (also printed) and the closed server's engine."""
    if args.kb_shards != 1 and args.kb_backend != "sharded":
        raise ValueError("--kb-shards needs --kb-backend sharded")
    pmap, label, rows = _member_slot(args)
    rng = np.random.default_rng(args.seed)
    server = KnowledgeBankServer(rows, args.kb_dim,
                                 backend=make_backend(
                                     args.kb_backend,
                                     n_shards=args.kb_shards),
                                 coalesce=not args.no_coalesce,
                                 reorder=args.kb_reorder,
                                 search_mode=args.kb_search,
                                 ann_nlist=args.nlist,
                                 ann_nprobe=args.nprobe,
                                 storage=args.kb_storage,
                                 cache_rows=args.kb_cache_rows,
                                 resident_rows=args.kb_resident_rows,
                                 cold_after_rows=args.kb_cold_after,
                                 cold_dir=args.kb_cold_dir or None,
                                 device=args.device)
    t0 = time.perf_counter()
    if args.replica_of:
        _replica_boot(server, args, label, rows)
    else:
        fill = rng.standard_normal((args.kb_entries, args.kb_dim),
                                   dtype=np.float32)
        if pmap is not None:
            # keyed by GLOBAL id: a fleet's rows are a single server's
            fill = fill[pmap.global_ids(int(label.split("/")[0]))]
        # a tiered bank bounds the distinct rows one write may touch:
        # fill it in chunks that fit the resident tier
        chunk = args.kb_resident_rows or rows
        for lo in range(0, rows, chunk):
            hi = min(lo + chunk, rows)
            server.update(np.arange(lo, hi), fill[lo:hi])
        del fill
    fill_s = time.perf_counter() - t0
    server.warmup(args.batch * args.clients)
    refresher, build_s = None, None
    if args.kb_search == "ivf":
        # the index maker clusters the bank off the serving path; serve
        # once its first index is published
        refresher = server.start_ann_refresher(min_period_s=0.01)
        build_s = _first_index(server, refresher)
        # one search through the index first, so that the build of the
        # stage-2 kernel is not timed (warmup built the others)
        server.nn_search(np.zeros((args.batch, args.kb_dim), np.float32),
                         k=NN_K)
    runtime = None
    if args.kb_makers:
        # trainer-less serving hosts the checkpoint-free makers, paced:
        # their traffic shares the server with the timed clients
        runtime = MakerRuntime(server, num_entries=rows,
                               device=args.device)
        for kind in args.kb_makers.split(","):
            runtime.register(kind.strip(), batch_size=args.batch,
                             min_period_s=args.kb_maker_period)
        runtime.start()

    if args.listen:
        wire = _wire_serve(server, args, label, rows)
        summary = (f"{wire['connections']} connections, "
                   f"{wire['wire_requests']} wire requests "
                   f"({wire['sendalls']} sendalls), ")
        dt = calls = None
    else:
        wire = None
        dt, calls = _drive(server, args)
        summary = (f"clients={args.clients}: {calls / dt:.0f} req/s "
                   f"({dt / calls * 1e6:.0f} us/req), ")
    maker_stats = {}
    if runtime is not None:
        runtime.stop()
        maker_stats = server.maker_stats
    stats = dict(server.engine.search_stats)
    rebuilds = refresher.rebuilds if refresher else 0
    shard_rebuilds = refresher.shard_rebuilds if refresher else 0
    index = server.engine.ann_index
    server.flush()
    device = server.stats()["device"]
    server.close()
    print(f"kb-serve backend={args.kb_backend} search={args.kb_search} "
          f"coalesce={not args.no_coalesce} {summary}"
          f"coalescing x{server.coalescing_factor:.1f}, "
          f"{server.metrics['dispatches']} device dispatches for "
          f"{server.metrics['requests']} requests, "
          f"nn ivf/exact={stats['ivf']}/{stats['exact']}, "
          f"index rebuilds={rebuilds} ({shard_rebuilds} shard builds)",
          flush=True)
    sst = server.engine.storage_stats()
    print(f"kb storage mode={sst['mode']} bytes/row={sst['bytes_per_row']} "
          f"resident={sst['resident_rows']}/{sst['total_rows']} rows "
          f"(cold={sst['cold_rows']}), "
          f"bytes_resident={sst['bytes_resident']}, "
          f"cache hits/misses={server.metrics['cache_hits']}"
          f"/{server.metrics['cache_misses']}, "
          f"tier faults/spills={sst['tier_faults']}/{sst['tier_spills']}",
          flush=True)
    for line in format_maker_stats(maker_stats):
        print(line, flush=True)
    if index is not None and hasattr(index, "shard_stats"):
        # headroom -> 0 marks the shard whose next rebuild forces a full
        # repack at a larger common capacity
        for st in index.shard_stats():
            print(f"ivf shard {st['shard']}: cap={st['bucket_cap']} "
                  f"mean_occ={st['mean_occupancy']:.1f} "
                  f"max_occ={st['max_occupancy']} skew=x{st['skew']:.2f} "
                  f"headroom={st['headroom']}", flush=True)
    elif index is not None:
        st = index.bucket_stats()
        print(f"ivf buckets: cap={st['bucket_cap']} "
              f"mean_occ={st['mean_occupancy']:.1f} "
              f"max_occ={st['max_occupancy']} skew=x{st['skew']:.2f} "
              f"headroom={st['headroom']}", flush=True)
    if wire is not None:
        launched = {k: v for k, v in device["launches"].items() if v}
        print(f"kb device: type={device['type']} launches={launched} "
              f"peak={device['peak_bytes']} bytes", flush=True)
    return {"req_per_s": calls / dt if dt else None, "seconds": dt,
            "calls": calls, "wire": wire, "device": device,
            "dispatches": server.metrics["dispatches"],
            "requests": server.metrics["requests"],
            "coalescing_factor": server.coalescing_factor,
            "search_stats": stats, "index_rebuilds": rebuilds,
            "shard_rebuilds": shard_rebuilds, "first_index_s": build_s,
            "fill_s": fill_s,
            "maker_stats": maker_stats, "engine": server.engine}


def serve_kb_partitioned(args) -> dict:
    """``--kb-partitions N``: the partitioned fleet in one process, N
    servers behind a ``KBRouter`` of in-process transports, with
    ``--kb-replicas R`` a warm standby (filled through the router's row
    export/import and kept in step by its write tee) and R - 1 cold spares
    a partition; the local clients drive the router. Returns the run's
    numbers (also printed)."""
    P = args.kb_partitions
    pmap = PartitionMap(args.kb_entries, P)

    def member(p: int, full: bool) -> KnowledgeBankServer:
        kw = (dict(search_mode=args.kb_search, ann_nlist=args.nlist,
                   ann_nprobe=args.nprobe, cache_rows=args.kb_cache_rows,
                   resident_rows=args.kb_resident_rows,
                   cold_after_rows=args.kb_cold_after,
                   cold_dir=args.kb_cold_dir or None) if full else {})
        return KnowledgeBankServer(
            int(pmap.counts[p]), args.kb_dim,
            backend=make_backend(args.kb_backend, n_shards=args.kb_shards),
            coalesce=not args.no_coalesce, reorder=args.kb_reorder,
            storage=args.kb_storage, device=args.device, **kw)

    servers = [member(p, True) for p in range(P)]
    router = KBRouter([InProcessTransport(s, partition=f"{p}/{P}")
                       for p, s in enumerate(servers)], pmap=pmap)
    rng = np.random.default_rng(args.seed)
    fill = rng.standard_normal((args.kb_entries, args.kb_dim),
                               dtype=np.float32)
    # a tiered bank bounds the distinct rows one write may touch
    chunk = min(args.kb_resident_rows or args.kb_entries, args.kb_entries)
    for lo in range(0, args.kb_entries, chunk):
        hi = min(lo + chunk, args.kb_entries)
        router.update(np.arange(lo, hi), fill[lo:hi])
    del fill
    standbys = []
    for p in range(P if args.kb_replicas else 0):
        for i in range(args.kb_replicas):
            s = member(p, False)
            standbys.append(s)
            if i == 0:
                router.attach_standby(p, InProcessTransport(s), fill=True)
            else:
                router.add_spare(p, InProcessTransport(s))
    for s in servers + standbys:
        s.warmup(args.batch * args.clients)
    dt, calls = _drive(router, args)
    stats = router.stats()
    router.close()
    for s in servers + standbys:
        s.flush()
        s.close()
    m = stats["metrics"]
    print(f"kb-serve partitions={P} backend={args.kb_backend} "
          f"replicas={args.kb_replicas} "
          f"reorder={args.kb_reorder} clients={args.clients}: "
          f"{calls / dt:.0f} req/s ({dt / calls * 1e6:.0f} us/req), "
          f"coalescing x{stats['coalescing_factor']:.1f}, "
          f"{int(m.get('dispatches', 0))} device dispatches for "
          f"{int(m.get('requests', 0))} requests "
          f"({int(m.get('reorders', 0))} reordered), "
          f"router fast-path "
          f"{stats['router']['single_partition_fastpath']}"
          f"/{stats['router']['fanouts']} fan-outs", flush=True)
    sst = stats["storage"]
    print(f"  fleet storage mode={sst['mode']} "
          f"bytes/row={int(sst['bytes_per_row'])} "
          f"bytes_resident={int(sst['bytes_resident'])} "
          f"cache hits/misses={int(m.get('cache_hits', 0))}"
          f"/{int(m.get('cache_misses', 0))} "
          f"tier faults/spills={int(sst.get('tier_faults', 0))}"
          f"/{int(sst.get('tier_spills', 0))}", flush=True)
    for p, sp in enumerate(stats["partitions"]):
        sm = sp["metrics"]
        print(f"  partition {p}/{P}: {int(pmap.counts[p])} rows, "
              f"{int(sm.get('requests', 0))} requests -> "
              f"{int(sm.get('dispatches', 0))} dispatches", flush=True)
    return {"req_per_s": calls / dt, "seconds": dt, "calls": calls,
            "stats": stats, "servers": servers, "standbys": standbys}


def serve_lm(cfg, *, batch: int, prompt_len: int, gen: int, seed: int = 0,
             device="cuda", params=None, extra=None) -> dict:
    """Prefill ``batch`` random prompts of ``prompt_len`` tokens and decode
    ``gen`` tokens greedily, as ``repro.launch.serve``'s LM mode does.
    ``params`` (``LM.init``'s tree, e.g. from
    ``repro_torch.convert.lm_params_from_numpy``) default to random ones
    from ``seed``; ``extra`` (``{"patch_embs"}`` or ``{"frames"}``: (batch,
    n, d_model) tensors) to the JAX launcher's zeros of n =
    ``num_frontend_tokens``. Returns the generated ids (batch, gen), the
    last step's logits (batch, vocab), the prefill and per-token decode
    times in ms (host clock around work that ends in a device sync), and
    the kernel launches each phase made."""
    dev = resolve_device(device)
    model = build_model(cfg)
    if params is None:
        params = model.init(torch.Generator(device=dev).manual_seed(seed))
    rng = np.random.default_rng(seed)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab_size,
                                         (batch, prompt_len))
                            .astype(np.int32)).to(dev)
    if extra is None and cfg.frontend != "none":
        key = "patch_embs" if cfg.frontend == "vision" else "frames"
        extra = {key: torch.zeros((batch, cfg.num_frontend_tokens,
                                   cfg.d_model), device=dev)}
    prefix = (extra["patch_embs"].shape[1] if cfg.frontend == "vision"
              else 0)

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    def launches_since(before):
        return {n: c - before[n] for n, c in ops.launch_counts().items()}

    with torch.inference_mode():
        sync()
        before = ops.launch_counts()
        t0 = time.perf_counter()
        cache, _ = model.prefill(params, toks, extra,
                                 cache_len=prompt_len + gen + prefix + 1)
        sync()
        t_prefill = time.perf_counter() - t0
        prefill_launches = launches_since(before)
        before = ops.launch_counts()
        last = toks[:, -1:]
        out = []
        t0 = time.perf_counter()
        for _ in range(gen):
            logits, cache = model.decode_step(params, cache, last)
            last = torch.argmax(logits[:, -1], dim=-1)[:, None].to(
                torch.int32)
            out.append(last)
        sync()
        t_decode = time.perf_counter() - t0
    generated = torch.cat(out, 1).cpu().numpy()
    print(f"arch={cfg.name} prefill({batch}x{prompt_len})="
          f"{t_prefill * 1e3:.0f}ms decode {gen} tok: "
          f"{t_decode / gen * 1e3:.1f} ms/tok", flush=True)
    print("generated:", generated[0].tolist(), flush=True)
    return {"generated": generated, "last_logits": logits[:, -1],
            "prefill_ms": t_prefill * 1e3,
            "decode_ms_per_token": t_decode / gen * 1e3,
            "prefill_launches": prefill_launches,
            "decode_launches": launches_since(before)}


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", choices=ARCH_IDS, default="yi-6b",
                    help="LM mode: the model (its reduced config)")
    ap.add_argument("--prompt-len", type=int, default=32,
                    help="LM mode: prompt tokens per sequence")
    ap.add_argument("--kb", action="store_true",
                    help="serve the knowledge bank instead of the LM")
    ap.add_argument("--kb-backend", choices=["cuda", "dense", "sharded"],
                    default="cuda",
                    help="cuda: the kernel backend; dense: the plain "
                         "reference ops; sharded: --kb-shards logical "
                         "shards on the kernel backend")
    ap.add_argument("--kb-shards", type=int, default=1,
                    help="bank shards of --kb-backend sharded (must divide "
                         "--kb-entries)")
    ap.add_argument("--kb-entries", type=int, default=OGBN_MAG_ROWS)
    ap.add_argument("--kb-dim", type=int, default=OGBN_MAG_DIM)
    ap.add_argument("--clients", type=int, default=8)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--gen", type=int, default=16,
                    help="tokens to decode (LM), or lookup/lazy_grad/"
                         "nn_search rounds per client (--kb)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--no-coalesce", action="store_true",
                    help="per-call locked baseline (benchmark ablation)")
    ap.add_argument("--kb-reorder", action="store_true",
                    help="cross-op reordering in the coalescing dispatcher")
    ap.add_argument("--kb-storage", choices=["fp32", "int8"], default="fp32",
                    help="bank row storage: fp32, or int8 codes with a "
                         "per-row fp32 scale and offset")
    ap.add_argument("--kb-search", choices=["exact", "ivf"], default="exact",
                    help="nn_search mode; ivf serves from the index the "
                         "background refresher builds")
    ap.add_argument("--nlist", type=int, default=64,
                    help="IVF buckets (k-means centroids)")
    ap.add_argument("--nprobe", type=int, default=8,
                    help="IVF buckets probed per query")
    ap.add_argument("--kb-cache-rows", type=int, default=0,
                    help="hot-id LRU capacity (rows) in front of the "
                         "engine; 0 disables the cache")
    ap.add_argument("--kb-resident-rows", type=int, default=None,
                    help="two-tier mode: keep only this many rows "
                         "device-resident; the rest spill to the cold "
                         "store and fault back on first touch")
    ap.add_argument("--kb-cold-after", type=int, default=None,
                    help="proactively spill rows untouched for this many "
                         "written rows (requires --kb-resident-rows)")
    ap.add_argument("--kb-cold-dir", default="",
                    help="cold-tier spill directory (default: host RAM)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu")
    ap.add_argument("--kb-partitions", type=int, default=1,
                    help="split the id space over this many in-process "
                         "partition servers behind a KBRouter and drive "
                         "the router (incompatible with --listen: use "
                         "--kb-join for a wire fleet)")
    ap.add_argument("--kb-join", default="", metavar="I/N",
                    help="be partition I of an N-member fleet: host only "
                         "the ring slot's rows of the GLOBAL --kb-entries "
                         "bank and label the handshake I/N (requires "
                         "--listen)")
    ap.add_argument("--kb-replicas", type=int, default=0,
                    help="--kb-partitions: replicas a partition, the first "
                         "a warm standby attached to the router, the rest "
                         "cold spares attached after a promotion")
    ap.add_argument("--replica-of", default="", metavar="HOST:PORT",
                    help="boot as the standby of the fleet member at "
                         "HOST:PORT: the same --kb-join ring slot, its "
                         "full row state copied bit for bit, then serve")
    ap.add_argument("--listen", default="", metavar="HOST:PORT",
                    help="expose the bank on the TCP wire protocol for "
                         "trainers and makers in other processes (port 0 "
                         "= ephemeral, printed on startup) instead of "
                         "driving local clients")
    ap.add_argument("--serve-seconds", type=float, default=0.0,
                    help="--listen: exit after this long (0 = until "
                         "SIGINT/SIGTERM)")
    ap.add_argument("--max-inflight", type=int, default=32,
                    help="--listen: pipelining credits per connection PER "
                         "LANE")
    ap.add_argument("--max-inflight-control", type=int, default=0,
                    help="--listen: the control lane's credits (0 = "
                         "--max-inflight)")
    ap.add_argument("--max-inflight-bulk", type=int, default=0,
                    help="--listen: the bulk lane's credits (0 = "
                         "--max-inflight)")
    ap.add_argument("--cork-us", type=int, default=0,
                    help="--listen: adaptive writer-side cork window in "
                         "microseconds (0 = off)")
    ap.add_argument("--scheduler", choices=("lanes", "fifo"),
                    default="lanes",
                    help="--listen: response scheduler, 'lanes' (v4 "
                         "weighted priority) or 'fifo' (arrival order)")
    ap.add_argument("--sock-buf", type=int, default=0,
                    help="--listen: SO_SNDBUF/SO_RCVBUF bytes (0 = OS "
                         "default)")
    ap.add_argument("--kb-autotuned", default="", metavar="PATH",
                    help="the JAX launcher's autotuned ANN config: not "
                         "ported yet (ROADMAP Q1 item 5c)")
    ap.add_argument("--kb-makers", default="",
                    help="comma list of checkpoint-free maker kinds (e.g. "
                         "graph_builder) to run as background engine "
                         "clients while serving; their counters print "
                         "with the serve summary (their traffic shares "
                         "the server, so the timed req/s includes the "
                         "maker load)")
    ap.add_argument("--kb-maker-period", type=float, default=0.05,
                    help="pacing floor (s) for --kb-makers jobs; keeps "
                         "background makers from saturating the timed "
                         "serving window")
    return ap


def main(argv=None) -> dict:
    ap = build_parser()
    args = ap.parse_args(argv)
    if args.kb_autotuned:
        raise NotImplementedError("--kb-autotuned (the ANN autotuner's "
                                  "config) is not ported yet (ROADMAP Q1 "
                                  "item 5c)")
    if not args.kb:
        return serve_lm(get_config(args.arch).reduced(), batch=args.batch,
                        prompt_len=args.prompt_len, gen=args.gen,
                        seed=args.seed, device=args.device)
    if args.kb_replicas and args.kb_partitions <= 1:
        ap.error("--kb-replicas pairs with --kb-partitions N (wire fleets "
                 "boot standbys with --replica-of instead)")
    if args.kb_partitions > 1:
        if args.listen:
            ap.error("--kb-partitions drives an in-process router; to "
                     "expose a partitioned fleet on the wire run one "
                     "process per partition with --kb-join I/N --listen")
        if args.kb_makers or args.kb_search == "ivf":
            ap.error("--kb-partitions supports the plain serving drive (no "
                     "--kb-makers/--kb-search ivf yet)")
        return serve_kb_partitioned(args)
    return serve_kb(args)


if __name__ == "__main__":
    main()
