"""Knowledge-Bank serving on the port: the in-process client mode of
``repro.launch.serve --kb``.

  PYTHONPATH=src python -m repro_torch.launch.serve --kb

stands up the request-coalescing ``KnowledgeBankServer`` on the CUDA
kernel backend, fills the bank with N(0, 1) rows from ``--seed``, and
drives it with ``--clients`` threads, each looping lookup ->
lazy_grad(0.01 * vals) -> nn_search(k=8) ``--gen`` times. It prints the
JAX launcher's two summary lines and ends with a ``flush`` of the served
bank. The default bank is ogbn-mag sized: 1,939,743 rows (all node types
of OGB's ogbn-mag) of width 128 (its feature width), fp32, 2.02 GB with
its gradient caches.

The run is on the CUDA device unless ``--device cpu`` is given. Options of
the JAX launcher that are not ported yet raise ``NotImplementedError``.
"""
from __future__ import annotations

import argparse
import threading
import time

import numpy as np

from repro_torch.core.async_runtime import KnowledgeBankServer

OGBN_MAG_ROWS = 1_939_743
OGBN_MAG_DIM = 128
NN_K = 8


def serve_kb(args) -> dict:
    """Concurrent-client KB serving on the coalescing server. Returns the
    run's numbers (also printed) and the closed server's engine."""
    rng = np.random.default_rng(args.seed)
    server = KnowledgeBankServer(args.kb_entries, args.kb_dim,
                                 backend=args.kb_backend,
                                 coalesce=not args.no_coalesce,
                                 reorder=args.kb_reorder,
                                 cache_rows=args.kb_cache_rows,
                                 device=args.device)
    server.update(np.arange(args.kb_entries),
                  rng.standard_normal((args.kb_entries, args.kb_dim),
                                      dtype=np.float32))
    server.warmup(args.batch * args.clients)

    def client(t: int, n_calls: int):
        crng = np.random.default_rng(args.seed + 1 + t)
        for _ in range(n_calls):
            ids = crng.integers(0, args.kb_entries, (args.batch,))
            vals = server.lookup(ids)
            server.lazy_grad(ids, 0.01 * vals)
            server.nn_search(vals, k=NN_K)

    threads = [threading.Thread(target=client, args=(t, args.gen))
               for t in range(args.clients)]
    t0 = time.perf_counter()
    for th in threads:
        th.start()
    for th in threads:
        th.join()
    dt = time.perf_counter() - t0
    calls = args.clients * args.gen * 3
    server.flush()
    stats = dict(server.engine.search_stats)
    server.close()
    print(f"kb-serve backend={args.kb_backend} search=exact "
          f"coalesce={not args.no_coalesce} clients={args.clients}: "
          f"{calls / dt:.0f} req/s ({dt / calls * 1e6:.0f} us/req), "
          f"coalescing x{server.coalescing_factor:.1f}, "
          f"{server.metrics['dispatches']} device dispatches for "
          f"{server.metrics['requests']} requests, "
          f"nn ivf/exact={stats['ivf']}/{stats['exact']}, "
          f"index rebuilds=0 (0 shard builds)", flush=True)
    sst = server.engine.storage_stats()
    print(f"kb storage mode={sst['mode']} bytes/row={sst['bytes_per_row']} "
          f"resident={sst['resident_rows']}/{sst['total_rows']} rows "
          f"(cold={sst['cold_rows']}), "
          f"bytes_resident={sst['bytes_resident']}, "
          f"cache hits/misses={server.metrics['cache_hits']}"
          f"/{server.metrics['cache_misses']}, "
          f"tier faults/spills={sst['tier_faults']}/{sst['tier_spills']}",
          flush=True)
    return {"req_per_s": calls / dt, "seconds": dt, "calls": calls,
            "dispatches": server.metrics["dispatches"],
            "requests": server.metrics["requests"],
            "coalescing_factor": server.coalescing_factor,
            "engine": server.engine}


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--kb", action="store_true",
                    help="serve the knowledge bank (the only mode ported)")
    ap.add_argument("--kb-backend", choices=["cuda", "dense"],
                    default="cuda",
                    help="cuda: the kernel backend; dense: the plain "
                         "reference ops")
    ap.add_argument("--kb-entries", type=int, default=OGBN_MAG_ROWS)
    ap.add_argument("--kb-dim", type=int, default=OGBN_MAG_DIM)
    ap.add_argument("--clients", type=int, default=8)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--gen", type=int, default=16,
                    help="lookup/lazy_grad/nn_search rounds per client")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--no-coalesce", action="store_true",
                    help="per-call locked baseline (benchmark ablation)")
    ap.add_argument("--kb-reorder", action="store_true",
                    help="cross-op reordering in the coalescing dispatcher")
    ap.add_argument("--kb-cache-rows", type=int, default=0,
                    help="hot-id LRU capacity (rows) in front of the "
                         "engine; 0 disables the cache")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu")
    ap.add_argument("--listen", default="", metavar="HOST:PORT",
                    help="not ported yet (ROADMAP Q1 item 7)")
    ap.add_argument("--kb-join", default="", metavar="I/N",
                    help="not ported yet (ROADMAP Q1 item 7)")
    ap.add_argument("--kb-makers", default="",
                    help="not ported yet (ROADMAP Q1 item 5)")
    return ap


def main(argv=None) -> dict:
    args = build_parser().parse_args(argv)
    if not args.kb:
        raise NotImplementedError(
            "LM serving (serve.py --arch) is not ported yet (ROADMAP Q1 "
            "item 10); pass --kb")
    if args.listen or args.kb_join:
        raise NotImplementedError(
            "--listen / --kb-join (the wire protocol and the fleet) are not "
            "ported yet (ROADMAP Q1 item 7)")
    if args.kb_makers:
        raise NotImplementedError(
            "--kb-makers (the maker runtime) is not ported yet (ROADMAP Q1 "
            "item 5)")
    return serve_kb(args)


if __name__ == "__main__":
    main()
