#!/usr/bin/env python3
"""Serve the KB through the port's launcher in each configuration of
``chip_smoke.py``'s phase 4, for this checkout and another, in turns.

    python tools/serve_ab.py [--other DIR] [--rounds 1] [--gen 32]

DIR is another checkout of the repo (for example the parent commit,
unpacked by ``git archive`` into an ignored directory). Each round runs
one process per checkout in the order other, this, this, other; each
process imports its own checkout's ``repro_torch`` and, for fp32 exact
search, fp32 IVF, int8 IVF and the 3-shard fp32 IVF (nlist 64, nprobe
8), serves 1,939,743 x 128 rows with 8 clients x batch 4 for ``--gen``
rounds twice: once as it is (req/s, requests, dispatches, launches of
the search kernel), then once under ``torch.profiler``, for the device
time of the whole run and of the search kernels (``search_ms``: every
kernel whose name holds ``ivf`` or ``nn_partial``; apart from them
``merge_topk_lists``, the merge of ``nn_search`` and of older
checkouts' stage 2). It prints one JSON line per process and
configuration, then the card's name and power limit. Without
``--other`` it serves this checkout once.
"""
import argparse
import gc
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
CONFIGS = {  # label: (launcher options, the search kernel it launches)
    "fp32_exact": ([], "nn_search"),
    "fp32_ivf": (["--kb-storage", "fp32", "--kb-search", "ivf"],
                 "ivf_stage2"),
    "int8_ivf": (["--kb-storage", "int8", "--kb-search", "ivf"],
                 "ivf_stage2_q"),
    "sharded_ivf": (["--kb-backend", "sharded", "--kb-shards", "3",
                     "--kb-search", "ivf"], "ivf_stage2_sharded"),
}


def device_ms(prof) -> dict:
    """Device time in ms of a finished ``torch.profiler`` run: all of it,
    the search kernels', and ``merge_topk_lists``'."""
    from torch.autograd import DeviceType
    out = {"device_ms": 0.0, "search_ms": 0.0, "merge_topk_lists_ms": 0.0}
    for e in prof.key_averages():
        if e.device_type != DeviceType.CUDA:
            continue
        ms = e.self_device_time_total / 1e3
        out["device_ms"] += ms
        if "ivf" in e.key or "nn_partial" in e.key:
            out["search_ms"] += ms
        elif "merge_topk_lists" in e.key:
            out["merge_topk_lists_ms"] += ms
    return out


def measure(root: Path, gen: int) -> list:
    """Serve each configuration twice from ``root``'s checkout; runs in a
    process of its own."""
    sys.path.insert(0, str(root / "src"))
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.kernels import ops
    from repro_torch.launch import serve
    out = []
    for label, (opts, kern) in CONFIGS.items():
        argv = ["--kb", "--kb-backend", "cuda", "--kb-entries", "1939743",
                "--kb-dim", "128", "--clients", "8", "--batch", "4",
                "--gen", str(gen), "--nlist", "64", "--nprobe", "8", *opts]
        for profiled in (False, True):
            ops.reset_launch_counts()
            extra = {}
            if profiled:
                with profile(activities=[ProfilerActivity.CUDA]) as prof:
                    res = serve.main(argv)
                    torch.cuda.synchronize()
                extra = device_ms(prof)
            else:
                res = serve.main(argv)
            out.append({"root": str(root), "config": label,
                        "profiled": profiled,
                        "req_per_s": res["req_per_s"],
                        "requests": res["requests"],
                        "dispatches": res["dispatches"],
                        "coalescing": res["coalescing_factor"],
                        "launches": ops.launch_counts()[kern], **extra})
            del res
            gc.collect()
            torch.cuda.empty_cache()
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--other", type=Path, default=None)
    ap.add_argument("--rounds", type=int, default=1)
    ap.add_argument("--gen", type=int, default=32)
    ap.add_argument("--measure", type=Path, default=None,
                    help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.measure is not None:
        for line in measure(args.measure.resolve(), args.gen):
            print(json.dumps(line), flush=True)
        return 0
    import torch
    if not torch.cuda.is_available():
        print("serve_ab: no CUDA device", file=sys.stderr)
        return 2
    order = [ROOT] if args.other is None else \
        [args.other.resolve(), ROOT, ROOT, args.other.resolve()] * args.rounds
    for root in order:
        out = subprocess.run(
            [sys.executable, __file__, "--gen", str(args.gen), "--measure",
             str(root)], capture_output=True, text=True)
        if out.returncode != 0:
            print(out.stdout[-4000:] + out.stderr[-4000:], file=sys.stderr)
            return out.returncode
        for line in out.stdout.strip().splitlines()[-2 * len(CONFIGS):]:
            print(line, flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
