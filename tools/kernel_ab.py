#!/usr/bin/env python3
"""Time a kernel of the port against the same kernel of another checkout,
on one card, in turns.

    python tools/kernel_ab.py --other DIR [--kernel flash_bf16|nn_search]
                              [--rounds 1]

DIR is another checkout of the repo (for example the parent commit,
unpacked by ``git archive`` into an ignored directory). Each round runs
one process per checkout in the order other, this, this, other; each
process imports its own checkout's ``repro_torch``, builds that
checkout's kernel sources into its own ``build/``, makes the inputs from
one seed on the card, checks the kernel against its plain version and
times it (CUDA events, as ``chip_smoke.py`` does), and for flash_bf16 reads
the kernel's stage profile where the checkout has one. It prints one JSON
line per process, then the card's name and power limit. Without
``--other`` it times this checkout once.

The shapes are the serve paths': flash_bf16 the yi-6b prefill's q, k, v
(B 4, S 2048, H 32, KV 4, d 128, causal, bf16); nn_search the ogbn-mag
bank (1,939,743 x 128 fp32) with 32 queries and k = 8.
"""
import argparse
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
SLEEP_CYCLES = 2_000_000            # ~1 ms at the H100's clock


def time_ms(fn, iters: int) -> float:
    """Mean device time of ``fn`` by CUDA events, after a warm-up call; a
    sleep kernel before each start event keeps the host's launch latency
    out of the bracket."""
    import torch
    fn()
    pairs = []
    for _ in range(iters):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(SLEEP_CYCLES)
        start.record()
        fn()
        end.record()
        pairs.append((start, end))
    torch.cuda.synchronize()
    return sum(s.elapsed_time(e) for s, e in pairs) / iters


def measure(root: Path, kernel: str) -> dict:
    """Build ``root``'s kernel, check it against the plain version and
    time it; runs in a process of its own."""
    sys.path.insert(0, str(root / "src"))
    import torch
    from repro_torch.kernels import _build, ops, ref
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)
    extra = {}
    if kernel == "flash_bf16":
        _build.build(["flash_attention"])
        q, k, v = (torch.randn((4, 2048, n, 128), generator=g,
                               device=dev).to(torch.bfloat16)
                   for n in (32, 4, 4))
        fn = ops.LAUNCHERS["flash_attention"]
        got = fn(q, k, v, causal=True)
        err = (got.float() - ref.flash_attention_ref(
            q, k, v, causal=True).float()).abs().max().item()
        ms = time_ms(lambda: fn(q, k, v, causal=True), 20)
        from repro_torch.kernels import flash_attention as fa
        if hasattr(fa, "flash_stage_cycles"):       # a checkout that has it
            extra = {"stage_cycles": fa.flash_stage_cycles(q, k, v,
                                                           causal=True)}
    elif kernel == "nn_search":
        _build.build(["nn_search"])
        bank = torch.randn((1_939_743, 128), generator=g, device=dev)
        queries = torch.randn((32, 128), generator=g, device=dev)
        fn = ops.LAUNCHERS["nn_search"]
        s, i = fn(queries, bank, 8)
        ws, wi = ref.nn_search_ref(queries, bank, 8)
        err = (s - ws).abs().max().item()
        err = max(err, 0.0 if torch.equal(i, wi) else float("inf"))
        ms = time_ms(lambda: fn(queries, bank, 8), 20)
    else:
        raise ValueError(f"unknown kernel {kernel!r}")
    return {"root": str(root), "kernel": kernel, "ms": ms,
            "max_abs_err": err, **extra}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--other", type=Path, default=None)
    ap.add_argument("--kernel", default="flash_bf16",
                    choices=("flash_bf16", "nn_search"))
    ap.add_argument("--rounds", type=int, default=1)
    ap.add_argument("--measure", type=Path, default=None,
                    help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.measure is not None:
        print(json.dumps(measure(args.measure.resolve(), args.kernel)),
              flush=True)
        return 0
    import torch
    if not torch.cuda.is_available():
        print("kernel_ab: no CUDA device", file=sys.stderr)
        return 2
    order = [ROOT] if args.other is None else \
        [args.other.resolve(), ROOT, ROOT, args.other.resolve()] * args.rounds
    for root in order:
        out = subprocess.run(
            [sys.executable, __file__, "--kernel", args.kernel, "--measure",
             str(root)], capture_output=True, text=True)
        if out.returncode != 0:
            print(out.stdout + out.stderr, file=sys.stderr)
            return out.returncode
        print(out.stdout.strip().splitlines()[-1], flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
