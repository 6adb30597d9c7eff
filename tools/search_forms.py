#!/usr/bin/env python3
"""Time the two forms of the IVF stage-2 pass at the serve shapes, and
nn_search's small-bank tile rule at the makers' shape, on one card, in
turns (A, B, B, A) in one process.

    PYTHONPATH=src python tools/search_forms.py

The stage-2 pass keeps a block's 32 queries in shared memory where they
fit and streams their slice of each stage through its ring beyond that
(``ivf_stage2.streams_queries``); here each of its four entries runs at
the serve shapes of ``tools/kernel_ab.py`` in both forms, the streamed
one forced. nn_search cuts a small bank into 64-row tiles
(``nn_search.MIN_TILES``); here the makers' search (64 unit-norm queries
over a 2048 x 4096 bank, k 9 and 32) runs with the rule and without it
(MIN_TILES 0: 512-row tiles). Each line gives the form, its two times
(ms, CUDA events) and its results' digest (equal digests, equal
results); the last line, the card's name and power limit.
"""
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

from repro_torch.kernels import ivf_stage2 as s2  # noqa: E402
from repro_torch.kernels import nn_search as nns  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from tools.kernel_ab import (DIM, MAKER_QUERIES, MAKER_ROWS, N_ROWS,  # noqa
                             STAGE2, WIDE_DIM, digest, stage2_inputs,
                             time_ms)

TURNS = (False, True, True, False)


def main() -> int:
    if not torch.cuda.is_available():
        print("search_forms: no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)
    bank = torch.randn((N_ROWS, DIM), generator=g, device=dev)
    q = bank[torch.randint(0, N_ROWS, (32,), generator=g, device=dev)] \
        + 0.01
    resident = s2.streams_queries
    out = {}
    for name, (_, _, k, _) in STAGE2.items():
        args, _, _ = stage2_inputs(name, bank, q)
        fn = ops.LAUNCHERS[name]
        for streamed in TURNS:
            s2.streams_queries = ((lambda dim, kk, int8: True) if streamed
                                  else resident)
            s, i = fn(*args, k)
            out.setdefault(f"{name} {'streamed' if streamed else 'resident'}"
                           " queries", []).append(
                (time_ms(lambda: fn(*args, k), 20), digest(s, i)))
        s2.streams_queries = resident
        del args
    del bank, q
    wb = torch.randn((MAKER_ROWS, WIDE_DIM), generator=g, device=dev)
    wb = wb / wb.norm(dim=1, keepdim=True)
    wq = wb[:MAKER_QUERIES] + 0.01
    rule = nns.MIN_TILES
    fn = ops.LAUNCHERS["nn_search"]
    for off in TURNS:
        nns.MIN_TILES = 0 if off else rule
        for k in (9, 32):
            s, i = fn(wq, wb, k)
            out.setdefault(f"nn_search makers k {k}, tiles "
                           f"{nns.tile_plan(k, MAKER_ROWS)}", []).append(
                (time_ms(lambda: fn(wq, wb, k), 20), digest(s, i)))
    nns.MIN_TILES = rule
    for key, runs in out.items():
        print(key, json.dumps(runs), flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
