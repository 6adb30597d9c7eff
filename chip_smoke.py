#!/usr/bin/env python3
"""Quickest proof that the PyTorch port (src/repro_torch) runs on the GPU.

Run from the root of a checkout, on a machine with one CUDA device:

    python3 chip_smoke.py

Phases, in order; any failed check raises and the script exits non-zero:

1. device and build: the card's name and power limit, the torch and CUDA
   versions, and the build of every kernel from src/repro_torch/kernels/csrc
   (nvcc, sm_90a), with each kernel's registers and spills;
2. each kernel against its plain PyTorch version at the serve path's
   shapes: a 1,939,743 x 128 fp32 bank (ogbn-mag) with a fifth of its rows
   holding pending gradients, 32 ids (8 clients x batch 4) and 32 queries,
   k = 8. Error, kernel time, plain time, the least time the card could
   take (bytes over 3.35 TB/s or fp32 operations over 67 TFLOP/s, from this
   run's data) and, where one PyTorch call computes the same function, that
   call's time;
3. engine parity: the cuda backend against the dense reference on one op
   stream (duplicate ids, update, lazy_grad, lookup, flush, nn_search with
   and without exclusion), for lazy_update True and False, every state leaf
   compared, and a repeated cuda run bit-identical. The lazy_update=False
   run is the path of the row gather kernel;
4. serve: repro_torch.launch.serve at full width on the cuda backend, 8
   clients, then a flush; every kernel counter is set to 0 just before and
   read just after.

It prints the kernels' record as one JSON line before the last, and as
the last line ``{"ok": true, "device": {...}}``. It imports nothing of JAX
or of the JAX package.
"""
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro_torch import convert  # noqa: E402
from repro_torch.core.kb_engine import KBEngine, make_kb_ops  # noqa: E402
from repro_torch.kernels import _build, ops, ref  # noqa: E402
from repro_torch.launch import serve  # noqa: E402

N_ROWS, DIM = 1_939_743, 128        # ogbn-mag: all node types, feature width
BATCH = 32                          # 8 clients x batch 4, coalesced
K = 8
LAZY_LR, ZMAX = 0.1, 3.0            # the engine's defaults
HBM_BYTES_PER_S = 3.35e12           # H100 SXM, 700 W
FP32_FLOP_PER_S = 67e12
SERVE_ROUNDS = 8
SLEEP_CYCLES = 2_000_000            # ~1 ms at the H100's clock
# Tolerances: the kernels compute the references' formulas step by step,
# but sum squares and products in another order than PyTorch, so a value
# may move by a few ulps. fp32 leaves and rows of magnitude <= ~10:
ATOL_ROWS = 1e-5
# scores: sums of 128 products reaching ~60 (ulp(64) = 7.6e-6)
ATOL_SCORES = 2e-4
# nn ids must match exactly where the plain k-th and (k+1)-th scores are
# further apart than this
ID_GAP = 1e-4

KERNELS = {
    "kb_fused_lookup": "src/repro/kernels/kb_fused_lookup.py:84",
    "kb_gather": "src/repro/kernels/kb_gather.py:47",
    "lazy_apply": "src/repro/kernels/lazy_apply.py:46",
    "nn_search": "src/repro/kernels/nn_search.py:99",
}


def log(msg: str) -> None:
    print(msg, flush=True)


def require(cond: bool, msg: str) -> None:
    if not cond:
        raise AssertionError(msg)


def time_ms(fn, iters: int, setup=None) -> float:
    """Mean device time of ``fn`` in ms, by CUDA events around each call,
    after one warm-up call; ``setup`` (untimed) runs before each call. A
    ~1 ms sleep kernel queued just before the start event keeps the card
    busy while the host queues the call, so the events bracket the
    device's work and not the host's launch latency (which would
    otherwise dominate the microsecond kernels)."""
    if setup:
        setup()
    fn()
    pairs = []
    for _ in range(iters):
        if setup:
            setup()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(SLEEP_CYCLES)
        start.record()
        fn()
        end.record()
        pairs.append((start, end))
    torch.cuda.synchronize()
    return sum(s.elapsed_time(e) for s, e in pairs) / iters


def bound(nbytes: float, flops: float):
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / FP32_FLOP_PER_S
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def max_err(a, b) -> float:
    return float((a.double() - b.double()).abs().max()) if a.numel() else 0.0


def phase1_build():
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    log(smi)
    log(f"phase 1: device {torch.cuda.get_device_name(0)}, torch "
        f"{torch.__version__}, CUDA {torch.version.cuda}, python "
        f"{sys.version.split()[0]}")
    t0 = time.perf_counter()
    _build.build()
    log(f"phase 1: kernels built in {time.perf_counter() - t0:.3f} s into "
        f"{_build.build_dir().relative_to(ROOT)}")
    for name in _build.SOURCES:
        for line in _build.compiler_log(name).splitlines():
            if "registers" in line or "spill" in line:
                log(f"  {name}: {line.strip()}")


def phase2_kernels():
    """Each kernel against its plain version at the serve path's shapes."""
    kernels = ops.LAUNCHERS
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)
    table = torch.randn((N_ROWS, DIM), generator=g, device=dev)
    pending = torch.rand((N_ROWS,), generator=g, device=dev) < 0.2
    grad_cnt = torch.where(
        pending, torch.randint(1, 4, (N_ROWS,), generator=g,
                               device=dev).float(), 0.0)
    grad_sum = torch.randn((N_ROWS, DIM), generator=g, device=dev)
    grad_sum *= 0.1 * grad_cnt[:, None]
    # squared-norm sums that put a tenth of the pending rows past the
    # outlier clip (avg norm > zmax * rms)
    grad_sqnorm = ((grad_sum * grad_sum).sum(1) / grad_cnt.clamp(min=1.0)
                   * torch.rand((N_ROWS,), generator=g, device=dev))
    base = (table, grad_sum, grad_cnt, grad_sqnorm)
    n_pending = int(pending.sum())
    log(f"phase 2: {n_pending} of {N_ROWS} rows hold pending gradients")

    pend_rows = torch.nonzero(pending).squeeze(1)
    pick = torch.randint(0, pend_rows.numel(), (12,), generator=g,
                         device=dev)
    ids = torch.cat([pend_rows[pick],
                     torch.randint(0, N_ROWS, (12,), generator=g,
                                   device=dev)])
    ids = torch.cat([ids, ids[:BATCH - ids.numel()]])      # duplicates
    uniq = torch.unique(ids)
    n_uniq, n_uniq_pending = uniq.numel(), int(pending[uniq].sum())
    queries = torch.randn((BATCH, DIM), generator=g, device=dev)
    results = {}

    # -- kb_fused_lookup: in place on the touched rows -------------------
    leaves_k = [t.clone() for t in base]
    leaves_p = [t.clone() for t in base]
    vals_k = kernels["kb_fused_lookup"](*leaves_k, ids, lazy_lr=LAZY_LR,
                                        zmax=ZMAX)
    vals_p = ref.kb_fused_lookup_ref(*leaves_p, ids, lazy_lr=LAZY_LR,
                                     zmax=ZMAX)
    torch.cuda.synchronize()
    err = max([max_err(vals_k, vals_p)]
              + [max_err(a[uniq], b[uniq])
                 for a, b in zip(leaves_k, leaves_p)])
    require(err <= ATOL_ROWS, f"kb_fused_lookup disagrees: {err}")
    for a, b in zip(leaves_k, base):      # untouched rows stay as they were
        a[uniq] = b[uniq]
        require(torch.equal(a, b), "kb_fused_lookup wrote an untouched row")

    def restore(leaves):
        def setup():
            for a, b in zip(leaves, base):
                a[uniq] = b[uniq]
        return setup

    D4 = DIM * 4
    nbytes = (ids.numel() * 8 + n_uniq * (2 * D4 + 16)
              + n_uniq_pending * 2 * D4 + BATCH * D4)
    results["kb_fused_lookup"] = dict(
        max_abs_err=err,
        ms=time_ms(lambda: kernels["kb_fused_lookup"](
            *leaves_k, ids, lazy_lr=LAZY_LR, zmax=ZMAX), 50,
            restore(leaves_k)),
        plain_ms=time_ms(lambda: ref.kb_fused_lookup_ref(
            *leaves_p, ids, lazy_lr=LAZY_LR, zmax=ZMAX), 50,
            restore(leaves_p)),
        library_ms=None, bound=bound(nbytes, 0.0))
    del leaves_k, leaves_p

    # -- kb_gather --------------------------------------------------------
    gids = ids.clone()
    gids[-1] = -1                          # the Pallas padding id
    out_k = kernels["kb_gather"](table, gids)
    out_p = ref.kb_gather_ref(table, gids)
    err = max_err(out_k, out_p)
    require(err == 0.0, f"kb_gather disagrees: {err}")
    nbytes = gids.numel() * 8 + (n_uniq + BATCH) * D4
    results["kb_gather"] = dict(
        max_abs_err=err,
        ms=time_ms(lambda: kernels["kb_gather"](table, ids), 200),
        plain_ms=time_ms(lambda: ref.kb_gather_ref(table, ids), 200),
        library_ms=time_ms(lambda: torch.index_select(table, 0, ids),
                           200),
        bound=bound(nbytes, 0.0))

    # -- lazy_apply: in place on the whole bank --------------------------
    leaves_k = [t.clone() for t in base]
    leaves_p = [t.clone() for t in base]
    kernels["lazy_apply"](*leaves_k, lazy_lr=LAZY_LR, zmax=ZMAX)
    ref.lazy_apply_ref(*leaves_p, lazy_lr=LAZY_LR, zmax=ZMAX)
    torch.cuda.synchronize()
    err = max(max_err(a, b) for a, b in zip(leaves_k, leaves_p))
    require(err <= ATOL_ROWS, f"lazy_apply disagrees: {err}")

    def restore_all(leaves):
        def setup():
            for a, b in zip(leaves, base):
                a.copy_(b)
        return setup

    nbytes = N_ROWS * 16 + N_ROWS * D4 + n_pending * 3 * D4
    results["lazy_apply"] = dict(
        max_abs_err=err,
        ms=time_ms(lambda: kernels["lazy_apply"](
            *leaves_k, lazy_lr=LAZY_LR, zmax=ZMAX), 10,
            restore_all(leaves_k)),
        plain_ms=time_ms(lambda: ref.lazy_apply_ref(
            *leaves_p, lazy_lr=LAZY_LR, zmax=ZMAX), 10,
            restore_all(leaves_p)),
        library_ms=None, bound=bound(nbytes, 0.0))
    del leaves_k, leaves_p, base, grad_sum

    # -- nn_search ---------------------------------------------------------
    s_k, i_k = kernels["nn_search"](queries, table, K)
    s_p, i_p = ref.nn_search_ref(queries, table, K + 1)
    err = max_err(s_k, s_p[:, :K])
    require(err <= ATOL_SCORES, f"nn_search scores disagree: {err}")
    decided = (s_p[:, K - 1] - s_p[:, K]) > ID_GAP
    require(torch.equal(i_k[decided], i_p[decided, :K]),
            "nn_search ids disagree on decided queries")
    log(f"phase 2: nn_search ids checked exactly on {int(decided.sum())} of "
        f"{BATCH} queries (k-th and (k+1)-th plain scores > {ID_GAP} apart)")
    nbytes = (N_ROWS + BATCH) * D4 + BATCH * K * 12
    results["nn_search"] = dict(
        max_abs_err=err,
        ms=time_ms(lambda: kernels["nn_search"](queries, table, K),
                   20),
        plain_ms=time_ms(lambda: ref.nn_search_ref(queries, table, K),
                         5),
        library_ms=None,
        bound=bound(nbytes, 2.0 * BATCH * N_ROWS * DIM))

    for name, r in results.items():
        b_ms, b_by = r["bound"]
        log(f"phase 2: {name} ok: max_abs_err={r['max_abs_err']} "
            f"ms={r['ms']} plain_ms={r['plain_ms']} "
            f"library_ms={r['library_ms']} bound_ms={b_ms} ({b_by})")
    del table
    torch.cuda.empty_cache()
    return results


def _engine_stream(backend, lazy_update):
    """One op stream through a KBEngine; returns its outputs and final
    state as numpy."""
    n, d = 100_003, DIM              # not a multiple of any block size
    rng = np.random.default_rng(7)
    leaves = {"table": rng.standard_normal((n, d), dtype=np.float32),
              "version": np.zeros(n, np.int32),
              "grad_sum": np.zeros((n, d), np.float32),
              "grad_cnt": np.zeros(n, np.float32),
              "grad_sqnorm": np.zeros(n, np.float32),
              "norm_ema": np.zeros(n, np.float32),
              "step": np.zeros((), np.int32)}
    eng = KBEngine(n, d, backend=backend, lazy_update=lazy_update,
                   device="cuda")
    eng.load_state(leaves)
    ids = np.array([3, 17, 42, 3, n - 1, 17, 3, 500, 9_999, 42, 77])
    out = {}
    eng.lazy_grad(ids, rng.standard_normal((ids.size, d)))
    out["lookup1"] = eng.lookup(ids)
    eng.update(ids[:5], rng.standard_normal((5, d)))
    eng.lazy_grad(ids[2:], 0.5 * rng.standard_normal((ids.size - 2, d)))
    out["lookup2"] = eng.lookup(ids[::-1].reshape(1, -1))
    eng.lazy_grad(ids, 30.0 * rng.standard_normal((ids.size, d)))
    eng.flush()
    q = rng.standard_normal((5, d)).astype(np.float32)
    out["nn_s"], out["nn_i"] = eng.nn_search(q, K)
    excl = np.stack([out["nn_i"][:, 0], out["nn_i"][:, 2],
                     np.full(5, -1)], 1)
    out["nnx_s"], out["nnx_i"] = eng.nn_search(q, K, exclude_ids=excl)
    # the backend's own exclusion path (the kernel over-fetches)
    kb_ops = make_kb_ops(backend=backend)
    s, i = kb_ops.nn_search(eng.state, torch.from_numpy(q).cuda(), K,
                            exclude_ids=torch.from_numpy(excl).cuda())
    out["nnb_s"], out["nnb_i"] = s.cpu().numpy(), i.cpu().numpy()
    torch.cuda.synchronize()
    return out, convert.kb_state_to_numpy(eng.state)


def phase3_engine():
    counts = {}
    for lazy_update in (True, False):
        ops.reset_launch_counts()
        out_c, st_c = _engine_stream("cuda", lazy_update)
        counts[lazy_update] = ops.launch_counts()
        out_c2, st_c2 = _engine_stream("cuda", lazy_update)
        out_d, st_d = _engine_stream("dense", lazy_update)
        for key in st_c:
            require(np.array_equal(st_c[key], st_c2[key]),
                    f"repeated cuda run differs in {key}")
            tol = 0 if key in ("version", "grad_cnt", "step") else 1e-6
            err = np.abs(st_c[key].astype(np.float64)
                         - st_d[key].astype(np.float64)).max()
            require(err <= tol, f"cuda vs dense {key}: {err}")
        n_decided = 0
        for key in out_c:
            require(np.array_equal(out_c[key], out_c2[key]),
                    f"repeated cuda run differs in {key}")
            if key.endswith("_i"):
                s_d = out_d[key[:-1] + "s"]
                gap = np.concatenate([s_d[:, :-1] - s_d[:, 1:],
                                      np.full((len(s_d), 1), np.inf)], 1)
                # a rank's id is decided where its score is apart from both
                # neighbours'
                ok = (gap > ID_GAP) & (np.roll(gap, 1, 1) > ID_GAP)
                n_decided += int(ok.all(1).sum())
                require(np.array_equal(out_c[key][ok], out_d[key][ok]),
                        f"cuda vs dense {key}")
            else:
                tol = ATOL_SCORES if key.startswith("nn") else ATOL_ROWS
                a, b = out_c[key], out_d[key]
                fin = np.isfinite(b)
                require(np.array_equal(np.isfinite(a), fin)
                        and np.abs(a[fin] - b[fin]).max() <= tol,
                        f"cuda vs dense {key}")
        log(f"phase 3: lazy_update={lazy_update}: cuda == dense within the "
            f"tolerances ({n_decided} fully decided nn rows, ids exact); "
            f"repeated cuda run bit-identical; launches "
            f"{counts[lazy_update]}")
    require(counts[False]["kb_gather"] > 0,
            "the lazy_update=False engine never launched kb_gather")
    require(counts[True]["kb_fused_lookup"] > 0,
            "the engine never launched kb_fused_lookup")
    return counts


def phase4_serve():
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    res = serve.main(["--kb", "--kb-backend", "cuda", "--kb-entries",
                      str(N_ROWS), "--kb-dim", str(DIM), "--clients", "8",
                      "--batch", "4", "--gen", str(SERVE_ROUNDS)])
    counts = ops.launch_counts()
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    st = res["engine"].state
    require(bool(torch.isfinite(st.table).all()), "served bank not finite")
    require(float(st.grad_cnt.abs().sum()) == 0.0
            and float(st.grad_sum.abs().sum()) == 0.0,
            "caches not empty after the final flush")
    require(res["coalescing_factor"] > 1.0, "no request was coalesced")
    # the engine's warm-up launches each kernel once on a scratch bank; the
    # rest are the clients' requests and the final flush
    require(counts["kb_fused_lookup"] > 1 and counts["nn_search"] > 1
            and counts["lazy_apply"] > 1,
            f"the served path missed a kernel: {counts}")
    log(f"phase 4: serve {res['req_per_s']} req/s over {SERVE_ROUNDS} rounds "
        f"of 8 clients ({res['requests']} requests, {res['dispatches']} "
        f"dispatches), {wall:.1f} s with fill and warm-up; peak device "
        f"memory {peak} bytes; launches {counts} (one of each in the "
        f"warm-up on a scratch bank)")
    return counts


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this "
              "script runs on a CUDA device only", file=sys.stderr)
        return 2
    t_all = time.perf_counter()
    phase1_build()
    t = time.perf_counter()
    results = phase2_kernels()
    log(f"phase 2: {time.perf_counter() - t:.1f} s")
    t = time.perf_counter()
    engine_counts = phase3_engine()
    log(f"phase 3: {time.perf_counter() - t:.1f} s")
    t = time.perf_counter()
    serve_counts = phase4_serve()
    log(f"phase 4: {time.perf_counter() - t:.1f} s")

    record = []
    for name, replaces in KERNELS.items():
        r = results[name]
        # a kernel's launches are those of the path it serves: the serve
        # run for three, the lazy_update=False engine for the gather
        launches = (engine_counts[False][name] if name == "kb_gather"
                    else serve_counts[name])
        require(launches > 0, f"{name} was never launched on its path")
        record.append({
            "name": name, "route": "cuda",
            "source": f"src/repro_torch/kernels/csrc/{name}.cu",
            "replaces": replaces, "launches": launches,
            "launches_by_path": {"serve": serve_counts[name],
                                 "engine_lazy": engine_counts[True][name],
                                 "engine_immediate":
                                     engine_counts[False][name]},
            "max_abs_err": r["max_abs_err"], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound"][0],
            "bound_by": r["bound"][1], "library_ms": r["library_ms"]})
    log("kernels: " + "; ".join(
        f"{k['name']} err={k['max_abs_err']:.3g} ms={k['ms']:.4g} "
        f"plain={k['plain_ms']:.4g} bound={k['bound_ms']:.4g} "
        f"({k['bound_by']}) library={k['library_ms']} "
        f"launches={k['launches']}" for k in record))
    log(f"total {time.perf_counter() - t_all:.1f} s")
    print(json.dumps({"kernels": record}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
