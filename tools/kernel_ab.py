#!/usr/bin/env python3
"""Time kernels of the port against the same kernels of another checkout,
on one card, in turns.

    python tools/kernel_ab.py --other DIR [--kernel NAME[,NAME...]]
                              [--rounds 1]

NAME is flash_bf16, nn_search, ivf_stage2, ivf_stage2_q,
ivf_stage2_sharded, ivf_stage2_sharded_q, rwkv_wkv, mamba_scan,
kb_fused_lookup, kb_fused_lookup_q, lookup_op, launch_floor, or one of
the wide shapes nn_search_wide, ivf_stage2_wide, ivf_stage2_q_wide,
ivf_stage2_sharded_wide and ivf_stage2_sharded_q_wide, or one of the
training path's flash_bwd_bf16, adamw, wkv_bwd and scan_bwd. DIR is
another checkout of the repo (for example the parent commit, unpacked by
``git archive`` into an ignored directory, or a variant of ``src/``
copied under one). Each round runs one process per checkout in the
order other, this, this, other; each process imports its own checkout's
``repro_torch``, builds that checkout's kernel sources into its own
``build/``, makes the inputs from one seed on the card, and for each
kernel checks it against its plain version and times it (CUDA events, as
``chip_smoke.py`` does); for flash_bf16, the stage-2 entries, rwkv_wkv
and mamba_scan it reads the kernel's stage profile where the checkout
has one. It prints one JSON line per process and kernel, then the card's
name and power limit.
Without ``--other`` it times this checkout once.

The shapes are the serve paths': flash_bf16 the yi-6b prefill's q, k, v
(B 4, S 2048, H 32, KV 4, d 128, causal, bf16); nn_search the ogbn-mag
bank (1,939,743 x 128 fp32) with 32 queries and k = 8; the IVF stage 2
entries an index of 64 buckets over that bank (fp32, or over its int8
quantization), or 3 shards of 64 buckets each, 32 queries (rows of the
bank) probing 8 buckets (of each shard), k = 8 over fp32 rows and kq = 32
over int8 rows, each also timed at the other k; rwkv_wkv the rwkv6-7b
prefill's r, k, v (B 4, S 2048, H 64, d 64, bf16) and mamba_scan the
jamba prefill's (B 4, S 2048, di 16384, ds 16, x bf16), made in the
models' ranges by ``wkv_inputs`` and ``scan_inputs`` (which
``chip_smoke.py`` phase 2 uses too); their ``max_abs_err`` is over y and
the final state. nn_search and the stage-2 entries are also timed
on the batches the KB engine pads (``padded``): it fills a batch with
zero queries up to a power of two of at least 8, so B 8 with 4 real
queries and B 16 with 12, each checked against its
plain version (``zero_rows_exact``: the zero queries' lists, all ties at
0, equal the plain version's bit for bit). ``host_us`` is the host's
time per call of the kernel's launcher, 20 calls queued without a
synchronisation. Each search line carries ``digest``, a hash of the
kernel's scores and ids on the serve inputs, and the flash_bf16,
rwkv_wkv and mamba_scan lines one of their outputs (y and the final
state), so that two checkouts' lines show whether their results are
bit-identical.

The wide shapes are the trainer's width, 4096: nn_search_wide 64
queries (rows of the bank, plus 0.01) over a 2048 x 4096 bank, the
knowledge makers' (k 9 and 32, ``ms_k32``); the ``_wide`` stage-2
entries an index of 64 buckets (3 shards of 64, sharded) over 61,440 x
4096 rows, 32 queries probing 8, at their entries' k. A checkout whose
kernel refuses that width prints ``refused`` with its message.

wkv_bwd and scan_bwd time the WKV and scan backward kernels on the
forward's own checkpoints, with N(0, 1) gradients of y and of the final
state: wkv_bwd at the rwkv6-7b prefill's shape (B 4, S 2048, H 64, d 64,
r/k/v bf16) and, as ``ms_train`` with ``digest_train``, at its training
run's (B 8, S 64); scan_bwd at the jamba layer's (B 4, S 2048, di 16384,
ds 16, x bf16). Each carries ``digest`` of the five gradients,
``repeat_identical``, its max abs error against the plain backward, and
``ptxas``: the kernel's instances with their registers, stack frame and
spill bytes, from the checkout's own build.

flash_bwd_bf16 times the flash backward on the flash_bf16 inputs with
N(0, 1) output gradients (B 4, and ``ms_b2`` at the yi-6b training run's
B 2), with ``digest`` and ``repeat_identical`` of dq, dk and dv. adamw
times ``AdamW.update`` on the leaves of yi-6b cut to 16 layers (the
kernel on a checkout that has it, the eager passes on an older one), with
gradients small enough that the global norm stays under the clip, so that
``digest`` (of the new parameters and moments) is equal across
checkouts whose updates are bit-identical.

kb_fused_lookup and kb_fused_lookup_q run on the ogbn-mag bank (fp32, or
its int8 quantization) with a fifth of its rows holding pending
gradients, made by ``lookup_bank`` (which ``chip_smoke.py`` phase 2
uses too), at the serve batch (32 ids, 8 of them duplicates:
``lookup_ids``) and at a batch of 1024 whose duplicates lie in other
blocks (``ms_b1024``: ``spread_ids``); each call starts from the same
state (the touched rows restored, untimed), and passes ``version``
where the checkout's launcher takes it (``with_version``). lookup_op
times a whole ``CudaBackend.lookup`` and ``lookup_q`` on that bank (ids
already on the card, the rows left there: the same API on every
checkout), and reads ``kernels``, the device kernels one op queues
under ``torch.profiler``, and ``host_syncs``, the synchronisations
torch's sync debug mode reports in one op. launch_floor times
``torch.cuda._sleep(0)``, a one-thread kernel that returns at once, by
the same events: the least a launch costs on the card.
"""
import argparse
import importlib
import inspect
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
SLEEP_CYCLES = 2_000_000            # ~1 ms at the H100's clock
PROFILE_CAPTURES = 3                # tries of a profile that lost its records


def time_ms(fn, iters: int, setup=None) -> float:
    """Mean device time of ``fn`` in ms, by CUDA events around each call,
    after one warm-up call; ``setup`` (untimed) runs before each call. A
    ~1 ms sleep kernel queued just before the start event keeps the card
    busy while the host queues the call, so the events bracket the
    device's work and not the host's launch latency (which would
    otherwise dominate the microsecond kernels)."""
    import torch
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


STAGE2 = {  # name: (sharded, int8, k, the other k)
    "ivf_stage2": (False, False, 8, 32),
    "ivf_stage2_q": (False, True, 32, 8),
    "ivf_stage2_sharded": (True, False, 8, 32),
    "ivf_stage2_sharded_q": (True, True, 32, 8),
}
LOOKUPS = ("kb_fused_lookup", "kb_fused_lookup_q")
WIDE = ("nn_search_wide", *(f"{n}_wide" for n in STAGE2))
KERNELS = ("flash_bf16", "nn_search", *STAGE2, "rwkv_wkv", "mamba_scan",
           *LOOKUPS, "lookup_op", "launch_floor", *WIDE, "flash_bwd_bf16",
           "adamw", "wkv_bwd", "scan_bwd")
# the backward kernels' entries: the sources each builds
BWD_SOURCES = {"wkv_bwd": ("rwkv_wkv", "rwkv_wkv_bwd"),
               "scan_bwd": ("mamba_scan", "mamba_scan_bwd")}
ADAMW_LAYERS = 16                   # chip_smoke.py's TRAIN_LAYERS
N_ROWS, DIM = 1_939_743, 128        # ogbn-mag: all node types, feature width
WIDE_DIM = 4096                     # yi-6b's d_model: the trainer's bank
MAKER_ROWS, MAKER_QUERIES = 2048, 64   # the makers' bank and batch
WIDE_IVF_ROWS = 61_440              # 3 x 20,480: one index or 3 shards


def digest(*tensors) -> str:
    """A short hash of the tensors' bytes: equal digests, equal results."""
    import hashlib
    import torch
    h = hashlib.sha256()
    for t in tensors:
        t = t.detach().cpu().contiguous()
        if t.dtype == torch.bfloat16:   # numpy has no bf16: its bits
            t = t.view(torch.int16)
        h.update(t.numpy().tobytes())
    return h.hexdigest()[:16]
LAZY_LR, ZMAX = 0.1, 3.0            # the engine's defaults


def host_us(fn, iters: int = 20) -> float:
    """Host time per call of ``fn`` in µs, ``iters`` calls queued on the
    stream without a synchronisation between them."""
    import time
    import torch
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return (t1 - t0) / iters * 1e6


def padded_batches(queries):
    """(label, batch, real rows) of the batches the engine pads: B 8
    with 4 real queries, B 16 with 12, the rest zero rows."""
    import torch
    out = []
    for real, B in ((4, 8), (12, 16)):
        pad = torch.zeros((B - real, queries.shape[1]), device=queries.device)
        out.append((f"B{B}", torch.cat([queries[:real], pad]), real))
    return out


def padded_check(fn, plain, q, real: int, rest, k: int) -> dict:
    """Time ``fn`` on a padded batch and hold its zero rows against the
    plain version's exactly."""
    import torch
    args = rest(q)
    s, i = fn(*args, k)
    ws, wi = plain(*args, k)
    return {"ms": time_ms(lambda: fn(*args, k), 20),
            "max_abs_err": (s - ws).abs().max().item(),
            "zero_rows_exact": torch.equal(s[real:], ws[real:])
            and torch.equal(i[real:], wi[real:])}


def stage2_inputs(name: str, bank, queries):
    """(launcher args without k, plain version, the args for other
    queries) of a stage-2 entry over ``bank`` (64 buckets, or 3 shards of
    64), 8 probes, the index built by the checkout's own ann_index."""
    from repro_torch.core import ann_index
    from repro_torch.core import knowledge_bank as kbm
    from repro_torch.kernels import ref
    from repro_torch.kernels.nn_search_ivf import ivf_probes, sharded_probes
    sharded, int8, _, _ = STAGE2[name]
    if sharded:
        index = ann_index.build_sharded_ivf_index(bank, 3, nlist=64)
        if int8:
            index = ann_index.QuantizedShardedIVFIndex(index)
    else:
        rows = kbm.dequantize_rows(*kbm.quantize_rows(bank)) if int8 \
            else bank
        index = ann_index.build_ivf_index(rows, nlist=64)
        if int8:
            index = ann_index.QuantizedIVFIndex(index)
    packed = ((index.packed_codes, index.packed_scale, index.packed_offset)
              if int8 else (index.packed_vecs,))

    def rest(q):
        probes = (sharded_probes(q, index.centroids, 3, 8) if sharded
                  else ivf_probes(q, index.centroids, 8))
        return (*packed, index.packed_ids, index.bucket_occ, q, probes)
    return rest(queries), getattr(ref, f"{name}_ref"), rest


def wkv_inputs(B, S, H, d, dtype, g, decays="model"):
    """r, k, v N(0, 1) in ``dtype``; u 0.1 N(0, 1) and w = exp(-exp(dec))
    in fp32. ``decays="model"``: dec = N(-2, 0.5) per entry, the rwkv6
    model's ranges (the projections of a normed input; the decay base
    dec_0 = -2 plus a low-rank term). ``"extreme"``: dec = N(0, 2) per
    (h, i) at every step, so w runs from 0 (underflowed) to ~0.9997 and
    the state of the rows with w near 1 grows over the whole sequence."""
    import torch
    dev = torch.device("cuda")
    r, k, v = (torch.randn((B, S, H, d), generator=g, device=dev).to(dtype)
               for _ in range(3))
    if decays == "model":
        w = torch.exp(-torch.exp(-2.0 + 0.5 * torch.randn(
            (B, S, H, d), generator=g, device=dev)))
    else:
        dec = 2.0 * torch.randn((H, d), generator=g, device=dev)
        w = torch.exp(-torch.exp(dec)).expand(B, S, H, d).contiguous()
    u = 0.1 * torch.randn((H, d), generator=g, device=dev)
    return r, k, v, w, u


def scan_inputs(B, S, di, ds, dtype, g, A_kind="init"):
    """x N(0, 1) in ``dtype``, B and C N(0, 1); all but x fp32. With
    ``A_kind="init"`` delta = softplus(N(-4.6, 1)) (the model's dt_bias
    plus a projection) and A = -(1 .. ds) on every channel (the model's
    init); with ``"trained"`` delta = softplus(N(0, 1)) and a per-channel
    A = -exp(0.3 N(0, 1)) (tests/test_torch_jamba.py's ranges)."""
    import torch
    dev = torch.device("cuda")
    mu = -4.6 if A_kind == "init" else 0.0
    delta = torch.nn.functional.softplus(
        mu + torch.randn((B, S, di), generator=g, device=dev))
    x = torch.randn((B, S, di), generator=g, device=dev).to(dtype)
    bm, cm = (torch.randn((B, S, ds), generator=g, device=dev)
              for _ in range(2))
    if A_kind == "init":
        A = -torch.arange(1, ds + 1, dtype=torch.float32,
                          device=dev).expand(di, ds).contiguous()
    else:
        A = -torch.exp(0.3 * torch.randn((di, ds), generator=g, device=dev))
    return delta, bm, cm, x, A


def lookup_bank(g, n_rows: int = N_ROWS, dim: int = DIM):
    """(table, grad_sum, grad_cnt, grad_sqnorm, pending) of a bank on the
    card, by default ogbn-mag's: N(0, 1) rows, a fifth of them holding 1-3
    pending gradients of 0.1 N(0, 1) each, with squared-norm sums that put
    a tenth of the pending rows past the outlier clip (avg norm > zmax *
    rms)."""
    import torch
    dev = torch.device("cuda")
    table = torch.randn((n_rows, dim), generator=g, device=dev)
    pending = torch.rand((n_rows,), generator=g, device=dev) < 0.2
    grad_cnt = torch.where(
        pending, torch.randint(1, 4, (n_rows,), generator=g,
                               device=dev).float(), 0.0)
    grad_sum = torch.randn((n_rows, dim), generator=g, device=dev)
    grad_sum *= 0.1 * grad_cnt[:, None]
    grad_sqnorm = ((grad_sum * grad_sum).sum(1) / grad_cnt.clamp(min=1.0)
                   * torch.rand((n_rows,), generator=g, device=dev))
    return table, grad_sum, grad_cnt, grad_sqnorm, pending


def lookup_ids(g, pending, batch: int = 32):
    """The serve batch (8 clients x batch 4, coalesced): 12 rows with
    pending gradients, 12 random rows, and the first 8 again."""
    import torch
    dev = pending.device
    pend_rows = torch.nonzero(pending).squeeze(1)
    pick = torch.randint(0, pend_rows.numel(), (12,), generator=g,
                         device=dev)
    ids = torch.cat([pend_rows[pick],
                     torch.randint(0, pending.shape[0], (12,), generator=g,
                                   device=dev)])
    return torch.cat([ids, ids[:batch - ids.numel()]])


def spread_ids(n_rows: int, device, batch: int = 1024, block: int = 8,
               seed: int = 0):
    """``batch`` distinct random rows, then every third slot's id copied to
    a random later slot at least a block (``block`` slots) away, so that
    about a third of the slots are duplicates owned by a warp of another
    block."""
    import numpy as np
    import torch
    rng = np.random.default_rng(seed)
    ids = rng.choice(n_rows, batch, replace=False)
    for j in range(0, batch - 2 * block, 3):
        ids[rng.integers(j + block, batch)] = ids[j]
    return torch.from_numpy(ids).to(device)


def lookup_state(int8: bool, base):
    """The leaves a fused lookup updates, as the launcher takes them:
    (table, grad_sum, grad_cnt, grad_sqnorm), or, for int8, the table
    quantized (codes, scale, offset) and the caches."""
    from repro_torch.core import knowledge_bank as kbm
    table, *caches = base
    if int8:
        return [*kbm.quantize_rows(table), *caches]
    return [table, *caches]


def restorer(leaves, source, ids):
    """A setup that puts the rows of ``ids`` of ``leaves`` back as they are
    in ``source`` (a lookup only touches those rows)."""
    import torch
    rows = torch.unique(ids[ids >= 0])

    def setup():
        for a, b in zip(leaves, source):
            a[rows] = b[rows]
    return setup


def lookup_op(int8: bool, leaves, ids) -> dict:
    """One ``CudaBackend.lookup`` (``lookup_q`` for int8) op on ``leaves``:
    its device time by events, the device kernels it queues, the host
    synchronisations it makes and the host time of a call."""
    import warnings
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.core import knowledge_bank as kbm
    from repro_torch.core.kb_engine import CudaBackend
    n = leaves[0].shape[0]
    dev = leaves[0].device
    caches = leaves[3:] if int8 else leaves[1:]
    base = [t.clone() for t in leaves]
    state = kbm.KBState(leaves[0], torch.zeros(n, dtype=torch.int32,
                                               device=dev), *caches,
                        norm_ema=torch.zeros(n, device=dev),
                        step=torch.zeros((), dtype=torch.int32, device=dev))
    bk = CudaBackend()
    if int8:
        def op():
            return bk.lookup_q(state, leaves[1], leaves[2], ids,
                               lazy_lr=LAZY_LR, zmax=ZMAX)
    else:
        def op():
            return bk.lookup(state, ids, lazy_lr=LAZY_LR, zmax=ZMAX)
    setup = restorer(leaves, base, ids)
    out = {"ms": time_ms(op, 50, setup)}
    # The op runs between two sleep kernels. A capture missing either lost
    # its device records (CUPTI now and then delivers none for a capture
    # this short), so it says nothing of the op and is taken again.
    for capture in range(1, PROFILE_CAPTURES + 1):
        setup()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            torch.cuda._sleep(SLEEP_CYCLES // 100)
            op()
            torch.cuda._sleep(SLEEP_CYCLES // 100)
            torch.cuda.synchronize()
        names = [e.name for e in prof.events()
                 if e.device_type == DeviceType.CUDA and "memcpy" not in
                 e.name.lower() and "memset" not in e.name.lower()]
        if sum("spin_kernel" in n for n in names) == 2:
            break
    else:
        raise RuntimeError(
            f"torch.profiler lost the device records of {PROFILE_CAPTURES} "
            "captures in a row (the sleep kernels around the op are "
            "missing)")
    names = [n for n in names if "spin_kernel" not in n]
    out["kernels"] = len(names)
    out["kernel_names"] = sorted(set(n[:48] for n in names))
    out["captures"] = capture
    setup()
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            op()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    out["host_syncs"] = sum("synchroniz" in str(w.message).lower()
                            for w in caught)
    setup()
    out["host_us"] = host_us(op)
    setup()
    return out


def measure(root: Path, kernels) -> list:
    """Build ``root``'s kernels, check each against its plain version and
    time it; runs in a process of its own."""
    sys.path.insert(0, str(root / "src"))
    import torch
    from repro_torch.kernels import _build, ops, ref
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)
    sources = {"flash_attention" if k == "flash_bf16" else
               "ivf_stage2_sharded" if k.startswith("ivf_stage2_sharded")
               else k.removesuffix("_wide") for k in kernels
               if k not in ("launch_floor", "flash_bwd_bf16", *BWD_SOURCES)}
    for k in kernels:
        sources |= set(BWD_SOURCES.get(k, ()))
    if "lookup_op" in sources:
        sources = (sources - {"lookup_op"}) | set(LOOKUPS)
    if "flash_bwd_bf16" in kernels:
        sources |= {"flash_attention", "flash_attention_bwd"}
    # a checkout older than the AdamW kernel runs the eager update
    sources &= set(_build.SOURCES)
    _build.build(sorted(sources))
    bank = queries = lookups = None
    if any(k == "nn_search" or k in STAGE2 for k in kernels):
        bank = torch.randn((N_ROWS, DIM), generator=g, device=dev)
        queries = bank[torch.randint(0, bank.shape[0], (32,), generator=g,
                                     device=dev)] + 0.01
    if any(k in LOOKUPS or k == "lookup_op" for k in kernels):
        g.manual_seed(0)
        *lookups, pending = lookup_bank(g)
        ids = lookup_ids(g, pending)
        wide = spread_ids(N_ROWS, dev)
    out = []
    for kernel in kernels:
        extra = {}
        if kernel == "flash_bf16":
            g.manual_seed(0)
            q, k, v = (torch.randn((4, 2048, n, 128), generator=g,
                                   device=dev).to(torch.bfloat16)
                       for n in (32, 4, 4))
            fn = ops.LAUNCHERS["flash_attention"]
            got = fn(q, k, v, causal=True)
            err = (got.float() - ref.flash_attention_ref(
                q, k, v, causal=True).float()).abs().max().item()
            ms = time_ms(lambda: fn(q, k, v, causal=True), 20)
            extra = {"digest": digest(got)}
            from repro_torch.kernels import flash_attention as fa
            if hasattr(fa, "flash_stage_cycles"):   # a checkout that has it
                extra["stage_cycles"] = fa.flash_stage_cycles(
                    q, k, v, causal=True)
        elif kernel == "nn_search":
            fn = ops.LAUNCHERS["nn_search"]
            s, i = fn(queries, bank, 8)
            ws, wi = ref.nn_search_ref(queries, bank, 8)
            err = (s - ws).abs().max().item()
            err = max(err, 0.0 if torch.equal(i, wi) else float("inf"))
            ms = time_ms(lambda: fn(queries, bank, 8), 20)
            extra = {"digest": digest(s, i),
                     "host_us": host_us(lambda: fn(queries, bank, 8)),
                     "padded": {
                         label: padded_check(fn, ref.nn_search_ref, q, real,
                                             lambda q: (q, bank), 8)
                         for label, q, real in padded_batches(queries)}}
        elif kernel in STAGE2:
            args, plain, rest = stage2_inputs(kernel, bank, queries)
            fn = ops.LAUNCHERS[kernel]
            k, other = STAGE2[kernel][2:]
            s, i = fn(*args, k)
            ws, wi = plain(*args, k)
            # ids are held by chip_smoke.py's gaps; here the largest score
            # error and the share of ids equal at their rank
            err = (s - ws).abs().max().item()
            extra = {"digest": digest(s, i),
                     "ids_equal": (i == wi).float().mean().item(),
                     "ms_other_k": time_ms(lambda: fn(*args, other), 20),
                     "host_us": host_us(lambda: fn(*args, k)),
                     "padded": {
                         label: padded_check(fn, plain, q, real, rest, k)
                         for label, q, real in padded_batches(queries)}}
            ms = time_ms(lambda: fn(*args, k), 20)
            from repro_torch.kernels import ivf_stage2 as s2
            if hasattr(s2, "ivf_stage2_cycles"):    # a checkout that has it
                extra["stage_cycles"] = s2.ivf_stage2_cycles(kernel, *args,
                                                             k=k)
            del args
        elif kernel in ("rwkv_wkv", "mamba_scan"):
            g.manual_seed(0)
            args = (wkv_inputs(4, 2048, 64, 64, torch.bfloat16, g)
                    if kernel == "rwkv_wkv" else
                    scan_inputs(4, 2048, 16384, 16, torch.bfloat16, g))
            fn = ops.LAUNCHERS[kernel]
            got, want = fn(*args), getattr(ref, f"{kernel}_ref")(*args)
            err = max((a - b).abs().max().item() for a, b in zip(got, want))
            extra = {"digest": digest(*got)}
            del got, want
            ms = time_ms(lambda: fn(*args), 20)
            mod = importlib.import_module(f"repro_torch.kernels.{kernel}")
            if hasattr(mod, f"{kernel}_cycles"):    # a checkout that has it
                extra["stage_cycles"] = getattr(mod, f"{kernel}_cycles")(
                    *args)
            del args
        elif kernel in LOOKUPS:
            int8 = kernel == "kb_fused_lookup_q"
            fn = ops.LAUNCHERS[kernel]
            plain = getattr(ref, f"{kernel}_ref")
            base = lookup_state(int8, lookups)
            with_version = "version" in inspect.signature(fn).parameters
            ver = {"version": torch.zeros(N_ROWS, dtype=torch.int32,
                                          device=dev)} if with_version \
                else {}
            err = 0.0
            for batch in (ids, wide):
                got = [t.clone() for t in base]
                want = [t.clone() for t in base]
                vals = fn(*got, batch, lazy_lr=LAZY_LR, zmax=ZMAX, **ver)
                err = max(err, (vals - plain(
                    *want, batch, lazy_lr=LAZY_LR,
                    zmax=ZMAX)).abs().max().item())
                del got, want
            leaves = [t.clone() for t in base]
            ms = time_ms(lambda: fn(*leaves, ids, lazy_lr=LAZY_LR,
                                    zmax=ZMAX, **ver), 50,
                         restorer(leaves, base, ids))
            extra = {"with_version": with_version,
                     "ms_b1024": time_ms(
                         lambda: fn(*leaves, wide, lazy_lr=LAZY_LR,
                                    zmax=ZMAX, **ver), 50,
                         restorer(leaves, base, wide)),
                     "host_us": host_us(lambda: fn(
                         *leaves, ids, lazy_lr=LAZY_LR, zmax=ZMAX, **ver))}
            del leaves, base
        elif kernel == "lookup_op":
            ms, err = None, None
            for int8 in (False, True):
                leaves = lookup_state(int8, [t.clone() for t in lookups])
                extra["int8" if int8 else "fp32"] = lookup_op(int8, leaves,
                                                              ids)
                del leaves
        elif kernel == "launch_floor":
            ms, err = time_ms(lambda: torch.cuda._sleep(0), 200), None
        elif kernel in WIDE:
            ms, err, extra = measure_wide(kernel, g)
        elif kernel == "flash_bwd_bf16":
            ms, err, extra = measure_flash_bwd(g)
        elif kernel == "adamw":
            ms, err, extra = measure_adamw()
        elif kernel == "wkv_bwd":
            ms, err, extra = measure_wkv_bwd(g)
        elif kernel == "scan_bwd":
            ms, err, extra = measure_scan_bwd(g)
        else:
            raise ValueError(f"unknown kernel {kernel!r}")
        out.append({"root": str(root), "kernel": kernel, "ms": ms,
                    "max_abs_err": err, **extra})
        torch.cuda.empty_cache()
    return out


def measure_wide(kernel: str, g):
    """(ms, max_abs_err, extra) of a search kernel at width 4096 (the
    module docstring's wide shapes); a kernel that refuses the width gives
    (None, None, {"refused": its message})."""
    import torch
    from repro_torch.kernels import ops, ref
    dev = torch.device("cuda")
    g.manual_seed(1)
    name = kernel.removesuffix("_wide")
    rows, nq = ((MAKER_ROWS, MAKER_QUERIES) if name == "nn_search"
                else (WIDE_IVF_ROWS, 32))
    bank = torch.randn((rows, WIDE_DIM), generator=g, device=dev)
    queries = bank[torch.randint(0, rows, (nq,), generator=g,
                                 device=dev)] + 0.01
    fn = ops.LAUNCHERS[name]
    if name == "nn_search":
        args, plain, ks = (queries, bank), ref.nn_search_ref, (9, 32)
    else:
        args, plain, _ = stage2_inputs(name, bank, queries)
        ks = STAGE2[name][2:3]
    try:
        s, i = fn(*args, ks[0])
    except ValueError as e:
        return None, None, {"refused": str(e)}
    ws, wi = plain(*args, ks[0])
    err = (s - ws).abs().max().item()
    extra = {"dim": WIDE_DIM, "rows": rows, "queries": nq, "k": ks[0],
             "ids_equal": (i == wi).float().mean().item(),
             "digest": digest(s, i),
             "repeat_identical": all(torch.equal(a, b) for a, b in zip(
                 (s, i), fn(*args, ks[0])))}
    for k in ks[1:]:
        extra[f"ms_k{k}"] = time_ms(lambda: fn(*args, k), 20)
    return time_ms(lambda: fn(*args, ks[0]), 20), err, extra


def measure_flash_bwd(g):
    """(ms, max_abs_err, extra) of the flash backward on the yi-6b
    prefill's bf16 q, k, v (B 4, S 2048, H 32, KV 4, d 128, causal) with
    N(0, 1) output gradients, on the forward's own output and
    log-sum-exp; ``ms_b2`` at the training shape (B 2); ``digest`` of dq,
    dk and dv at B 4."""
    import torch
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels.flash_attention import flash_attention_with_lse
    dev = torch.device("cuda")
    kern = ops.LAUNCHERS["flash_attention_bwd"]
    out = {}
    for B in (4, 2):
        g.manual_seed(0)
        q, k, v, dout = (torch.randn((B, 2048, n, 128), generator=g,
                                     device=dev).to(torch.bfloat16)
                         for n in (32, 4, 4, 32))
        o, lse = flash_attention_with_lse(q, k, v, causal=True)
        got = kern(q, k, v, o, lse, dout, causal=True)
        out[B] = time_ms(lambda: kern(q, k, v, o, lse, dout, causal=True),
                         10)
        if B == 4:
            want = ref.flash_attention_bwd_ref(q, k, v, o, lse, dout,
                                               causal=True)
            err = max((a - b).abs().max().item()
                      for a, b in zip(got, want))
            extra = {"digest": digest(*got), "repeat_identical": all(
                torch.equal(a, b) for a, b in zip(
                    got, kern(q, k, v, o, lse, dout, causal=True)))}
            del want
        del q, k, v, dout, o, lse, got
        torch.cuda.empty_cache()
    extra["ms_b2"] = out[2]
    return out[4], err, extra


def ptxas_report(log: str) -> dict:
    """{kernel function: (registers, stack frame bytes, spill store bytes,
    spill load bytes)} from ``nvcc -Xptxas -v`` output; the names
    demangled where ``c++filt`` is found."""
    import re
    import shutil
    out, name = {}, None
    frame = None
    for line in log.splitlines():
        m = re.search(r"Function properties for (\S+)", line)
        if m:
            name = m.group(1)
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", line)
        if m and name:
            frame = tuple(int(x) for x in m.groups())
            continue
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            name = m.group(1)
            continue
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            out[name] = (int(m.group(1)), *(frame or (0, 0, 0)))
            name, frame = None, None
    if out and shutil.which("c++filt"):
        names = list(out)
        plain = subprocess.run(["c++filt"], input="\n".join(names),
                               capture_output=True, text=True).stdout.split(
                                   "\n")
        if len(plain) >= len(names):
            # "void (anonymous namespace)::wkv_bwd<T, 64>(...)" -> "wkv_bwd<T, 64>"
            short = [re.sub(r"^void |\(anonymous namespace\)::", "",
                            p.strip()).split("(")[0] for p in plain]
            out = {sh: out[n] for n, sh in zip(names, short)}
    return out


def bwd_ptxas(source: str, pattern: str) -> dict:
    """The ptxas report of ``source``'s functions whose name holds
    ``pattern`` (the backward kernel's instances), from this process's
    build of its checkout."""
    from repro_torch.kernels import _build
    return {k: v for k, v in ptxas_report(_build.compiler_log(source)).items()
            if pattern in k}


def measure_wkv_bwd(g):
    """(ms, max_abs_err, extra) of the WKV backward at the rwkv6-7b
    prefill's shape (B 4, S 2048, H 64, d 64, r/k/v bf16, ``wkv_inputs``)
    with N(0, 1) gradients of y and of the final state, on the forward's
    own checkpoints: max abs error against ``ref.rwkv_wkv_bwd_ref``,
    ``digest`` of the five gradients, ``repeat_identical``; ``ms_train``
    at the rwkv6-7b training run's shape (B 8, S 64), with its own digest;
    ``ptxas``: registers, stack frame and spill bytes of the kernel's
    instances."""
    import torch
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels.rwkv_wkv import rwkv_wkv_checkpoints
    dev = torch.device("cuda")
    kern = ops.LAUNCHERS["rwkv_wkv_bwd"]
    out = {}
    for B, S in ((4, 2048), (8, 64)):
        g.manual_seed(0)
        args = wkv_inputs(B, S, 64, 64, torch.bfloat16, g)
        dy = torch.randn((B, S, 64, 64), generator=g, device=dev)
        ds = torch.randn((B, 64, 64, 64), generator=g, device=dev)
        _, _, ckpt = rwkv_wkv_checkpoints(*args)
        got = kern(*args, ckpt, dy, ds)
        res = {"ms": time_ms(lambda: kern(*args, ckpt, dy, ds), 10),
               "digest": digest(*got)}
        if B == 4:
            want = ref.rwkv_wkv_bwd_ref(*args, dy, ds)
            res["err"] = max((a - b).abs().max().item()
                             for a, b in zip(got, want))
            res["repeat_identical"] = all(torch.equal(a, b) for a, b in zip(
                got, kern(*args, ckpt, dy, ds)))
            del want
            from repro_torch.kernels import rwkv_wkv as mod
            if hasattr(mod, "rwkv_wkv_bwd_cycles"):   # a checkout with it
                res["cycles"] = {"stage_cycles": mod.rwkv_wkv_bwd_cycles(
                    *args, ckpt, dy, ds)}
        out[B] = res
        del args, dy, ds, ckpt, got
        torch.cuda.empty_cache()
    extra = {"digest": out[4]["digest"],
             "repeat_identical": out[4]["repeat_identical"],
             "ms_train": out[8]["ms"], "digest_train": out[8]["digest"],
             "ptxas": bwd_ptxas("rwkv_wkv_bwd", "wkv_bwd"),
             **out[4].get("cycles", {})}
    return out[4]["ms"], out[4]["err"], extra


def measure_scan_bwd(g):
    """(ms, max_abs_err, extra) of the scan backward at the jamba layer's
    shape (B 4, S 2048, di 16384, ds 16, x bf16, ``scan_inputs``) with
    N(0, 1) gradients of y and of the final state, on the forward's own
    checkpoints: max abs error against ``ref.mamba_scan_bwd_ref``,
    ``digest`` of the five gradients, ``repeat_identical``, and ``ptxas``
    of the kernel's instances."""
    import torch
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels.mamba_scan import mamba_scan_checkpoints
    dev = torch.device("cuda")
    kern = ops.LAUNCHERS["mamba_scan_bwd"]
    g.manual_seed(0)
    B, S, di, ds = 4, 2048, 16384, 16
    args = scan_inputs(B, S, di, ds, torch.bfloat16, g)
    dy = torch.randn((B, S, di), generator=g, device=dev)
    dh = torch.randn((B, di, ds), generator=g, device=dev)
    _, _, ckpt = mamba_scan_checkpoints(*args)
    got = kern(*args, ckpt, dy, dh)
    want = ref.mamba_scan_bwd_ref(*args, dy, dh)
    err = max((a - b).abs().max().item() for a, b in zip(got, want))
    del want
    extra = {"digest": digest(*got), "repeat_identical": all(
        torch.equal(a, b) for a, b in zip(got, kern(*args, ckpt, dy, dh))),
        "ptxas": bwd_ptxas("mamba_scan_bwd", "scan_bwd")}
    from repro_torch.kernels import mamba_scan as mod
    if hasattr(mod, "mamba_scan_bwd_cycles"):        # a checkout with it
        extra["stage_cycles"] = mod.mamba_scan_bwd_cycles(*args, ckpt, dy,
                                                          dh)
    ms = time_ms(lambda: kern(*args, ckpt, dy, dh), 10)
    return ms, err, extra


def measure_adamw():
    """(ms, None, extra) of ``AdamW.update`` (AdamW's defaults, lr 1e-4,
    count 3) on the leaves of yi-6b cut to ADAMW_LAYERS layers (bf16
    weights and gradients, fp32 norm scales and moments), whichever way the
    checkout runs it; gradients N(0, 1e-5^2), so that the global norm
    stays under the clip and the update's scale is 1 on every checkout:
    ``digest`` hashes the integer sums of the new parameters' and
    moments' bits after one update from the same inputs."""
    import hashlib
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    from repro_torch.optim import AdamW, constant_lr
    from repro_torch.tree import tree_leaves, tree_map
    dev = torch.device("cuda")
    cfg = get_config("yi-6b").replace(num_layers=ADAMW_LAYERS)
    params = build_model(cfg).init(torch.Generator(device=dev).manual_seed(0))
    opt = AdamW(lr=constant_lr(1e-4))
    state = opt.init(params)
    gen = torch.Generator(device=dev).manual_seed(1)
    rand = lambda t, s: (torch.randn(t.shape, generator=gen, device=dev)
                         * s).to(t.dtype)
    grads = tree_map(lambda t: rand(t, 1e-5), params)
    for leaf in tree_leaves(state.mu):
        leaf.copy_(torch.randn(leaf.shape, generator=gen, device=dev) * 1e-6)
    for leaf in tree_leaves(state.nu):
        leaf.copy_(torch.randn(leaf.shape, generator=gen, device=dev) ** 2
                   * 1e-10)
    state.count.fill_(2)
    _, state, gn = opt.update(grads, state, params)
    sums = [int(t.view(torch.int16 if t.element_size() == 2
                       else torch.int32).sum(dtype=torch.int64))
            for tree in (params, state.mu, state.nu)
            for t in tree_leaves(tree)]
    extra = {"gn": float(gn), "digest": hashlib.sha256(
        repr(sums).encode()).hexdigest()[:16],
        "entries": sum(t.numel() for t in tree_leaves(params))}
    ms = time_ms(lambda: opt.update(grads, state, params), 5)
    return ms, None, extra


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--other", type=Path, default=None)
    ap.add_argument("--kernel", default="flash_bf16",
                    help="comma-separated, of " + ", ".join(KERNELS))
    ap.add_argument("--rounds", type=int, default=1)
    ap.add_argument("--measure", type=Path, default=None,
                    help=argparse.SUPPRESS)
    args = ap.parse_args()
    kernels = args.kernel.split(",")
    if not set(kernels) <= set(KERNELS):
        ap.error(f"--kernel takes names of {', '.join(KERNELS)}")
    if args.measure is not None:
        for line in measure(args.measure.resolve(), kernels):
            print(json.dumps(line), flush=True)
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
        for line in out.stdout.strip().splitlines()[-len(kernels):]:
            print(line, flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
