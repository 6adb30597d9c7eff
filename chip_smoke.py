#!/usr/bin/env python3
"""Quickest proof that the PyTorch port (src/repro_torch) runs on the GPU.

Run from the root of a checkout, on a machine with one CUDA device:

    python3 chip_smoke.py

Phases, in order; any failed check raises and the script exits non-zero:

1. device and build: the card's name and power limit, the torch and CUDA
   versions, and the build of every kernel from src/repro_torch/kernels/csrc
   (nvcc, sm_90a), with each kernel's registers and spills, and each
   instance of the WKV and scan backwards by name, none of the main
   path's with a stack frame or spills;
2. each kernel against its plain PyTorch version at the serve path's
   shapes: a 1,939,743 x 128 fp32 bank (ogbn-mag) with a fifth of its rows
   holding pending gradients, 32 ids (8 clients x batch 4) and 32 queries,
   k = 8; the same bank quantized to int8 for the int8 lookup; an IVF
   index of 64 buckets built by the port over each bank for the two
   stage-2 kernels (k = 8 over fp32 rows, the int8 engine's kq = 32 over
   int8 rows), and a 3-shard index of 64 buckets per shard over the fp32
   bank for the sharded stage-2 kernel (8 probes per shard; k = 8 over
   fp32 rows and the sharded int8 shortlist's kq = 32 over its int8
   twin), each stage-2 entry also repeated (bit-identical), timed at the
   other entry's k and profiled once (its items, the partial pass's and
   the merge's windows, where its warps' cycles go). Error, kernel time,
   plain time, the least time the card could take (bytes over 3.35 TB/s
   or fp32 operations over 67 TFLOP/s, from this run's data) and, where
   one PyTorch call computes the same function, that call's time. The
   two fused lookups run with the version bump, also at a batch of 1024
   whose duplicates lie in other blocks, each repeated (bit-identical),
   beside the launch floor (an empty kernel by the same events); then
   the whole CudaBackend lookup and lookup_q ops, which must launch one
   kernel and make no host sync (torch's sync debug mode raises on one);
3. engine parity: the cuda backend against the dense reference on one op
   stream (duplicate ids, update, lazy_grad, lookup, flush, nn_search with
   and without exclusion), for lazy_update True and False and for int8
   storage (every leaf, scale and offset, versions), and IVF search on one
   index, fp32 and int8; a repeated cuda run bit-identical, and two index
   builds of one snapshot identical. The lazy_update=False run is the path
   of the row gather kernel. Then the sharded backend (3 shards) against
   its plain reference on one op stream, exact search per shard and IVF
   through one sharded index, fp32 and int8 (an int8 index over the fp32
   table); a repeated run bit-identical; and a partial rebuild of one
   shard on the card that leaves the other shards' arrays bit-identical
   and their write clocks as they were. Then tiered residency at the
   repo's cold-tier configuration (8,192 x 128 over 2,048 device slots,
   cold after 1,024 written rows, N(0, 1) rows): fp32, fp32 with
   lazy_update False, int8 and fp32 on a disk store, each through waves
   of update, lazy_grad and lookups that fault rows back, a flush, exact
   search with and without exclusion and (lazy engines) IVF search through
   an index a refresher built over the slots: lookups, table and versions
   bit-identical to the untiered cuda engine's, slot maps and fault and
   spill counts exact against a tiered engine on the CPU, search ids
   global with exact scores, a repeat bit-identical; and export_rows ->
   import_rows between two cuda engines and from the CPU to the card
   bit-identical;
4. serve: repro_torch.launch.serve at full width on the cuda backend, 8
   clients, each run ending in a flush: exact search over fp32 rows, then
   IVF search over fp32 and over int8 rows (``--kb-search ivf``, nlist 64,
   nprobe 8), then ``--kb-backend sharded --kb-shards 3 --kb-search ivf``
   (64 buckets and 8 probes per shard), and between the first two the
   fp32 exact serve from 484,936 device slots (a quarter of the bank; the
   rest in host RAM, cold after 242,468 written rows), which must fault
   rows in, spill rows and launch the lookup, search and flush kernels;
   every kernel counter is set to 0 just before each run and read just
   after. Then, on a server of the
   sharded run's configuration with its refresher, the rows of shard 1
   that the refresher's per-shard budget asks for are rewritten twice:
   with their own values, when the refresher must rebuild shard 1 alone,
   shards 0 and 2 keeping their arrays bit for bit and their clocks; and
   with fresh N(0, 1) values, when it stays partial only if shard 1's new
   buckets fit the common capacity (which it did, and the capacity before
   and after, are printed);
5. LM serving: the reduced yi-6b (2 layers, d 128, fp32) on the card
   against the CPU on one set of parameters (hidden, prefill cache, four
   decode steps' logits and ids), then repro_torch.launch.serve's
   ``serve_lm`` at the full width of yi-6b (32 layers, d 4096, 32 heads,
   4 KV heads, d_ff 11008, vocab 64000, bf16, random weights from seed 0)
   at batch 4, a 2048-token prompt and 16 decoded tokens, twice: prefill
   and decode times, peak device memory, 32 flash-attention launches per
   prefill, and identical ids from the two runs; then one profiled
   prefill and decode;
6. RWKV6 serving: the reduced rwkv6-7b (2 layers, d 128, 4 WKV heads of
   32, fp32) on the card against the CPU (hidden, the prefill cache's
   state S and x_prev, four decode steps' logits and ids); then, with
   yi-6b's weights freed and the peak-memory counter reset, ``serve_lm``
   at the full width of rwkv6-7b (32 layers, d 4096, 64 WKV heads of 64,
   d_ff 14336, vocab 65536, bf16, random weights from seed 0) at batch 4,
   a 2048-token prompt and 16 decoded tokens, twice: 32 WKV launches per
   prefill and none in decode, identical ids; then one profiled prefill
   and decode;
7. jamba serving: the reduced jamba-1.5-large-398b (one 8-layer group of
   seven Mamba layers and one attention layer, MoE of 4 experts on the odd
   positions, d 128, fp32) on the card against the CPU (hidden, every
   cache entry: the Mamba layers' h and conv_buf, the attention layer's k
   and v, and four decode steps' logits and ids); then, with rwkv6-7b's
   weights freed and the peak-memory counter reset, ``serve_lm`` on
   jamba cut to one card (one group of 8 layers and 8 of its 16 experts,
   every width as published: d 8192, 64/8 heads of 128, d_ff 24576,
   d_state 16, expand 2, vocab 65536, top-2, bf16, random weights from
   seed 0; 25.79 B parameters) at batch 4, a 2048-token prompt and 16
   decoded tokens, twice: 7 Mamba-scan launches and 1 flash-attention
   launch per prefill and none in decode, identical ids; then one
   profiled prefill and decode, the device time split by part (GEMMs,
   the scan, flash, the MoE dispatch's gathers and sorts, elementwise),
   and one Mamba layer profiled alone (its GEMMs, scan and elementwise
   passes);
8. training: the reduced yi-6b (2 layers, d 128, fp32), rwkv6-7b (2
   layers) and jamba (one group of 8 layers) each take one
   ``make_carls_train_step`` step on the card and on the CPU from one set
   of parameters, one bank (a fifth of its rows pending) and one batch:
   loss and metrics, the neighbour gradient, the post-step parameters and
   moments and every bank leaf compared at the CPU tests' bounds (on the
   card rwkv6-7b's step launches the WKV kernel and its backward twice,
   jamba's the scan and its backward 7 times); then,
   with jamba's weights freed, ``repro_torch.launch.train.train_carls`` at
   the full width of yi-6b cut to 16 of its 32 layers (d 4096, 32/4 heads
   of 128, d_ff 11008, vocab 64000, bf16 parameters, fp32 AdamW moments;
   3.29 B parameters) at batch 8 x seq 64, a 2048 x 4096 fp32 bank and 8
   neighbours a sample, lr 1e-4, 10 steps with the maker pass on step 10:
   losses
   finite and falling, one ``kb_fused_lookup`` and one ``adamw`` launch a
   step and no flash, WKV or scan launch, ms a step (steps 3-10), peak
   device memory, and one more step profiled (device time by part: GEMMs,
   the lookup kernel, the optimizer and the AdamW kernel's launches within
   it, elementwise; and by the step's ranges); then the
   10 steps again from the same seed, whose losses must be within 1% of
   the first run's at every step (whether they are bit-identical is
   printed); then the same two runs of ``train_carls`` at the full width
   of rwkv6-7b cut to 12 of its 32 layers (d 4096, 64 WKV heads of 64,
   d_ff 14336, vocab 65536; 3.66 B parameters) at 8 x 64 and at 2 x 2048
   (the WKV backward at the prefill's sequence length), each with 24 WKV
   forward launches a step (12, and 12 in the recompute) and 12
   backward (and 12 forwards in the maker pass) and one more step
   profiled (the WKV kernels' device time and
   share of the step's), and of yi-6b's 16 layers at batch 2 x seq 2048,
   where each layer
   takes the flash kernel forward and backward: ms a
   step, peak device memory, losses finite and the two runs within 1%,
   then once more with ``remat=False`` beside it (ms a step and peak:
   what remat costs and saves). The full-width configs keep their
   ``remat`` (policy ``nothing``: each layer's forward runs again in the
   backward's recompute), so a step launches each layer's WKV or flash
   forward twice and its backward once, and the maker pass its forward
   once more;
   then one full-width jamba Mamba layer (d 8192, di 16384, ds 16, bf16)
   forward and backward at 4 x 2048 with gradients on y and on the final
   state, through the scan kernels and through the plain scan on the
   card: every gradient within 1% of the plain one's norm, its time and
   peak memory;
9. the knowledge makers and their runtime (``run_async_training``):
   (a) the twin of examples/quickstart.py on the card (the reduced
   yi-6b of 2 layers, 1,024 nodes, seq 33, 8 clusters, 60 steps of batch
   16, two embedding-refresh makers of batch 64, a checkpoint every 5
   steps, lr 2e-3, seed 0), which must show the quickstart's three
   trends: the loss falls (~6.4 -> ~5.3), the graph loss ends below 0.1,
   and the bank's rows sit nearer their graph neighbours' than random
   nodes'; (b) the full-width triangle: yi-6b cut to 16 layers as in
   phase 8 (bf16, fp32 moments), batch 8 x seq 64, 2,048 nodes, lr 1e-4,
   the trainer's push, all four makers of batch 64, a checkpoint every 5
   steps, 20 steps, once with the makers, once without, and once with
   them paced at 0.05 s (the serving makers' default): ms a step
   (median of steps 3-20, the train core and the whole loop step), each
   maker's line (each of the four kinds must step, none may fail, in
   both runs with makers), peak device memory, the server's coalescing,
   and the launches of kb_fused_lookup and nn_search at width 4096 on
   that path (both must launch); then 8 steps with the makers under
   torch.profiler: the device's busy share of steps 3-8 and its time
   split between the trainer's kernels and the makers' and server's;
   (c)
   ``serve --kb --kb-makers graph_builder`` at phase 4's fp32 exact
   configuration, whose graph builder must write rows;
10. the wire protocol v4 and the fleet, each bank, member, maker worker
   and trainer a process of its own on the card (``python -m
   repro_torch.launch.serve --kb --listen 127.0.0.1:0`` and the others),
   this process only their client: (a) one bank at phase 4's fp32 exact
   configuration against the same bank in this process (same seed, fill
   and warm-up): a fixed op stream (8 rounds of lookups, lazy gradients,
   updates, searches with and without exclusion, a flush and a lookup of
   every touched row) whose results, table and touched rows' leaves
   (versions included) must be bit-identical, then the 8-client drive's
   req/s over the wire and in process, one sample each; (b) members
   ``--kb-join 0/2`` and ``1/2`` and a ``--replica-of`` standby of member
   0 behind a ``KBRouter``: the same op stream bit-identical to one bank
   in this process (ids, scores, table), then 24 writes of 32 rows
   stream while member 0 is SIGKILLed after 12: one promotion, and every
   acknowledged write must read back; (c) the train launcher's
   ``--makers graph_builder --kb-connect`` mode (``run_async``) at phase
   8's configuration
   against a ``serve --kb --kb-entries 2048 --kb-dim 4096`` process (its
   rows set to zeros, as the in-process triangle's bank), with a
   ``maker_worker --makers graph_builder`` process beside it: losses
   finite and falling, ms a step beside phase 9's, the summed peak of the
   processes under 80 GB. Each process's kernel launches on its path are
   read from its server's stats (``"device"``) just before and just after
   the path, and each path must launch the lookup, flush and search
   kernels (the trainer: AdamW; its bank: the lookup and the search);
11. the rest of the LM zoo (run after phase 7, beside the other LM
   phases): (b) the reduced minitron-4b, granite-34b (MQA),
   command-r-plus-104b (tied embeddings), grok-1-314b (8 experts, soft
   cap 30), kimi-k2-1t-a32b (also at its head dim 112), internvl2-2b (16
   N(0, 1) patch embeddings before the prompt) and whisper-tiny (an
   encoder over 16 N(0, 1) frames, cross-attention) on the card against
   the CPU as phases 5-7 hold theirs, each prefill's flash launches
   counted (whisper's encoder layers among them); (c) each at full width
   (bf16, random weights from a torch.Generator, batch 4, a 2048-token
   prompt, whisper's 432, 16 greedy tokens; the front-end inputs N(0, 1)
   from numpy), cut to one card in depth alone (kimi-k2 also to 128 of
   its 384 experts, top-8 kept; ZOO_CUTS), the weights built once and the
   prompt served twice: prefill ms, decode ms a token, peak memory, flash
   launches per prefill and none in decode, the same ids twice; kimi-k2's
   prefill profiled;
12. the same seven archs train at full width (run after phase 8), bf16
   parameters, fp32 AdamW moments, a 2048 x d_model fp32 bank, 8
   neighbours, lr 1e-4, the config's remat, each cut in depth only as
   far as one card forces (ZOO_TRAIN: minitron whole, granite 5 of 88
   layers, command-r 1 of 64, grok 1 of 64 with 4 of its 8 experts,
   kimi 2 of 61 with 16 of its 384 experts, internvl and whisper whole)
   at 2 x 2048 (whisper 8 x 432): the five text archs through
   ``train_carls`` (the maker pass on the last step), internvl (256
   N(0, 1) patch embeddings) and whisper (1,500 N(0, 1) frames) through
   ``make_carls_train_step`` with the input in each batch; 6 steps each:
   losses finite, the exact launches (a lookup and an AdamW update a
   step, flash forward twice and backward once a decoder attention layer
   a step, whisper's encoder layers once each way, the maker pass's
   forwards), ms a step (steps 3-6), peak memory; grok-1 and kimi-k2 twice
   from one seed, the losses within 1%.

Phase 2 also holds nn_search beyond the serve shape (a repeated run
bit-identical, k = 128, a bank of 100,003 rows, and a bank planted three
times over whose equal scores must go to the lowest id), and at the
trainer's width: the makers' search (64 queries over a 2048 x 4096 bank
of unit-norm rows, k 9 and 32: scores within 1e-4 plus 8 fp32 ulps,
ids exact where separated, a repeat bit-identical, timed beside its
bound), D 8192 and D 1,544 (a width no multiple of the 16-dim stage;
N(0, 1) rows, scores within 1e-4 plus a probabilistic rounding bound of
two D-term sums, 2 LAMBDA_WIDE sqrt(D) 2^-24 sum|q r|), and the four
stage-2 entries at D 4096 (an index of 64 buckets, or 3 shards of 64,
over 61,440 unit-norm rows, 32 queries probing 8, then 80 queries: three
query tiles, the last partial), and the
flash-attention kernel against its plain version at the prefill's shapes
(B 4, S 2048, H 32, KV 4, d 128, causal) in bf16 and fp32, beside
``scaled_dot_product_attention`` as the library yardstick, with the bf16
kernel's stage profile (the cycles its consumer warpgroups spend waiting
for K and V, for their turn, issuing products, waiting for them, in the
softmax and in the output) and whether it reaches SDPA's time in this
run, and on seven smaller cases (window, soft cap, d 32 and 64, not
causal, S no multiple of 128, H/KV 8), at the zoo's prefill shapes in
bf16 (FLASH_ZOO: kimi-k2's heads of 112, grok-1's soft cap, whisper's
1500-frame encoder, not causal, and internvl's 2304 positions; each
timed beside its bound and, but for the soft cap, SDPA's time), at d 112
on three small cases in bf16 and fp32, and under autograd at d 112
(the Function: one forward and one backward launch); the three backward
kernels
(``flash_attention_bwd``, ``rwkv_wkv_bwd``, ``mamba_scan_bwd``) at those
full-width shapes and on FLASH_SMALL's, WKV_SMALL's and SCAN_SMALL's
cases (each against its plain backward on the forward's own log-sum-exp
or checkpoints, twice bit-identical, and its autograd Function against
``torch.autograd`` of the plain forward; timed beside its bound, the
plain backward and, for flash, SDPA's backward; the flash backward also
at the yi-6b training run's B 2, with its bound and SDPA's, and split by
device kernel under torch.profiler, at d 112 on the three small cases in
bf16 and fp32, and at phase 12's training shapes (FLASH_BWD_ZOO:
kimi-k2's d 112, grok-1's soft cap, whisper's encoder, internvl's 2304
positions); the WKV and scan backwards with their
stage profiles, WKV's also at the rwkv6-7b training run's B 8 x S 64),
the AdamW kernel at phase 8's leaves
(the global norm within 1e-5 of the plain version's, every parameter and
moment bit-identical to the plain update's given the kernel's clip scale,
a second run bit-identical, one step without a host sync; timed beside
its bytes bound, the plain version's eager passes and
``torch.optim.AdamW(fused=True).step()`` as the library yardstick),
``kb_fused_lookup`` at
the trainer's shape (a 2048 x 4096 fp32 bank, a fifth of its rows pending,
and the 64 neighbour ids of the trainer's first batch of 8, duplicates
included: rows against the plain version, versions exact, a repeat
bit-identical, its time beside the bytes bound and the launch floor),
and the WKV kernel
(y and the final state) at the rwkv6-7b prefill's shapes (B 4, S 2048,
H 64, d 64; r, k, v bf16, w and u fp32) and on smaller cases (two with
extreme decays, w from 0 to ~0.9997 per channel), and the Mamba scan
kernel (y and the final state) at the jamba prefill's shapes (B 4,
S 2048, di 16384, ds 16; x bf16, delta, B, C and A fp32), there again
with a trained model's per-channel A, and on smaller cases (one step, S
and di no multiple of the kernel's chunk and block, fp32 x, per-channel
A); phase 3
first sends out-of-range ids to a cuda server, which must refuse them,
leave the bank as it was and serve the next request.

It prints the kernels' record as one JSON line before the last, and as
the last line ``{"ok": true, "device": {...}}``. It imports nothing of JAX
or of the JAX package.
"""
import bisect
import gc
import json
import math
import os
import re
import signal
import subprocess
import sys
import tempfile
import threading
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro_torch import convert  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core import ann_index  # noqa: E402
from repro_torch.core import knowledge_bank as kbm  # noqa: E402
from repro_torch.core.async_runtime import (  # noqa: E402
    KnowledgeBankServer, MakerRuntime, format_maker_stats,
    run_async_training)
from repro_torch.core.kb_engine import (  # noqa: E402
    CudaBackend, DenseBackend, KBEngine, KBIdError, ShardedBackend,
    make_kb_ops)
from repro_torch.core.kb_router import connect_kb  # noqa: E402
from repro_torch.core.kb_transport import RemoteKnowledgeBank  # noqa: E402
from repro_torch.kernels import _build, ops, ref  # noqa: E402
from repro_torch.kernels.flash_attention import (  # noqa: E402
    flash_attention_with_lse, flash_stage_cycles)
from repro_torch.kernels.ivf_stage2 import ivf_stage2_cycles  # noqa: E402
from repro_torch.kernels.mamba_scan import (  # noqa: E402
    mamba_scan_bwd_cycles, mamba_scan_checkpoints, mamba_scan_cycles,
    pad_channels)
from repro_torch.kernels.nn_search_ivf import (  # noqa: E402
    global_probes, ivf_probes, ivf_search_sharded_ref, sharded_probes)
from repro_torch.kernels.rwkv_wkv import (  # noqa: E402
    rwkv_wkv_bwd_cycles, rwkv_wkv_checkpoints, rwkv_wkv_cycles)
from repro_torch.core.trainer import make_carls_train_step  # noqa: E402
from repro_torch.data import SyntheticGraphCorpus  # noqa: E402
from repro_torch.env import fused_lookup_block, stage_lookup_ids  # noqa: E402
from repro_torch.launch import serve, train  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.optim import AdamW, constant_lr, warmup_cosine  # noqa: E402
from repro_torch.tree import tree_items, tree_leaves  # noqa: E402
from repro_torch.kernels.nn_search import tile_plan  # noqa: E402
from tools.kernel_ab import (  # noqa: E402
    PROFILE_CAPTURES, STAGE2, WIDE_IVF_ROWS, lookup_bank, lookup_ids,
    lookup_op, ptxas_report, restorer, scan_inputs, spread_ids,
    stage2_inputs, time_ms, wkv_inputs)

N_ROWS, DIM = 1_939_743, 128        # ogbn-mag: all node types, feature width
SHARDS = 3                          # the smallest count that divides N_ROWS
BATCH = 32                          # 8 clients x batch 4, coalesced
K = 8
LAZY_LR, ZMAX = 0.1, 3.0            # the engine's defaults
HBM_BYTES_PER_S = 3.35e12           # H100 SXM, 700 W
FP32_FLOP_PER_S = 67e12
BF16_FLOP_PER_S = 989e12            # dense tensor-core peak
SERVE_ROUNDS = 32
NLIST, NPROBE = 64, 8               # the launcher's IVF defaults
KQ = 32                             # the int8 engine's 4k over-retrieval
# Tolerances: the kernels compute the references' formulas step by step,
# but sum squares and products in another order than PyTorch, so a value
# may move by a few ulps. fp32 leaves and rows of magnitude <= ~10:
ATOL_ROWS = 1e-5
# scores: sums of 128 products reaching ~60 (ulp(64) = 7.6e-6)
ATOL_SCORES = 2e-4
# nn ids must match exactly where the plain k-th and (k+1)-th scores are
# further apart than this
ID_GAP = 1e-4
# int8 scale and offset (tests/test_kb_quantized.py:61-62); a code may
# differ by one only where (v - offset) / scale lies this close to a
# half-integer (the clip's sum of squares runs in another order)
RTOL_Q = 1e-6
HALF_TOL = 1e-4
# flash attention against its plain version: tests/test_kernels.py's
# bounds (a bf16 output may round one ulp the other way)
ATOL_FLASH = {torch.float32: 2e-5, torch.bfloat16: 2e-2}
# WKV against its plain version, y and the final state:
# tests/test_kernels.py's atol plus 1e-5 of the value (y reaches tens at
# the model's ranges; its 64-term sums and the state carried over 2048
# steps run in another order and with fused multiply-adds)
ATOL_WKV, RTOL_WKV = 5e-5, 1e-5
# the Mamba scan against its plain version, y and the final state: the WKV
# bound. Each step's multiply and add are the plain version's in fp32, but
# with fused multiply-adds, the 16-state sum in another order and each exp
# as exp2 by ex2.approx (relative error at most 2^-22); the decay (exp of
# delta A < 1) keeps the state from growing those errors.
ATOL_SCAN, RTOL_SCAN = 5e-5, 1e-5
# exps: H100 SXM special-function units, 16 results a clock per SM (the
# CUDA programming guide's throughput table, compute capability 9.0), at
# the 1.98 GHz boost clock
EXP_PER_S = 132 * 16 * 1.98e9
# the card's least time for the scan's exps, on two pipes: a state-step
# issues 4 FP32 instructions (delta A, delta x B, two FMAs) and its exp,
# either one MUFU.EX2 (one issue slot, and 8 slots' time on the MUFU pipe,
# which takes 16 a clock per SM where 128 lanes issue) or POLY_EXP_INSTR
# instructions on the FMA and integer pipes (a clamp 2, a Cody-Waite
# split 3, a degree-6 polynomial 6, the exponent 2). The least time is at
# the share p of polynomial exps where issue, 5 + 12 p slots, meets the
# MUFU pipe's 8 (1 - p): p = 3/20. The kernel runs every exp on the MUFU.
ISSUE_PER_S = 132 * 128 * 1.98e9
POLY_EXP_INSTR = 13
POLY_SHARE = 3 / (8 + POLY_EXP_INSTR - 1)
# the LM's serve run: batch, prompt and decoded tokens
LM_B, LM_PROMPT, LM_GEN = 4, 2048, 16
# the reduced LM, card against CPU: hidden states (after the final norm, up
# to ~4) and logits move by a few fp32 ulps per layer, the matmul and
# flash sums running in another order
ATOL_LM = 5e-5
# the zoo's reduced models (phase 11), card against CPU: ATOL_LM plus the
# CPU tests' 1e-5 of the value (tests/test_torch_zoo.py: the MoE experts'
# and the front-ends' sums, over a 2048-token prompt, in another order)
RTOL_LM = 1e-5

KERNELS = {
    "kb_fused_lookup": "src/repro/kernels/kb_fused_lookup.py:84",
    "kb_gather": "src/repro/kernels/kb_gather.py:47",
    "lazy_apply": "src/repro/kernels/lazy_apply.py:46",
    "nn_search": "src/repro/kernels/nn_search.py:99",
    "kb_fused_lookup_q": "src/repro/kernels/kb_fused_lookup.py:209",
    "ivf_stage2": "src/repro/kernels/nn_search_ivf.py:186",
    "ivf_stage2_q": "src/repro/kernels/nn_search_ivf.py:281",
    "flash_attention": "src/repro/kernels/flash_attention.py:85",
    "rwkv_wkv": "src/repro/kernels/rwkv_wkv.py:54",
    "ivf_stage2_sharded": "src/repro/kernels/nn_search_ivf.py:381",
    "mamba_scan": "src/repro/kernels/mamba_scan.py:55",
    # the backward kernels: no Pallas kernel has one (JAX differentiates
    # its plain paths)
    "flash_attention_bwd":
        "none; backward of src/repro/kernels/flash_attention.py:85",
    "rwkv_wkv_bwd": "none; backward of src/repro/kernels/rwkv_wkv.py:54",
    "mamba_scan_bwd": "none; backward of src/repro/kernels/mamba_scan.py:55",
    # no Pallas kernel: JAX's optimizer update is jnp that XLA fuses
    "adamw": "none; the optimizer update of "
             "src/repro/optim/optimizer.py:37-73",
}
# the path each kernel's launches are read from (phase 3, 4, 5, 6, 7 or 8)
KERNEL_PATH = {"kb_fused_lookup": "serve_exact",
               "kb_gather": "engine_immediate",
               "lazy_apply": "serve_exact", "nn_search": "serve_exact",
               "kb_fused_lookup_q": "serve_int8_ivf",
               "ivf_stage2": "serve_fp32_ivf",
               "ivf_stage2_q": "serve_int8_ivf",
               "flash_attention": "serve_lm",
               "rwkv_wkv": "serve_rwkv",
               "ivf_stage2_sharded": "serve_sharded_ivf",
               "mamba_scan": "serve_jamba",
               "flash_attention_bwd": "train_yi_2048",
               "rwkv_wkv_bwd": "train_rwkv",
               "mamba_scan_bwd": "train_jamba_layer",
               "adamw": "train"}
# jamba-1.5-large-398b cut to one card: one 8-layer group (the least depth
# the model's groups allow) and 8 of its 16 experts, every width as
# published; 25.79 B parameters, 51.6 GB in bf16 (16 experts: 90.2 GB)
JAMBA = "jamba-1.5-large-398b"
JAMBA_CUT = dict(num_layers=8, num_experts=8)
# the trainer (phase 8): yi-6b at full width cut to 16 of its 32 layers
# (3.29 B parameters: with bf16 grads and fp32 moments 39.5 GB; all 32
# layers would need ~72.7 GB before activations), the JAX launcher's
# batch, seq and --nodes, 10 steps with the maker pass on the last. The
# launcher's --lr 1e-3 suits the reduced model: at d 4096 Adam's first
# steps move a logit by up to ~4096 lr, and at 1e-3 the loss rose from
# 12.06 to 14.07 by step 3 (a chip run of this script); 1e-4 is used.
TRAIN_LAYERS, TRAIN_B, TRAIN_SEQ = 16, 8, 64
TRAIN_NODES, TRAIN_STEPS, TRAIN_LR = 2048, 10, 1e-4
# rwkv6-7b at full width cut to 12 of its 32 layers (3.66 B parameters as
# the trainer builds them, 44.0 GB of parameters, gradients and fp32
# moments at 12 bytes a parameter), at phase 8's batch,
# seq and lr; yi-6b's 16 layers at batch 2 x seq 2048, where attention
# takes the flash kernel forward and backward
TRAIN_RWKV_LAYERS = 12
TRAIN_LONG_B, TRAIN_LONG_SEQ = 2, 2048
# the backward kernels against their plain backwards on the same inputs
# (both fp32 arithmetic): atol 1e-4 plus 1e-4 of the largest entry of that
# gradient. An entry is a sum over up to 2048 keys or 8192 (batch, step)
# pairs taken in another order, with fused multiply-adds, so its rounding
# follows the size of its partial sums, the tensor's scale, and not its
# own value (du of the WKV recurrence: entries near 0 by cancellation). The
# Functions against autograd of the plain forward: the same in fp32; a
# gradient returned in bf16 (the inputs' dtype) is rounded to 8 bits of
# mantissa and follows a bf16 forward output: atol 2e-2 + rtol 2e-2 of the
# entry, the flash forward's bf16 bound
ATOL_BWD = RTOL_BWD = 1e-4
ATOL_BWD_BF16 = RTOL_BWD_BF16 = 2e-2
# one full-width jamba Mamba layer (bf16) forward and backward through the
# kernels against the same through the plain scan, on the card: each
# gradient within 1% of the plain one's norm (bf16 activations and
# parameters: an output that the two scans' last-bit differences round
# the other way moves a gradient entry by a bf16 ulp)
LAYER_REL = 1e-2
# the reduced step, card against CPU: the CPU tests' bounds
# (tests/test_torch_trainer.py): metrics atol 1e-5 + rtol 1e-5; bank
# leaves, moments and gradients atol 1e-6; post-step parameters atol 1e-6
# where the CPU gradient exceeds 10x its bound (1e-5), elsewhere 2 lr
PARITY_LR, ADAM_B1 = 2e-3, 0.9
ATOL_GRAD = 1e-6
SIGN_T = 10 * ATOL_GRAD
# the rwkv6-7b and jamba steps' gradients: ATOL_GRAD plus 1e-5 of the
# value (tests/test_torch_backward.py's bound against jax.vjp: gradients of
# up to tens summed over S steps in another order)
RTOL_GRAD = 1e-5
# the makers' search at the trainer's width: a maker batch of 64 queries
# over the 2048-row bank of width 4096; graph_builder asks k + 1 = 9 (its
# own row excluded), graph_agreement 8 x 4 over-fetched = 32
WIDE_DIM, MAKER_B, MAKER_KS = 4096, 64, (9, 32)
# wide scores: unit-norm rows (the pooled embeddings the trainer and the
# makers write) within ATOL_WIDE plus 8 fp32 ulps of the score; N(0, 1)
# rows within ATOL_WIDE plus 2 LAMBDA_WIDE sqrt(D) 2^-24 sum|q_d r_d|: two
# D-term fp32 sums in different orders, each off by at most
# lambda sqrt(D) u sum|x_d| but with probability below 2 D exp(-lambda^2/2)
# (Higham and Mary's probabilistic bound for rounding errors of random
# sign). The worst case, 2 D u sum|x_d|, is ~5 at D 8192, where a chunk of
# 16 dims dropped moves a score by ~4; this bound is ~0.5 there, and the
# kernel's largest error 0.0244 (a chip run of this script).
ATOL_WIDE, ULPS8, LAMBDA_WIDE = 1e-4, 8 * 2.0 ** -23, 6.0
# the stage-2 entries' query tiles: a multi-tile batch at D 4096, whose
# last tile is partial (the kernels take 32 queries a tile)
WIDE_TILED_B = 80
# phase 9 (a): examples/quickstart.py's run
QS_NODES, QS_SEQ, QS_CLUSTERS, QS_STEPS, QS_B = 1024, 33, 8, 60, 16
QS_MAKERS, QS_MAKER_B, QS_CKPT, QS_LR = 2, 64, 5, 2e-3
# phase 9 (b): the JAX launcher's async mode at phase 8's width and depth
ASYNC_STEPS, ASYNC_CKPT, ASYNC_MAKER_B = 20, 5, 64
# the contended triangle under torch.profiler: steps 3-8 of an 8-step run
ASYNC_PROFILE_STEPS = 8
SERVE_MAKER_PERIOD = 0.05           # serve --kb-maker-period's default


def log(msg: str) -> None:
    print(msg, flush=True)


def require(cond: bool, msg: str) -> None:
    if not cond:
        raise AssertionError(msg)


def bound(nbytes: float, flops: float, flop_per_s: float = FP32_FLOP_PER_S):
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / flop_per_s
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
    # the backward recurrences by instance: their chunk's states stay in
    # registers, so no instance of the main path (the unprofiled ones,
    # "false>" demangled, "Lb0E" not) has a stack frame or spills
    for name, pats in (("rwkv_wkv_bwd", ("wkv_bwd<", "7wkv_bwdI")),
                       ("mamba_scan_bwd", ("scan_bwd<", "8scan_bwdI"))):
        report = {k: v for k, v in ptxas_report(
            _build.compiler_log(name)).items() if any(p in k for p in pats)}
        for fn, (regs, frame, st, ld) in report.items():
            log(f"phase 1: ptxas {name} {fn}: {regs} registers, {frame} "
                f"bytes stack frame, {st} bytes spill stores, {ld} bytes "
                "spill loads")
        main = {k: v for k, v in report.items()
                if "false>" in k or "Lb0E" in k}
        require(bool(main), f"no ptxas report for {name}'s kernels")
        require(all(v[1:] == (0, 0, 0) for v in main.values()),
                f"{name}: an instance keeps a stack frame or spills: {main}")


def check_codes(got, want, before, rows, label) -> int:
    """int8 (codes, scale, offset) of a kernel against its plain version
    after an op that re-quantized the pending ones of ``rows`` from
    ``before`` (codes, scale, offset, grad_sum, grad_cnt, grad_sqnorm):
    scale and offset within RTOL_Q, codes equal but where the plain
    version's (v - offset) / scale lies within HALF_TOL of a half-integer,
    where they may differ by one. Returns that count."""
    (gc, gs, go), (wc, ws, wo) = got, want
    require(torch.allclose(gs, ws, rtol=RTOL_Q, atol=RTOL_Q)
            and torch.allclose(go, wo, rtol=RTOL_Q, atol=RTOL_Q),
            f"{label}: scale or offset disagree")
    c, s, o, gsum, cnt, sq = (t[rows] for t in before)
    v = kbm.dequantize_rows(c, s, o) + kbm.pending_delta(
        gsum, cnt, sq, lazy_lr=LAZY_LR, zmax=ZMAX)
    x = ((v.double() - wo[rows].double()[:, None])
         / ws[rows].double()[:, None])
    near_half = ((x - torch.floor(x)) - 0.5).abs() < HALF_TOL
    diff = (gc[rows].int() - wc[rows].int()).abs()
    bad = (diff > 1) | ((diff == 1) & ~near_half)
    require(not bool(bad.any()), f"{label}: {int(bad.sum())} codes disagree")
    return int((diff == 1).sum())


def check_topk(s_k, i_k, s_p, i_p, k: int, label: str):
    """A top-k against its plain version computed with k + 1: the k ids
    are the same set where the plain k-th and (k+1)-th scores are more
    than ID_GAP apart, and a rank holds the same id where its plain score
    is more than ID_GAP from both neighbours' (nearer scores may swap,
    their sums being rounded in another order). Returns the counts
    checked."""
    s_p = s_p.double()
    gap = s_p[:, :-1] - s_p[:, 1:]                    # (B, k)
    sets = gap[:, k - 1] > ID_GAP
    for b in torch.nonzero(sets).squeeze(1).tolist():
        require(torch.equal(torch.sort(i_k[b]).values,
                            torch.sort(i_p[b, :k]).values),
                f"{label}: top-k set of query {b} differs")
    inf = torch.full_like(gap[:, :1], float("inf"))
    left = torch.cat([inf, gap[:, :k - 1]], 1)
    ranks = (left > ID_GAP) & (gap[:, :k] > ID_GAP)
    bad = ranks & (i_k != i_p[:, :k])
    require(not bool(bad.any()),
            f"{label}: {int(bad.sum())} decided ranks differ, e.g. query "
            f"{torch.nonzero(bad)[:3].tolist()}")
    return int(sets.sum()), int(ranks.sum())


def require_repeatable(name: str, fn, args, s, i) -> None:
    """A second call of ``fn`` on the same inputs returns the same bits
    (the lists' order is total, so the order in which candidates arrive
    cannot show)."""
    s2, i2 = fn(*args)
    require(torch.equal(s2, s) and torch.equal(i2, i),
            f"{name}: a repeated call differs")


def log_stage2_profile(name: str, args, k: int) -> None:
    """One profiled launch of a stage-2 entry (not counted as a launch):
    the plan's items, the partial pass's and the merge's windows, and the
    share of the partial pass's warp cycles in each stage."""
    cyc = ivf_stage2_cycles(name, *args, k=k)
    timed = ("setup", "data", "fma", "score", "filter", "offer", "sync",
             "write")
    total = sum(cyc[x] for x in timed)
    shares = ", ".join(f"{x} {cyc[x] / total:.3f}" for x in timed)
    log(f"phase 2: {name} profile: {cyc['blocks']} items, partial pass "
        f"{cyc['partial_ns']} ns, merge {cyc['merge_ns']} ns; "
        f"{cyc['candidates']} candidates in {cyc['rounds']} rounds; warp "
        f"cycles by stage: {shares}")


def check_padded(name: str, kern, plain, rest, queries, k: int) -> None:
    """A stage-2 entry on the batches the serve sends: the engine pads a
    batch with zero queries up to a power of two of at least 8, here B 8
    with 4 real queries and B 16 with 12. Scores within ATOL_SCORES, the
    real rows' top-k held as phase 2's, the zero rows' lists (every row
    ties at 0) equal to the plain version's bit for bit; each timed.
    ``rest(q)``: the launcher's arguments but k for queries ``q``."""
    for real, B in ((4, 8), (12, 16)):
        q = torch.cat([queries[:real],
                       torch.zeros((B - real, DIM), device=queries.device)])
        args = rest(q)
        s_k, i_k = kern(*args, k)
        s_p, i_p = plain(*args, k + 1)
        s_k, i_k, s_p, i_p = (x.reshape(B, -1, x.shape[-1])
                              for x in (s_k, i_k, s_p, i_p))
        err = max_err(s_k, s_p[..., :k])
        require(err <= ATOL_SCORES, f"{name} B {B}: scores disagree: {err}")
        require(torch.equal(s_k[real:], s_p[real:, :, :k])
                and torch.equal(i_k[real:], i_p[real:, :, :k]),
                f"{name} B {B}: the zero queries' lists differ")
        flat = (x[:real].reshape(-1, x.shape[-1])
                for x in (s_k, i_k, s_p, i_p))
        check_topk(*flat, k, f"{name} B {B}")
        log(f"phase 2: {name} padded batch B {B} ({B - real} zero queries): "
            f"{time_ms(lambda: kern(*args, k), 20)} ms; max_abs_err={err}; "
            f"the zero queries' lists equal the plain version's exactly")


def ivf_bound(bucket_occ, probes, k: int, row_bytes: int, dim: int = DIM):
    """Each bucket that the batch probes read once (its occupied rows at
    ``row_bytes`` each, ids included), the queries, probes and occupancy
    read once, the (B, k) outputs written once; 2 D operations per
    (query, probed row)."""
    occ = bucket_occ.long()
    probed = torch.unique(probes.long())
    B = probes.shape[0]
    nbytes = (int(occ[probed].sum()) * row_bytes + B * dim * 4
              + probes.numel() * 4 + occ.numel() * 4 + B * k * 12)
    flops = 2.0 * int(occ[probes.long()].sum()) * dim
    return bound(nbytes, flops)


def phase2_ivf(table, codes, qscale, qoffset, ids):
    """IVF stage 2 at the serve shapes: indexes of NLIST buckets built by
    the port over the fp32 bank and over the int8 bank's dequantization;
    the 32 rows the lookup returned as queries, probing NPROBE buckets."""
    kernels = ops.LAUNCHERS
    t0 = time.perf_counter()
    index = ann_index.build_ivf_index(table, nlist=NLIST)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    snap = kbm.dequantize_rows(codes, qscale, qoffset)
    index_q = ann_index.QuantizedIVFIndex(ann_index.build_ivf_index(
        snap, nlist=NLIST))
    del snap
    log(f"phase 2: fp32 index built in {build_s:.2f} s: "
        f"{index.bucket_stats()}; int8 index {index_q.bucket_stats()}")
    queries = table[ids]
    results = {}
    for name, idx, args, k, row_bytes, plain in (
            ("ivf_stage2", index, (index.packed_vecs,), K, 4 * DIM + 4,
             ref.ivf_stage2_ref),
            ("ivf_stage2_q", index_q, (index_q.packed_codes,
                                       index_q.packed_scale,
                                       index_q.packed_offset), KQ,
             DIM + 12, ref.ivf_stage2_q_ref)):
        probes = ivf_probes(queries, idx.centroids, NPROBE)
        tail = (idx.packed_ids, idx.bucket_occ, queries, probes)
        s_k, i_k = kernels[name](*args, *tail, k)
        s_p, i_p = plain(*args, *tail, k + 1)
        torch.cuda.synchronize()
        err = max_err(s_k, s_p[:, :k])
        require(err <= ATOL_SCORES, f"{name} scores disagree: {err}")
        n_sets, n_ranks = check_topk(s_k, i_k, s_p, i_p, k, name)
        require_repeatable(name, kernels[name], (*args, *tail, k), s_k, i_k)
        log(f"phase 2: {name} ({BATCH} queries, k = {k}): top-k sets equal "
            f"on the {n_sets} queries whose k-th and (k+1)-th plain scores "
            f"are > {ID_GAP} apart; ids equal on the {n_ranks} ranks whose "
            f"scores are > {ID_GAP} from both neighbours; a repeated call "
            f"bit-identical")
        results[name] = dict(
            max_abs_err=err,
            ms=time_ms(lambda: kernels[name](*args, *tail, k), 20),
            plain_ms=time_ms(lambda: plain(*args, *tail, k), 3),
            library_ms=None,
            bound=ivf_bound(idx.bucket_occ, probes, k, row_bytes))
        # the same call at the other kernel's k: how much of the time is
        # the longer top-k list and how much the row format
        other = KQ if k == K else K
        log(f"phase 2: {name} at k = {other}: "
            f"{time_ms(lambda: kernels[name](*args, *tail, other), 20)} ms")
        log_stage2_profile(name, (*args, *tail), k)
        check_padded(name, kernels[name], plain,
                     lambda q: (*args, idx.packed_ids, idx.bucket_occ, q,
                                ivf_probes(q, idx.centroids, NPROBE)),
                     queries, k)
    del index, index_q
    results.update(phase2_ivf_sharded(table, queries))
    return results


def phase2_ivf_sharded(table, queries):
    """The sharded stage-2 kernel at the serve shapes: a SHARDS-shard
    index of NLIST buckets per shard built by the port over the fp32 bank
    (and its int8 twin, as the sharded int8 engine makes it), the 32
    queries probing NPROBE buckets of each shard."""
    kernels = ops.LAUNCHERS
    t0 = time.perf_counter()
    index = ann_index.build_sharded_ivf_index(table, SHARDS, nlist=NLIST)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    index_q = ann_index.QuantizedShardedIVFIndex(index)
    log(f"phase 2: {SHARDS}-shard index built in {build_s:.3f} s: "
        f"{index.shard_stats()}")
    results = {}
    for name, idx, args, k, row_bytes, plain in (
            ("ivf_stage2_sharded", index, (index.packed_vecs,), K,
             4 * DIM + 4, ref.ivf_stage2_sharded_ref),
            ("ivf_stage2_sharded_q", index_q, (index_q.packed_codes,
                                               index_q.packed_scale,
                                               index_q.packed_offset), KQ,
             DIM + 12, ref.ivf_stage2_sharded_q_ref)):
        probes = sharded_probes(queries, idx.centroids, SHARDS, NPROBE)
        tail = (idx.packed_ids, idx.bucket_occ, queries, probes)
        s_k, i_k = kernels[name](*args, *tail, k)
        s_p, i_p = plain(*args, *tail, k + 1)
        torch.cuda.synchronize()
        require(s_k.shape == (BATCH, SHARDS, k), f"{name}: {s_k.shape}")
        s_k, i_k, s_p, i_p = (x.reshape(BATCH * SHARDS, -1)
                              for x in (s_k, i_k, s_p, i_p))
        err = max_err(s_k, s_p[:, :k])
        require(err <= ATOL_SCORES, f"{name} scores disagree: {err}")
        n_sets, n_ranks = check_topk(s_k, i_k, s_p, i_p, k, name)
        require_repeatable(name, kernels[name], (*args, *tail, k),
                           s_k.reshape(BATCH, SHARDS, k),
                           i_k.reshape(BATCH, SHARDS, k))
        log(f"phase 2: {name} ({BATCH} queries x {SHARDS} shards, k = {k}): "
            f"top-k sets equal on the {n_sets} (query, shard) lists whose "
            f"k-th and (k+1)-th plain scores are > {ID_GAP} apart; ids "
            f"equal on the {n_ranks} ranks whose scores are > {ID_GAP} from "
            f"both neighbours; a repeated call bit-identical")
        # the bound over the globalised probes, B * S lists of k written
        gprobes = global_probes(probes, idx.bucket_occ.shape[0])
        results[name] = dict(
            max_abs_err=err,
            ms=time_ms(lambda: kernels[name](*args, *tail, k), 20),
            plain_ms=time_ms(lambda: plain(*args, *tail, k), 3),
            library_ms=None,
            bound=ivf_bound(idx.bucket_occ, gprobes, k * SHARDS, row_bytes))
        other = KQ if k == K else K
        log(f"phase 2: {name} at k = {other}: "
            f"{time_ms(lambda: kernels[name](*args, *tail, other), 20)} ms")
        log_stage2_profile(name, (*args, *tail), k)
        check_padded(name, kernels[name], plain,
                     lambda q: (*args, idx.packed_ids, idx.bucket_occ, q,
                                sharded_probes(q, idx.centroids, SHARDS,
                                               NPROBE)),
                     queries, k)
    return results


FLASH_SMALL = [  # (B, S, H, KV, d, causal, window, softcap)
    (2, 1000, 8, 2, 128, True, 256, 0.0),
    (2, 512, 8, 2, 64, True, 0, 30.0),
    (1, 300, 4, 1, 32, True, 100, 20.0),
    (2, 200, 4, 4, 128, False, 0, 0.0),
    (2, 333, 32, 4, 128, True, 0, 0.0),      # S no multiple of 128, H/KV 8
    (2, 300, 8, 8, 64, False, 0, 0.0),       # not causal at d 64
    (1, 257, 16, 2, 32, False, 64, 0.0),     # d 32, window, H/KV 8
]
# the zoo's prefill shapes (phase 11), B 4 (label, S, H, KV, d, causal,
# softcap, SDPA computes it): kimi-k2 (head dim 112), grok-1 (its soft cap,
# which no PyTorch call takes), whisper's encoder (1500 frames, not
# causal: its ragged end, 1500 = 11 x 128 + 92), internvl (256 patches and
# 2048 tokens)
FLASH_ZOO = [
    ("kimi-k2-1t-a32b", 2048, 64, 8, 112, True, 0.0, True),
    ("grok-1-314b", 2048, 48, 8, 128, True, 30.0, False),
    ("whisper-tiny encoder", 1500, 6, 6, 64, False, 0.0, True),
    ("internvl2-2b", 2304, 16, 8, 128, True, 0.0, True),
]
# d 112 in both dtypes at small shapes, forward and backward
FLASH_D112_SMALL = [  # (B, S, H, KV, d, causal, window, softcap)
    (2, 333, 8, 2, 112, True, 0, 0.0),       # ragged, H/KV 4
    (1, 300, 4, 1, 112, False, 0, 0.0),      # MQA, not causal
    (1, 512, 4, 2, 112, True, 100, 30.0),    # window and soft cap
]


def flash_bound(q, k, causal: bool, flop_per_s: float):
    """q, k, v read once and o written once; 4 d operations per (query,
    key) pair the mask keeps, per head (no window here)."""
    B, S, H, d = q.shape
    pairs = S * (S + 1) // 2 if causal else S * S
    nbytes = (2 * q.numel() + 2 * k.numel()) * q.element_size()
    return bound(nbytes, 4.0 * B * H * d * pairs, flop_per_s)


def phase2_flash():
    """Flash attention at the LM prefill's shapes in bf16 (the serve
    dtype) and fp32, against its plain version and beside
    ``scaled_dot_product_attention``; then smaller window and soft-cap
    cases."""
    kern = ops.LAUNCHERS["flash_attention"]
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(1)
    cfg = get_config("yi-6b")
    H, KV, d = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim_
    out = {}
    for dtype, peak in ((torch.bfloat16, BF16_FLOP_PER_S),
                        (torch.float32, FP32_FLOP_PER_S)):
        q, k, v = (torch.randn((LM_B, LM_PROMPT, n, d), generator=g,
                               device=dev).to(dtype) for n in (H, KV, KV))
        o_k = kern(q, k, v, causal=True)
        o_p = ref.flash_attention_ref(q, k, v, causal=True)
        torch.cuda.synchronize()
        err = max_err(o_k, o_p)
        require(err <= ATOL_FLASH[dtype],
                f"flash_attention {dtype} disagrees: {err}")
        qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
        out[dtype] = dict(
            max_abs_err=err,
            ms=time_ms(lambda: kern(q, k, v, causal=True), 10),
            plain_ms=time_ms(lambda: ref.flash_attention_ref(
                q, k, v, causal=True), 3),
            library_ms=time_ms(
                lambda: torch.nn.functional.scaled_dot_product_attention(
                    qt, kt, vt, is_causal=True, enable_gqa=True), 10),
            bound=flash_bound(q, k, True, peak))
        log(f"phase 2: flash_attention {dtype} (B {LM_B}, S {LM_PROMPT}, "
            f"H {H}, KV {KV}, d {d}, causal): {out[dtype]}")
        if dtype == torch.bfloat16:
            cycles = flash_stage_cycles(q, k, v, causal=True)
            spent = sum(v_ for s_, v_ in cycles.items()
                        if not s_.startswith("producer"))
            log("phase 2: flash_attention bf16 reaches SDPA's time: "
                f"{out[dtype]['ms'] <= out[dtype]['library_ms']}; consumer "
                "cycles by stage (thread 0 of each warpgroup, summed): "
                + ", ".join(f"{s_} {v_} ({100 * v_ / spent:.1f}%)"
                            for s_, v_ in cycles.items()
                            if not s_.startswith("producer"))
                + f"; producer blocked on free stages "
                f"{cycles['producer_blocked']} of {cycles['producer']}")
        del q, k, v, o_k, o_p
    for dtype in (torch.bfloat16, torch.float32):
        for B, S, H, KV, d, causal, window, softcap in FLASH_SMALL:
            q, k, v = (torch.randn((B, S, n, d), generator=g,
                                   device=dev).to(dtype)
                       for n in (H, KV, KV))
            kw = dict(causal=causal, window=window, softcap=softcap)
            err = max_err(kern(q, k, v, **kw),
                          ref.flash_attention_ref(q, k, v, **kw))
            require(err <= ATOL_FLASH[dtype],
                    f"flash_attention {dtype} {B, S, H, KV, d, kw}: {err}")
            log(f"phase 2: flash_attention {dtype} B {B} S {S} H {H} KV "
                f"{KV} d {d} {kw}: max_abs_err={err}")
    res, f = dict(out[torch.bfloat16]), out[torch.float32]
    res["fp32"] = {"max_abs_err": f["max_abs_err"], "ms": f["ms"],
                   "plain_ms": f["plain_ms"], "library_ms": f["library_ms"],
                   "bound_ms": f["bound"][0], "bound_by": f["bound"][1]}
    res["zoo"] = phase2_flash_zoo(g)
    return res


def phase2_flash_zoo(g) -> dict:
    """Flash attention at the zoo's prefill shapes (FLASH_ZOO, bf16)
    against its plain version, timed beside its bound and, where SDPA
    computes the same function, SDPA; then d 112 at small shapes in bf16
    and fp32 (FLASH_D112_SMALL). Returns {label: its record}."""
    kern = ops.LAUNCHERS["flash_attention"]
    dev = torch.device("cuda")
    zoo = {}
    for label, S, H, KV, d, causal, cap, sdpa in FLASH_ZOO:
        q, k, v = (torch.randn((LM_B, S, n, d), generator=g,
                               device=dev).to(torch.bfloat16)
                   for n in (H, KV, KV))
        kw = dict(causal=causal, softcap=cap)
        err = max_err(kern(q, k, v, **kw), ref.flash_attention_ref(
            q, k, v, **kw))
        require(err <= ATOL_FLASH[torch.bfloat16],
                f"flash_attention bf16 at {label}'s shape disagrees: {err}")
        qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
        zoo[label] = dict(
            shape=[LM_B, S, H, KV, d], causal=causal, softcap=cap,
            max_abs_err=err, ms=time_ms(lambda: kern(q, k, v, **kw), 10),
            plain_ms=time_ms(lambda: ref.flash_attention_ref(q, k, v, **kw),
                             2),
            library_ms=time_ms(
                lambda: torch.nn.functional.scaled_dot_product_attention(
                    qt, kt, vt, is_causal=causal, enable_gqa=True), 10)
            if sdpa else None)
        zoo[label]["bound_ms"], zoo[label]["bound_by"] = flash_bound(
            q, k, causal, BF16_FLOP_PER_S)
        log(f"phase 2: flash_attention bf16 at {label}'s prefill (B {LM_B}, "
            f"S {S}, H {H}, KV {KV}, d {d}, {kw}): {zoo[label]}")
        del q, k, v, qt, kt, vt
    for dtype in (torch.bfloat16, torch.float32):
        for B, S, H, KV, d, causal, window, softcap in FLASH_D112_SMALL:
            q, k, v = (torch.randn((B, S, n, d), generator=g,
                                   device=dev).to(dtype)
                       for n in (H, KV, KV))
            kw = dict(causal=causal, window=window, softcap=softcap)
            err = max_err(kern(q, k, v, **kw),
                          ref.flash_attention_ref(q, k, v, **kw))
            require(err <= ATOL_FLASH[dtype],
                    f"flash_attention {dtype} {B, S, H, KV, d, kw}: {err}")
            log(f"phase 2: flash_attention {dtype} B {B} S {S} H {H} KV "
                f"{KV} d {d} {kw}: max_abs_err={err}")
    q = torch.randn((1, 256, 4, 112), device=dev, requires_grad=True)
    kv = torch.randn((1, 256, 2, 112), device=dev)
    bwd = ops.LAUNCHERS["flash_attention_bwd"]
    before = (kern.launches, bwd.launches)
    out = kern(q, kv, kv)
    out.backward(torch.ones_like(out))
    torch.cuda.synchronize()
    got = (kern.launches - before[0], bwd.launches - before[1])
    require(type(out.grad_fn).__name__ == "FlashAttentionFnBackward"
            and got == (1, 1) and bool(torch.isfinite(q.grad).all()),
            f"flash_attention under autograd at d 112: {got} launches")
    log("phase 2: flash_attention under autograd at d 112 runs "
        "FlashAttentionFn: 1 forward and 1 backward launch")
    return zoo


WKV_SMALL = [  # (B, S, H, d, dtype, decays)
    (2, 200, 4, 16, torch.float32, "model"),     # a ragged last chunk
    (3, 333, 8, 32, torch.bfloat16, "model"),
    (1, 1000, 2, 64, torch.float32, "model"),
    (2, 1, 3, 32, torch.bfloat16, "model"),      # one step
    (2, 2048, 4, 64, torch.bfloat16, "extreme"),
    (1, 333, 3, 32, torch.float32, "extreme"),
    # the backward's edges: S < 16 (one ragged chunk), S = 17 (a chunk and
    # a step), S = 2048 at B H 4, d 16 (a cluster of one block); every d
    # is a multiple of the backward's 16-column slices
    (1, 7, 2, 64, torch.bfloat16, "model"),
    (2, 17, 2, 64, torch.float32, "model"),
    (1, 2048, 4, 64, torch.bfloat16, "extreme"),
    (1, 9, 2, 16, torch.float32, "extreme"),
]


def wkv_err(got, want) -> float:
    """Max abs error of (y, S_fin) against the plain version's; raises
    where an entry is off by more than ATOL_WKV + RTOL_WKV |want|."""
    for a, b, what in zip(got, want, ("y", "S_fin")):
        over = (a - b).abs() - RTOL_WKV * b.abs() > ATOL_WKV
        require(not bool(over.any()),
                f"rwkv_wkv {what} disagrees at {int(over.sum())} entries")
    return max(max_err(a, b) for a, b in zip(got, want))


def phase2_wkv():
    """The WKV kernel against its plain version at the rwkv6-7b prefill's
    shapes (B 4, S 2048, H 64, d 64; r, k, v bf16), then on smaller
    cases."""
    kern = ops.LAUNCHERS["rwkv_wkv"]
    g = torch.Generator(device="cuda").manual_seed(2)
    cfg = get_config("rwkv6-7b")
    H, d = cfg.d_model // cfg.rwkv_head_dim, cfg.rwkv_head_dim
    args = wkv_inputs(LM_B, LM_PROMPT, H, d, torch.bfloat16, g)
    got, want = kern(*args), ref.rwkv_wkv_ref(*args)
    torch.cuda.synchronize()
    err = wkv_err(got, want)
    # r, k, v read once, w and u once, y and S_fin written once; per
    # (b, h, t, i, j) the k v product, S's FMA and y's FMA: 5 flops
    n = args[0].numel()
    nbytes = 3 * n * 2 + n * 4 + args[4].numel() * 4 + n * 4 \
        + LM_B * H * d * d * 4
    res = dict(max_abs_err=err, ms=time_ms(lambda: kern(*args), 20),
               plain_ms=time_ms(lambda: ref.rwkv_wkv_ref(*args), 2),
               library_ms=None,
               bound=bound(nbytes, 5.0 * LM_B * H * LM_PROMPT * d * d))
    log(f"phase 2: rwkv_wkv bf16 (B {LM_B}, S {LM_PROMPT}, H {H}, d {d}): "
        f"{res}; y up to {float(want[0].abs().max())}, S_fin up to "
        f"{float(want[1].abs().max())}")
    log(f"phase 2: rwkv_wkv profile (cycles a warp, over the sequence): "
        f"{rwkv_wkv_cycles(*args)}")
    del args, got, want
    for B, S, H, d, dtype, decays in WKV_SMALL:
        args = wkv_inputs(B, S, H, d, dtype, g, decays)
        got, want = kern(*args), ref.rwkv_wkv_ref(*args)
        torch.cuda.synchronize()
        log(f"phase 2: rwkv_wkv {dtype} B {B} S {S} H {H} d {d} {decays} "
            f"decays: max_abs_err={wkv_err(got, want)}; y up to "
            f"{float(want[0].abs().max())}, S_fin up to "
            f"{float(want[1].abs().max())}")
    return res


SCAN_SMALL = [  # (B, S, di, ds, x dtype, A)
    (2, 1, 256, 16, torch.bfloat16, "init"),      # one step
    (2, 333, 256, 16, torch.float32, "init"),     # S no multiple of the chunk
    (3, 100, 200, 16, torch.bfloat16, "init"),    # di no multiple of the block
    (1, 1000, 512, 8, torch.float32, "init"),
    (2, 333, 256, 16, torch.bfloat16, "trained"),
    (2, 50, 37, 8, torch.float32, "trained"),     # di no multiple of 8
    # the backward's edges: S < 16, S = 17 with a block of 8 channels past
    # 128, S = 2048, ds 4 (a lane a channel) and ds 32 (64 channels a
    # block); every ds is a multiple of the backward's 4 states a lane
    (1, 7, 128, 16, torch.bfloat16, "init"),
    (2, 17, 136, 16, torch.float32, "trained"),
    (1, 2048, 256, 16, torch.bfloat16, "trained"),
    (2, 40, 200, 4, torch.float32, "init"),
    (1, 50, 72, 32, torch.bfloat16, "trained"),
]


def scan_err(got, want) -> float:
    """Max abs error of (y, h_fin) against the plain version's; raises
    where an entry is off by more than ATOL_SCAN + RTOL_SCAN |want|."""
    for a, b, what in zip(got, want, ("y", "h_fin")):
        over = (a - b).abs() - RTOL_SCAN * b.abs() > ATOL_SCAN
        require(not bool(over.any()),
                f"mamba_scan {what} disagrees at {int(over.sum())} entries")
    return max(max_err(a, b) for a, b in zip(got, want))


def phase2_mamba():
    """The Mamba scan kernel against its plain version at the jamba
    prefill's shapes (B 4, S 2048, di 16384, ds 16; x bf16), with the
    model's init A and with a trained model's per-channel A, then on
    smaller and ragged cases."""
    kern = ops.LAUNCHERS["mamba_scan"]
    g = torch.Generator(device="cuda").manual_seed(3)
    cfg = get_config(JAMBA)
    di, ds = cfg.ssm_expand * cfg.d_model, cfg.ssm_state_dim
    args = scan_inputs(LM_B, LM_PROMPT, di, ds, torch.bfloat16, g)
    got, want = kern(*args), ref.mamba_scan_ref(*args)
    torch.cuda.synchronize()
    err = scan_err(got, want)
    # delta, x, B, C and A read once, y and h_fin written once; one exp,
    # a multiply and two FMAs (5 operations) per (b, t, channel, state)
    n, steps = args[0].numel(), LM_B * LM_PROMPT * di * ds
    nbytes = (n * 4 + n * 2 + 2 * args[1].numel() * 4 + args[4].numel() * 4
              + n * 4 + LM_B * di * ds * 4)
    b_ms, b_by = bound(nbytes, 5.0 * steps)
    exp_ms = steps / EXP_PER_S * 1e3               # every exp on the MUFU
    two_pipe_ms = steps * 8 * (1 - POLY_SHARE) / ISSUE_PER_S * 1e3
    res = dict(max_abs_err=err, ms=time_ms(lambda: kern(*args), 20),
               plain_ms=time_ms(lambda: ref.mamba_scan_ref(*args), 2),
               library_ms=None,
               bound=(two_pipe_ms, "operations") if two_pipe_ms > b_ms
               else (b_ms, b_by))
    log(f"phase 2: mamba_scan x bf16 (B {LM_B}, S {LM_PROMPT}, di {di}, "
        f"ds {ds}): {res}; bytes {nbytes}, exps {steps}: MUFU alone "
        f"{exp_ms:.4f} ms, MUFU and FMA pipes balanced ({POLY_SHARE:.2f} "
        f"of the exps on the FMA pipe) {two_pipe_ms:.4f} ms, bytes and "
        f"flops {b_ms:.4f} ms ({b_by}); y up to "
        f"{float(want[0].abs().max())}, h_fin up to "
        f"{float(want[1].abs().max())}")
    log(f"phase 2: mamba_scan profile (cycles a consumer warp or producer "
        f"thread, over the sequence): {mamba_scan_cycles(*args)}")
    del args, got, want
    args = scan_inputs(LM_B, LM_PROMPT, di, ds, torch.bfloat16, g,
                       "trained")
    got, want = kern(*args), ref.mamba_scan_ref(*args)
    torch.cuda.synchronize()
    log(f"phase 2: mamba_scan x bf16 (B {LM_B}, S {LM_PROMPT}, di {di}, "
        f"ds {ds}) trained A: max_abs_err={scan_err(got, want)}, "
        f"{time_ms(lambda: kern(*args), 5)} ms")
    del args, got, want
    for B, S, di, ds, dtype, A_kind in SCAN_SMALL:
        args = scan_inputs(B, S, di, ds, dtype, g, A_kind)
        got, want = kern(*args), ref.mamba_scan_ref(*args)
        torch.cuda.synchronize()
        log(f"phase 2: mamba_scan x {dtype} B {B} S {S} di {di} ds {ds} "
            f"{A_kind} A: max_abs_err={scan_err(got, want)}")
    return res


# -- the backward kernels ----------------------------------------------------

def grad_off(a, b, label: str) -> float:
    """Max abs error of gradient ``a`` against ``b``; raises where an entry
    is off by more than its bound (ATOL_BWD + RTOL_BWD max|b| for an fp32
    gradient, ATOL_BWD_BF16 + RTOL_BWD_BF16 |b| for a bf16 one)."""
    half = torch.bfloat16 in (a.dtype, b.dtype)
    b32 = b.float()
    err = (a.float() - b32).abs()
    if a.numel() == 0:
        return 0.0
    if half:
        tol = ATOL_BWD_BF16 + RTOL_BWD_BF16 * b32.abs()
    else:
        tol = ATOL_BWD + RTOL_BWD * float(b32.abs().max())
    over = err > tol
    require(not bool(over.any()), f"{label}: off at {int(over.sum())} "
            f"entries, max abs err {float(err.max())}, largest entry "
            f"{float(b32.abs().max())}")
    return float(err.max())


def bwd_err(got, want, label: str) -> float:
    """Max abs error of a backward kernel's gradients against the plain
    backward's on the same inputs (fp32 both)."""
    return max(grad_off(a, b, f"{label}: gradient {i} against the plain "
                        "backward") for i, (a, b) in enumerate(zip(got, want)))


def autograd_err(leaves, plain, label: str) -> float:
    """Max abs error of a Function's gradients (``leaves``' .grad) against
    autograd's of the plain forward (``plain``'s); a gradient in bf16 is
    held at the bf16 bound, an fp32 one at the fp32 bound."""
    worst = 0.0
    for i, (a, b) in enumerate(zip(leaves, plain)):
        require(a.grad is not None and a.grad.dtype == a.dtype
                and a.grad.shape == a.shape,
                f"{label}: gradient {i} missing or of the wrong dtype")
        gb = torch.zeros_like(a.grad) if b.grad is None else b.grad
        worst = max(worst, grad_off(a.grad, gb, f"{label}: gradient {i} "
                                    "against autograd of the plain forward"))
    return worst


def fp32_leaves(tensors) -> list:
    """fp32 copies of ``tensors`` that require grad, for autograd of a
    plain forward."""
    return [t.detach().clone().float().requires_grad_() for t in tensors]


def repeat_equal(fn, got, label: str) -> None:
    """Another run of ``fn`` gives ``got`` bit for bit."""
    again = fn()
    require(all(torch.equal(a, b) for a, b in zip(got, again)),
            f"{label}: two runs of the backward kernel differ")


def flash_bwd_case(q, k, v, dout, kw, label: str) -> dict:
    """The flash backward kernel against the plain backward on the
    forward's own output and log-sum-exp (twice, bit-identical), and the
    Function against autograd of the plain forward."""
    kern = ops.LAUNCHERS["flash_attention_bwd"]
    out, lse = flash_attention_with_lse(q, k, v, **kw)
    got = kern(q, k, v, out, lse, dout, **kw)
    repeat_equal(lambda: kern(q, k, v, out, lse, dout, **kw), got, label)
    res = {"max_abs_err": bwd_err(got, ref.flash_attention_bwd_ref(
        q, k, v, out, lse, dout, **kw), label)}
    del got
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    ops.LAUNCHERS["flash_attention"](*leaves, **kw).backward(dout)
    plain = fp32_leaves((q, k, v))
    ref.flash_attention_ref(*plain, **kw).backward(dout.float())
    res["autograd_err"] = autograd_err(leaves, plain, label)
    return res


def flash_bwd_bound(q, k, causal: bool, flop_per_s: float):
    """q, k, v, out, dout and lse read once, dq, dk, dv (fp32) written
    once; 10 d operations per (query, key) pair the mask keeps, per head:
    five products of d (S, dP, dV, dK, dQ), 2.5x the forward's two."""
    B, S, H, d = q.shape
    pairs = S * (S + 1) // 2 if causal else S * S
    e = q.element_size()
    nbytes = (3 * q.numel() + 2 * k.numel()) * e + B * H * S * 4 + \
        (q.numel() + 2 * k.numel()) * 4
    return bound(nbytes, 10.0 * B * H * d * pairs, flop_per_s)


# the device kernels of csrc/flash_attention_bwd.cu (bf16: dkdv_wg,
# sum_planes, dq_wg; fp32: dkdv, dq_kernel; both: dot_rows)
FLASH_BWD_KERNELS = ("dot_rows", "dkdv_wg", "sum_planes", "dq_wg",
                     "dq_kernel", "dkdv")


def bwd_kernel_parts(kern, q, k, v, o, lse, dout, calls: int = 3) -> str:
    """Device ms a call of each kernel the flash backward launches (the D
    pre-pass, dK/dV, the planes' sum, dQ), under torch.profiler."""
    from torch.autograd import DeviceType
    _, prof = profiled(lambda: [kern(q, k, v, o, lse, dout, causal=True)
                                for _ in range(calls)])
    parts = {}
    for e in prof.key_averages():
        if (e.device_type == DeviceType.CUDA and SPIN not in e.key
                and e.self_device_time_total > 0):
            name = next((n for n in FLASH_BWD_KERNELS if n in e.key),
                        "other")
            parts[name] = parts.get(name, 0.0) + \
                e.self_device_time_total / 1e3 / calls
    return "; ".join(f"{n} {t:.4g} ms" for n, t in
                     sorted(parts.items(), key=lambda kv: -kv[1]))


def sdpa_bwd_ms(q, k, v, dout, causal: bool = True) -> float:
    """SDPA's backward alone (GQA), on its own forward's graph: the flash
    backward's library yardstick."""
    qt, kt, vt = (t.transpose(1, 2).detach().requires_grad_()
                  for t in (q, k, v))
    o_s = torch.nn.functional.scaled_dot_product_attention(
        qt, kt, vt, is_causal=causal, enable_gqa=True)
    do_t = dout.transpose(1, 2)
    return time_ms(lambda: torch.autograd.grad(
        o_s, (qt, kt, vt), do_t, retain_graph=True), 5)


def wkv_bwd_bytes(args, ckpt, dy, ds) -> int:
    """The WKV backward's bytes: r, k, v (bf16), w, u, the checkpoints, dy
    and dS_fin read once, the four (B, S, H, d) gradients and du written
    once."""
    n = args[0].numel()
    return (3 * n * args[0].element_size() + n * 4 + args[4].numel() * 4
            + ckpt.numel() * 4 + dy.numel() * 4 + ds.numel() * 4
            + 4 * n * 4 + args[4].numel() * 4)


def wkv_bwd_case(args, dy, ds, label: str) -> dict:
    """The WKV backward kernel against the plain backward on the
    forward's own checkpoints (twice, bit-identical), and the Function
    against autograd of the plain forward, with gradients on y and on the
    final state."""
    kern = ops.LAUNCHERS["rwkv_wkv_bwd"]
    _, _, ckpt = rwkv_wkv_checkpoints(*args)
    got = kern(*args, ckpt, dy, ds)
    repeat_equal(lambda: kern(*args, ckpt, dy, ds), got, label)
    res = {"max_abs_err": bwd_err(got, ref.rwkv_wkv_bwd_ref(*args, dy, ds),
                                  label)}
    del got, ckpt
    leaves = [t.clone().requires_grad_() for t in args]
    y, s_fin = ops.LAUNCHERS["rwkv_wkv"](*leaves)
    ((y * dy).sum() + (s_fin * ds).sum()).backward()
    plain = fp32_leaves(args)
    y, s_fin = ref.rwkv_wkv_ref(*plain)
    ((y * dy).sum() + (s_fin * ds).sum()).backward()
    res["autograd_err"] = autograd_err(leaves, plain, label)
    return res


def scan_bwd_case(args, dy, dh, label: str) -> dict:
    """The scan backward kernel against the plain backward on the
    forward's own checkpoints, di padded as the Function pads it (twice,
    bit-identical), and the Function against autograd of the plain
    forward, with gradients on y and on the final state."""
    kern = ops.LAUNCHERS["mamba_scan_bwd"]
    delta, bm, cm, x, A = args
    pd, px, pA = pad_channels(delta, x, A)
    pad = pd.shape[-1] - delta.shape[-1]
    pdy = torch.nn.functional.pad(dy, (0, pad))
    pdh = torch.nn.functional.pad(dh, (0, 0, 0, pad))
    padded = (pd, bm, cm, px, pA)
    _, _, ckpt = mamba_scan_checkpoints(*padded)
    got = kern(*padded, ckpt, pdy, pdh)
    repeat_equal(lambda: kern(*padded, ckpt, pdy, pdh), got, label)
    res = {"max_abs_err": bwd_err(got, ref.mamba_scan_bwd_ref(
        *padded, pdy, pdh), label)}
    del got, ckpt, padded, pd, px, pA
    leaves = [t.clone().requires_grad_() for t in args]
    y, h_fin = ops.LAUNCHERS["mamba_scan"](*leaves)
    ((y * dy).sum() + (h_fin * dh).sum()).backward()
    plain = fp32_leaves(args)
    y, h_fin = ref.mamba_scan_ref(*plain)
    ((y * dy).sum() + (h_fin * dh).sum()).backward()
    res["autograd_err"] = autograd_err(leaves, plain, label)
    return res


# the flash backward at the zoo's training shapes (phase 12), bf16
# (label, B, S, H, KV, d, causal, softcap, SDPA computes it): kimi-k2's
# heads of 112, grok-1's soft cap (no PyTorch call takes one), whisper's
# encoder over 1500 frames (not causal) at its batch of 8, internvl's 2304
# positions (256 patches and 2048 tokens)
FLASH_BWD_ZOO = [
    ("kimi-k2-1t-a32b", 2, 2048, 64, 8, 112, True, 0.0, True),
    ("grok-1-314b", 2, 2048, 48, 8, 128, True, 30.0, False),
    ("whisper-tiny encoder", 8, 1500, 6, 6, 64, False, 0.0, True),
    ("internvl2-2b", 2, 2304, 16, 8, 128, True, 0.0, True),
]


def phase2_flash_bwd_zoo(g) -> dict:
    """The flash backward at d 112 on FLASH_D112_SMALL's cases in bf16 and
    fp32, then at the zoo's training shapes (FLASH_BWD_ZOO), each against
    the plain backward (twice, bit-identical) and its Function against
    autograd of the plain forward, the latter timed beside the bound (10
    d operations a kept pair) and, where SDPA computes the function,
    SDPA's backward. Returns {label: its record}."""
    kern = ops.LAUNCHERS["flash_attention_bwd"]
    dev = torch.device("cuda")
    for dtype in (torch.bfloat16, torch.float32):
        for B, S, H, KV, d, causal, window, softcap in FLASH_D112_SMALL:
            q, k, v, dout = (torch.randn((B, S, n, d), generator=g,
                                         device=dev).to(dtype)
                             for n in (H, KV, KV, H))
            kw = dict(causal=causal, window=window, softcap=softcap)
            res = flash_bwd_case(q, k, v, dout, kw,
                                 f"flash_attention_bwd {dtype} B {B} S {S} "
                                 f"H {H} KV {KV} d {d} {kw}")
            log(f"phase 2: flash_attention_bwd {dtype} B {B} S {S} H {H} "
                f"KV {KV} d {d} {kw}: {res}")
    zoo = {}
    for label, B, S, H, KV, d, causal, cap, sdpa in FLASH_BWD_ZOO:
        q, k, v, dout = (torch.randn((B, S, n, d), generator=g,
                                     device=dev).to(torch.bfloat16)
                         for n in (H, KV, KV, H))
        kw = dict(causal=causal, softcap=cap)
        res = flash_bwd_case(q, k, v, dout, kw, f"flash_attention_bwd bf16 "
                             f"at {label}'s training shape")
        o, lse = flash_attention_with_lse(q, k, v, **kw)
        res.update(
            shape=[B, S, H, KV, d], causal=causal, softcap=cap,
            ms=time_ms(lambda: kern(q, k, v, o, lse, dout, **kw), 5),
            plain_ms=time_ms(lambda: ref.flash_attention_bwd_ref(
                q, k, v, o, lse, dout, **kw), 1),
            library_ms=sdpa_bwd_ms(q, k, v, dout, causal) if sdpa else None)
        res["bound_ms"], res["bound_by"] = flash_bwd_bound(
            q, k, causal, BF16_FLOP_PER_S)
        log(f"phase 2: flash_attention_bwd bf16 at {label}'s training shape "
            f"(B {B}, S {S}, H {H}, KV {KV}, d {d}, {kw}): {res}")
        zoo[label] = res
        del q, k, v, dout, o, lse
        torch.cuda.empty_cache()
    return zoo


def phase2_backward() -> dict:
    """The three backward kernels at the full-width shapes of phase 2's
    forwards (flash: B 4, S 2048, H 32, KV 4, d 128, causal, bf16 and
    fp32; WKV: B 4, S 2048, H 64, d 64, r/k/v bf16; the scan: B 4, S
    2048, di 16384, ds 16, x bf16), each against its plain backward and
    its Function against autograd of the plain forward, two runs
    bit-identical, timed beside its bound and the plain backward; then
    at FLASH_SMALL's, WKV_SMALL's and SCAN_SMALL's cases."""
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(4)
    out = {}
    # -- flash ---------------------------------------------------------
    cfg = get_config("yi-6b")
    H, KV, d = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim_
    kern = ops.LAUNCHERS["flash_attention_bwd"]
    flash = {}
    for dtype, peak in ((torch.bfloat16, BF16_FLOP_PER_S),
                        (torch.float32, FP32_FLOP_PER_S)):
        q, k, v, dout = (torch.randn((LM_B, LM_PROMPT, n, d), generator=g,
                                     device=dev).to(dtype)
                         for n in (H, KV, KV, H))
        kw = dict(causal=True)
        res = flash_bwd_case(q, k, v, dout, kw, f"flash_attention_bwd "
                             f"{dtype}")
        o, lse = flash_attention_with_lse(q, k, v, **kw)
        res["ms"] = time_ms(lambda: kern(q, k, v, o, lse, dout, **kw), 5)
        res["plain_ms"] = time_ms(lambda: ref.flash_attention_bwd_ref(
            q, k, v, o, lse, dout, **kw), 1)
        res["library_ms"] = sdpa_bwd_ms(q, k, v, dout)
        res["bound"] = flash_bwd_bound(q, k, True, peak)
        log(f"phase 2: flash_attention_bwd {dtype} (B {LM_B}, S "
            f"{LM_PROMPT}, H {H}, KV {KV}, d {d}, causal): {res}")
        log(f"phase 2: flash_attention_bwd {dtype} at B {LM_B}, device "
            f"time by kernel: {bwd_kernel_parts(kern, q, k, v, o, lse, dout)}")
        flash[dtype] = res
        del q, k, v, dout, o, lse
        torch.cuda.empty_cache()
    for dtype in (torch.bfloat16, torch.float32):
        for B, S, H_, KV_, d_, causal, window, softcap in FLASH_SMALL:
            q, k, v, dout = (torch.randn((B, S, n, d_), generator=g,
                                         device=dev).to(dtype)
                             for n in (H_, KV_, KV_, H_))
            kw = dict(causal=causal, window=window, softcap=softcap)
            res = flash_bwd_case(q, k, v, dout, kw,
                                 f"flash_attention_bwd {dtype} B {B} S {S} "
                                 f"H {H_} KV {KV_} d {d_} {kw}")
            log(f"phase 2: flash_attention_bwd {dtype} B {B} S {S} H {H_} "
                f"KV {KV_} d {d_} {kw}: {res}")
    # the shape the yi-6b training run at TRAIN_LONG_B x TRAIN_LONG_SEQ
    # gives the kernel (bf16, causal)
    q, k, v, dout = (torch.randn((TRAIN_LONG_B, TRAIN_LONG_SEQ, n, d),
                                 generator=g, device=dev).to(torch.bfloat16)
                     for n in (H, KV, KV, H))
    kw = dict(causal=True)
    train_res = flash_bwd_case(q, k, v, dout, kw, "flash_attention_bwd bf16 "
                               "at the training shape")
    o, lse = flash_attention_with_lse(q, k, v, **kw)
    train_res["ms"] = time_ms(lambda: kern(q, k, v, o, lse, dout, **kw), 5)
    train_res["library_ms"] = sdpa_bwd_ms(q, k, v, dout)
    train_res["bound"] = flash_bwd_bound(q, k, True, BF16_FLOP_PER_S)
    log(f"phase 2: flash_attention_bwd bf16 at the training shape (B "
        f"{TRAIN_LONG_B}, S {TRAIN_LONG_SEQ}, H {H}, KV {KV}, d {d}, "
        f"causal): {train_res}")
    log(f"phase 2: flash_attention_bwd bf16 at B {TRAIN_LONG_B}, device "
        f"time by kernel: {bwd_kernel_parts(kern, q, k, v, o, lse, dout)}")
    del q, k, v, dout, o, lse
    zoo = phase2_flash_bwd_zoo(g)
    out["flash_attention_bwd"] = dict(flash[torch.bfloat16])
    out["flash_attention_bwd"]["train_shape"] = train_res
    out["flash_attention_bwd"]["zoo"] = zoo
    f = flash[torch.float32]
    out["flash_attention_bwd"]["fp32"] = {
        "max_abs_err": f["max_abs_err"], "ms": f["ms"],
        "plain_ms": f["plain_ms"], "library_ms": f["library_ms"],
        "bound_ms": f["bound"][0], "bound_by": f["bound"][1]}
    # -- WKV -----------------------------------------------------------
    cfg = get_config("rwkv6-7b")
    H, d = cfg.d_model // cfg.rwkv_head_dim, cfg.rwkv_head_dim
    kern = ops.LAUNCHERS["rwkv_wkv_bwd"]
    args = wkv_inputs(LM_B, LM_PROMPT, H, d, torch.bfloat16, g)
    dy = torch.randn((LM_B, LM_PROMPT, H, d), generator=g, device=dev)
    ds = torch.randn((LM_B, H, d, d), generator=g, device=dev)
    res = wkv_bwd_case(args, dy, ds, "rwkv_wkv_bwd bf16")
    _, _, ckpt = rwkv_wkv_checkpoints(*args)
    res["ms"] = time_ms(lambda: kern(*args, ckpt, dy, ds), 10)
    res["plain_ms"] = time_ms(lambda: ref.rwkv_wkv_bwd_ref(*args, dy, ds), 1)
    res["library_ms"] = None
    # per (b, h, t, i, j) the state's recompute (3 flops) and the step
    # back (10)
    res["bound"] = bound(wkv_bwd_bytes(args, ckpt, dy, ds),
                         13.0 * LM_B * H * LM_PROMPT * d * d)
    log(f"phase 2: rwkv_wkv_bwd bf16 (B {LM_B}, S {LM_PROMPT}, H {H}, d "
        f"{d}): {res}")
    log(f"phase 2: rwkv_wkv_bwd profile (cycles a warp, over the sequence): "
        f"{rwkv_wkv_bwd_cycles(*args, ckpt, dy, ds)}")
    out["rwkv_wkv_bwd"] = res
    del args, dy, ds, ckpt
    torch.cuda.empty_cache()
    # the shape the rwkv6-7b training run gives the kernel (r/k/v bf16)
    args = wkv_inputs(TRAIN_B, TRAIN_SEQ, H, d, torch.bfloat16, g)
    dy = torch.randn((TRAIN_B, TRAIN_SEQ, H, d), generator=g, device=dev)
    ds = torch.randn((TRAIN_B, H, d, d), generator=g, device=dev)
    train_res = wkv_bwd_case(args, dy, ds, "rwkv_wkv_bwd bf16 at the "
                             "training shape")
    _, _, ckpt = rwkv_wkv_checkpoints(*args)
    train_res["ms"] = time_ms(lambda: kern(*args, ckpt, dy, ds), 10)
    train_res["bound"] = bound(wkv_bwd_bytes(args, ckpt, dy, ds),
                               13.0 * TRAIN_B * H * TRAIN_SEQ * d * d)
    log(f"phase 2: rwkv_wkv_bwd bf16 at the training shape (B {TRAIN_B}, S "
        f"{TRAIN_SEQ}, H {H}, d {d}): {train_res}")
    log(f"phase 2: rwkv_wkv_bwd profile at the training shape (cycles a "
        f"warp, over the sequence): "
        f"{rwkv_wkv_bwd_cycles(*args, ckpt, dy, ds)}")
    res["train_shape"] = train_res
    del args, dy, ds, ckpt
    for B, S, H_, d_, dtype, decays in WKV_SMALL:
        args = wkv_inputs(B, S, H_, d_, dtype, g, decays)
        dy = torch.randn((B, S, H_, d_), generator=g, device=dev)
        ds = torch.randn((B, H_, d_, d_), generator=g, device=dev)
        res = wkv_bwd_case(args, dy, ds, f"rwkv_wkv_bwd {dtype} B {B} S {S} "
                           f"H {H_} d {d_} {decays}")
        log(f"phase 2: rwkv_wkv_bwd {dtype} B {B} S {S} H {H_} d {d_} "
            f"{decays} decays: {res}")
    # -- the scan --------------------------------------------------------
    cfg = get_config(JAMBA)
    di, dstate = cfg.ssm_expand * cfg.d_model, cfg.ssm_state_dim
    kern = ops.LAUNCHERS["mamba_scan_bwd"]
    args = scan_inputs(LM_B, LM_PROMPT, di, dstate, torch.bfloat16, g)
    dy = torch.randn((LM_B, LM_PROMPT, di), generator=g, device=dev)
    dh = torch.randn((LM_B, di, dstate), generator=g, device=dev)
    res = scan_bwd_case(args, dy, dh, "mamba_scan_bwd x bf16")
    _, _, ckpt = mamba_scan_checkpoints(*args)
    res["ms"] = time_ms(lambda: kern(*args, ckpt, dy, dh), 10)
    res["plain_ms"] = time_ms(lambda: ref.mamba_scan_bwd_ref(*args, dy, dh),
                              1)
    res["library_ms"] = None
    # delta, x (bf16), B, C, A, the checkpoints, dy and dh_fin read once,
    # ddelta, dx, dB, dC and dA written once; per (b, t, channel, state)
    # ~21 flops and one exp, a_t, which the function needs once (the
    # kernel takes 1.75: its two-level recompute), at the forward's rate
    # with the MUFU and FMA pipes balanced
    n, steps = args[0].numel(), LM_B * LM_PROMPT * di * dstate
    nbytes = (n * 4 + n * 2 + 2 * args[1].numel() * 4 + args[4].numel() * 4
              + ckpt.numel() * 4 + n * 4 + dh.numel() * 4 + 2 * n * 4
              + 2 * args[1].numel() * 4 + args[4].numel() * 4)
    b_ms, b_by = bound(nbytes, 21.0 * steps)
    exp_ms = steps * 8 * (1 - POLY_SHARE) / ISSUE_PER_S * 1e3
    res["bound"] = (exp_ms, "operations") if exp_ms > b_ms else (b_ms, b_by)
    log(f"phase 2: mamba_scan_bwd x bf16 (B {LM_B}, S {LM_PROMPT}, di {di},"
        f" ds {dstate}): {res}; bytes {nbytes}, exps {steps}: MUFU and FMA "
        f"pipes balanced {exp_ms:.4f} ms (the kernel's {7 * steps // 4} on "
        f"the MUFU alone {7 * steps / 4 / EXP_PER_S * 1e3:.4f} ms), bytes "
        f"and flops {b_ms:.4f} ms ({b_by})")
    log(f"phase 2: mamba_scan_bwd profile (cycles a consumer warp or "
        f"producer thread, over the sequence): "
        f"{mamba_scan_bwd_cycles(*args, ckpt, dy, dh)}")
    out["mamba_scan_bwd"] = res
    del args, dy, dh, ckpt
    torch.cuda.empty_cache()
    for B, S, di_, ds_, dtype, A_kind in SCAN_SMALL:
        args = scan_inputs(B, S, di_, ds_, dtype, g, A_kind)
        dy = torch.randn((B, S, di_), generator=g, device=dev)
        dh = torch.randn((B, di_, ds_), generator=g, device=dev)
        res = scan_bwd_case(args, dy, dh, f"mamba_scan_bwd x {dtype} B {B} "
                            f"S {S} di {di_} ds {ds_} {A_kind} A")
        log(f"phase 2: mamba_scan_bwd x {dtype} B {B} S {S} di {di_} ds "
            f"{ds_} {A_kind} A: {res}")
    return out


# -- the AdamW kernel ----------------------------------------------------

# AdamW's hyperparameters in phase 8's run (train_carls: AdamW's defaults;
# the schedule's lr at phase 8's lr), at a later count, so that the bias
# corrections are not 1 - b
ADAMW_HYPER = dict(b1=0.9, b2=0.95, eps=1e-8, weight_decay=0.1,
                   clip_norm=1.0)
ADAMW_COUNT = 3
# the global norm against the plain one at full width: two fp32 sums over
# 3.29 B squares, each in its own order (the kernel's in fp64)
RTOL_GN_WIDE = 1e-5


def adamw_specs(cfg):
    """(shape, dtype) of each leaf of ``cfg``'s parameter tree, in the
    tree's order, read from one initialisation on the card."""
    params = build_model(cfg).init(
        torch.Generator(device="cuda").manual_seed(0))
    specs = [(tuple(t.shape), t.dtype) for t in tree_leaves(params)]
    del params
    torch.cuda.empty_cache()
    return specs


def adamw_leaf(spec, i: int, out=None):
    """Leaf i's (g, m, v, p) from its own seed, in ``out`` where given:
    parameters N(0, 0.02^2) and gradients N(0, 1e-3^2) in the leaf's
    dtype, moments fp32 N(0, 1e-4^2) and (N(0, 1e-3^2))^2."""
    shape, dtype = spec
    g = torch.Generator(device="cuda").manual_seed(1000 + i)
    made = []
    for scale, dt, square in ((1e-3, dtype, False),
                              (1e-4, torch.float32, False),
                              (1e-3, torch.float32, True),
                              (0.02, dtype, False)):
        x = torch.randn(shape, generator=g, device="cuda") * scale
        made.append((x * x if square else x).to(dt))
        del x
    if out is None:
        return made
    for a, b in zip(out, made):
        a.copy_(b)
    return out


def adamw_sums(tensors) -> list:
    """Each tensor's bits added as integers: equal sums, (almost surely)
    equal tensors, at no copy of the whole."""
    return [int(t.view(torch.int16 if t.element_size() == 2
                       else torch.int32).sum(dtype=torch.int64))
            for t in tensors]


def phase2_adamw() -> dict:
    """The AdamW kernel at phase 8's leaves (yi-6b cut to TRAIN_LAYERS
    layers: bf16 weights, fp32 norm scales, fp32 moments): the global norm
    within RTOL_GN_WIDE of the plain version's; given the kernel's scale,
    every leaf's parameter and moments bit-identical to the plain
    version's (each leaf made again from its seed); a second run from the
    same inputs bit-identical; one step under torch's sync debug mode
    without a host sync. Timed beside its bytes bound, the plain version
    (the eager passes the kernel replaces) and torch.optim.AdamW(fused=
    True).step() on tensors of the same sizes."""
    cfg = get_config("yi-6b").replace(num_layers=TRAIN_LAYERS)
    specs = adamw_specs(cfg)
    n_entries = sum(math.prod(s) for s, _ in specs)
    dev = torch.device("cuda")
    count = torch.tensor(ADAMW_COUNT, dtype=torch.int32, device=dev)
    bc1 = 1 - ADAMW_HYPER["b1"] ** count
    bc2 = 1 - ADAMW_HYPER["b2"] ** count
    lr = torch.full((), TRAIN_LR, dtype=torch.float32, device=dev)
    upd = {k: v for k, v in ADAMW_HYPER.items() if k != "clip_norm"}
    kern = ops.LAUNCHERS["adamw"]
    leaves = [adamw_leaf(spec, i) for i, spec in enumerate(specs)]
    cols = [list(c) for c in zip(*leaves)]            # g, m, v, p
    gn, scale = kern(*cols, bc1, bc2, lr, **ADAMW_HYPER)
    gn, scale = gn.clone(), scale.clone()
    sums = adamw_sums(t for leaf in leaves for t in leaf[1:])
    # the plain version, leaf by leaf from the same seeds: its norm, and
    # its update with the kernel's scale
    sq = []
    for i, spec in enumerate(specs):
        g_, m_, v_, p_ = adamw_leaf(spec, i)
        sq.append(sum(torch.sum(torch.square(c.float()))
                      for c in g_.reshape(-1).split(1 << 24)))
        ref.adamw_update_ref(g_, m_, v_, p_, scale, bc1, bc2, lr,
                             chunk=1 << 24, **upd)
        for name, a, b in (("m", leaves[i][1], m_), ("v", leaves[i][2], v_),
                           ("p", leaves[i][3], p_)):
            require(torch.equal(a, b), f"adamw: leaf {i} {spec}'s {name} "
                    "differs from the plain version's")
        del g_, m_, v_, p_
    gn_plain = torch.sqrt(sum(sq))
    rel = abs(float(gn) - float(gn_plain)) / float(gn_plain)
    require(rel <= RTOL_GN_WIDE, f"adamw: gn {float(gn)} against the plain "
            f"{float(gn_plain)}: relative gap {rel}")
    plain_scale = torch.clamp(ADAMW_HYPER["clip_norm"] / torch.clamp(
        gn, min=1e-12), max=1.0)
    require(torch.equal(scale, plain_scale), "adamw: the kernel's scale is "
            "not torch's of its gn")
    # again from the same inputs, under the sync debug mode
    for i, spec in enumerate(specs):
        adamw_leaf(spec, i, leaves[i])
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        gn2, scale2 = kern(*cols, bc1, bc2, lr, **ADAMW_HYPER)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    require(torch.equal(gn2, gn) and torch.equal(scale2, scale) and
            adamw_sums(t for leaf in leaves for t in leaf[1:]) == sums,
            "adamw: two runs from the same inputs differ")
    res = {"max_abs_err": 0.0, "gn": float(gn), "gn_plain": float(gn_plain),
           "gn_rel_err": rel, "leaves": len(specs), "entries": n_entries}
    res["ms"] = time_ms(lambda: kern(*cols, bc1, bc2, lr, **ADAMW_HYPER), 5)
    res["plain_ms"] = time_ms(lambda: ref.adamw_ref(
        *cols, bc1, bc2, lr, chunk=1 << 24, **ADAMW_HYPER), 1)
    # g read twice (the norm, the update), p, m and v read and written
    nbytes = sum(2 * t.numel() * t.element_size() + 2 * sum(
        x.numel() * x.element_size() for x in (m_, v_, p_))
        for t, m_, v_, p_ in leaves)
    # per entry ~17 fp32 operations (the square, five multiplies, four
    # adds, two divisions, a square root...), far below the bytes
    res["bound"] = bound(nbytes, 17.0 * n_entries)
    del leaves, cols
    torch.cuda.empty_cache()
    # the library's fused AdamW: moments in the parameters' dtypes, bias
    # correction on the step, no global-norm clip: a yardstick, not the
    # same function
    params = [torch.zeros(s, dtype=dt, device=dev) for s, dt in specs]
    for p_ in params:
        p_.grad = torch.full_like(p_, 1e-3)
    opt = torch.optim.AdamW(params, lr=TRAIN_LR, betas=(0.9, 0.95),
                            eps=1e-8, weight_decay=0.1, fused=True)
    opt.step()                                   # makes its state
    res["library_ms"] = time_ms(opt.step, 5)
    res["library"] = ("torch.optim.AdamW(fused=True).step(), parameters, "
                      "gradients and moments in the leaves' dtypes (bf16 "
                      "weights, fp32 norm scales), no clip")
    del opt, params
    torch.cuda.empty_cache()
    log(f"phase 2: adamw at phase 8's leaves ({len(specs)} leaves, "
        f"{n_entries} entries; bf16 weights and gradients, fp32 norm "
        f"scales, fp32 moments; count {ADAMW_COUNT}, clip "
        f"{ADAMW_HYPER['clip_norm']}): gn {res['gn']} (plain "
        f"{res['gn_plain']}, relative gap {rel}); p, m and v bit-identical "
        f"to the plain version's given the kernel's scale, a second run "
        f"bit-identical, no host sync; {res['ms']} ms, plain "
        f"{res['plain_ms']} ms, fused torch AdamW {res['library_ms']} ms, "
        f"bound {res['bound'][0]} ms ({res['bound'][1]}, {nbytes} bytes)")
    return res


def phase2_nn_cases(table, queries):
    """nn_search beyond the serve shape: k = 128 over the whole bank, a
    bank of 100,003 rows (no multiple of any tile), and a bank of 4,096
    rows planted three times over, where a row and its copies score alike
    bit for bit and must come out lowest id first (a zero query ties every
    row and gets ids 0..k-1)."""
    kern = ops.LAUNCHERS["nn_search"]
    for label, bank, k in (("k = 128", table, 128),
                           ("N = 100,003", table[:100_003], K)):
        s_k, i_k = kern(queries, bank, k)
        s_p, i_p = ref.nn_search_ref(queries, bank, k + 1)
        err = max_err(s_k, s_p[:, :k])
        require(err <= ATOL_SCORES, f"nn_search {label}: scores {err}")
        sets, ranks = check_topk(s_k, i_k, s_p, i_p, k, f"nn_search {label}")
        log(f"phase 2: nn_search {label}: max_abs_err={err}, sets equal on "
            f"{sets} of {BATCH} queries, {ranks} decided ranks equal")
    base = table[:4096]
    bank = torch.cat([base, base, base])
    q = torch.cat([queries[:3], torch.zeros_like(queries[:1])])
    s_k, i_k = kern(q, bank, 9)
    s_p, _ = ref.nn_search_ref(q, bank, 9)
    err = max_err(s_k, s_p)
    same = s_k[:, 1:] == s_k[:, :-1]
    trio = i_k[:3].view(3, 3, 3) % 4096
    require(err <= ATOL_SCORES
            and torch.equal(i_k[3], torch.arange(9, device=bank.device))
            and bool((i_k[:, 1:] > i_k[:, :-1])[same].all())
            and torch.equal(trio, trio[:, :, :1].expand(3, 3, 3)),
            f"nn_search planted ties: err {err}, ids {i_k.tolist()}")
    log(f"phase 2: nn_search planted ties (3 x 4096 rows, k = 9): "
        f"max_abs_err={err}, equal scores lowest id first")


def wide_tol(q, bank, ids, scores, unit: bool):
    """Per-score tolerance at a wide D (ATOL_WIDE's comment)."""
    if unit:
        return ATOL_WIDE + ULPS8 * scores.double().abs()
    mag = torch.einsum("bd,bkd->bk", q.abs().double(),
                       bank[ids.clamp(min=0)].abs().double())
    return ATOL_WIDE + 2 * LAMBDA_WIDE * q.shape[1] ** 0.5 * 2.0 ** -24 * mag


def check_wide(label, s_k, i_k, s_p, i_p, k, tol):
    """Scores within ``tol`` (per plain score, k + 1 of them); ids equal
    at each rank whose plain score is more than twice the bound from both
    neighbours'. Returns (max error, ranks checked)."""
    err = max_err(s_k, s_p[:, :k])
    bad = (s_k.double() - s_p[:, :k].double()).abs() > tol[:, :k]
    require(not bool(bad.any()), f"{label}: {int(bad.sum())} scores past "
            f"the bound (max error {err})")
    w = s_p.double()
    gap = w[:, :-1] - w[:, 1:] - 2 * torch.maximum(tol[:, :-1], tol[:, 1:])
    left = torch.cat([torch.full_like(gap[:, :1], float("inf")),
                      gap[:, :k - 1]], 1)
    ranks = (left > 0) & (gap[:, :k] > 0)
    require(int(ranks.sum()) > 0, f"{label}: no rank is decided")
    bad = ranks & (i_k != i_p[:, :k])
    require(not bool(bad.any()), f"{label}: {int(bad.sum())} decided "
            "ranks differ")
    return err, int(ranks.sum())


def rand_rows(n: int, dim: int, g, unit: bool):
    x = torch.randn((n, dim), generator=g, device=g.device)
    return x / x.norm(dim=1, keepdim=True) if unit else x


def phase2_wide():
    """nn_search and the four stage-2 entries at the trainer's width and
    beyond (the module docstring's phase 2). Returns ({"k9": ..., "k32":
    ...} of the makers' search, {entry: its D 4096 result})."""
    kern = ops.LAUNCHERS["nn_search"]
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(5)
    maker = {}
    for dim, n, ks, unit in ((WIDE_DIM, TRAIN_NODES, MAKER_KS, True),
                             (8192, 3000, (9, 32), False),
                             (1544, 5000, (9, 32, 128), False)):
        bank = rand_rows(n, dim, g, unit)
        q = bank[torch.randint(0, n, (MAKER_B,), generator=g, device=dev)] \
            + 0.01 * rand_rows(MAKER_B, dim, g, unit)
        for k in ks:
            s_k, i_k = kern(q, bank, k)
            s_p, i_p = ref.nn_search_ref(q, bank, k + 1)
            label = f"nn_search {MAKER_B} x {n} x {dim} k {k}"
            err, ranks = check_wide(label, s_k, i_k, s_p, i_p, k,
                                    wide_tol(q, bank, i_p, s_p, unit))
            require_repeatable(label, kern, (q, bank, k), s_k, i_k)
            ms = time_ms(lambda: kern(q, bank, k), 20)
            r = dict(max_abs_err=err, ms=ms, library_ms=None,
                     bound=bound((n + MAKER_B) * dim * 4 + MAKER_B * k * 12,
                                 2.0 * MAKER_B * n * dim))
            log(f"phase 2: {label} ({'unit-norm' if unit else 'N(0, 1)'} "
                f"rows; plan {tile_plan(k, n)}): max_abs_err={err}, "
                f"{ranks} decided ranks equal, a repeat bit-identical; "
                f"{ms} ms, bound {r['bound'][0]} ms ({r['bound'][1]})")
            if dim == WIDE_DIM:
                r["plain_ms"] = time_ms(
                    lambda: ref.nn_search_ref(q, bank, k), 20)
                maker[f"k{k}"] = r
        del bank, q
    wbank = rand_rows(WIDE_IVF_ROWS, WIDE_DIM, g, True)
    wq = wbank[torch.randint(0, WIDE_IVF_ROWS, (BATCH,), generator=g,
                             device=dev)] + 0.01 * rand_rows(BATCH, WIDE_DIM,
                                                             g, True)
    tq = wbank[torch.randint(0, WIDE_IVF_ROWS, (WIDE_TILED_B,), generator=g,
                             device=dev)] + 0.01 * rand_rows(
                                 WIDE_TILED_B, WIDE_DIM, g, True)
    stage2 = {}
    for name, (sharded, int8, k, _) in STAGE2.items():
        args, plain, rest = stage2_inputs(name, wbank, wq)
        s_k, i_k = ops.LAUNCHERS[name](*args, k)
        s_p, i_p = plain(*args, k + 1)
        require_repeatable(f"{name} D {WIDE_DIM}", ops.LAUNCHERS[name],
                           (*args, k), s_k, i_k)
        flat = [x.reshape(-1, x.shape[-1]) for x in (s_k, i_k, s_p, i_p)]
        err, ranks = check_wide(f"{name} D {WIDE_DIM}", *flat, k,
                                wide_tol(None, None, None, flat[2], True))
        occ, probes = args[-3], args[-1]
        if sharded:
            probes = global_probes(probes, occ.shape[0])
        row_bytes = WIDE_DIM + 12 if int8 else 4 * WIDE_DIM + 4
        r = dict(max_abs_err=err,
                 ms=time_ms(lambda: ops.LAUNCHERS[name](*args, k), 20),
                 plain_ms=time_ms(lambda: plain(*args, k), 3),
                 library_ms=None,
                 bound=ivf_bound(occ, probes, k * (SHARDS if sharded else 1),
                                 row_bytes, WIDE_DIM))
        stage2[name] = r
        log(f"phase 2: {name} D {WIDE_DIM} ({WIDE_IVF_ROWS} unit-norm rows, "
            f"{BATCH} queries, k = {k}): max_abs_err={err}, {ranks} decided "
            f"ranks equal, a repeat bit-identical; {r['ms']} ms, plain "
            f"{r['plain_ms']} ms, bound {r['bound'][0]} ms ({r['bound'][1]})")
        targs = rest(tq)
        label = f"{name} D {WIDE_DIM} {WIDE_TILED_B} queries"
        s_k, i_k = ops.LAUNCHERS[name](*targs, k)
        s_p, i_p = plain(*targs, k + 1)
        require_repeatable(label, ops.LAUNCHERS[name], (*targs, k), s_k, i_k)
        flat = [x.reshape(-1, x.shape[-1]) for x in (s_k, i_k, s_p, i_p)]
        err, ranks = check_wide(label, *flat, k,
                                wide_tol(None, None, None, flat[2], True))
        log(f"phase 2: {label} (query tiles 0-{(WIDE_TILED_B - 1) // 32}, "
            f"the last partial): max_abs_err={err}, {ranks} decided ranks "
            f"equal, a repeat bit-identical; "
            f"{time_ms(lambda: ops.LAUNCHERS[name](*targs, k), 20)} ms")
        del args, targs
    del wbank, wq, tq
    torch.cuda.empty_cache()
    return maker, stage2


def owners_agree(vals, ids) -> bool:
    """Every occurrence of an id reads, bit for bit, the row of its first
    occurrence."""
    _, inverse = torch.unique(ids, return_inverse=True)
    pos = torch.arange(ids.numel(), device=ids.device)
    first = torch.full_like(pos, ids.numel()).scatter_reduce(
        0, inverse, pos, "amin")
    return torch.equal(vals, vals[first[inverse]])


def check_lookup(name, int8, src, ids, label):
    """One fused lookup with the version bump against its plain version,
    from copies of ``src`` and a zero version: rows and fp32 leaves within
    ATOL_ROWS, versions exact, int8 codes as check_codes holds them, each
    duplicate reading its owner's row bit for bit, untouched rows and
    versions unchanged. Returns (error, codes rounded the other way, the
    kernel's vals, its touched leaves' rows and its version)."""
    kernels = ops.LAUNCHERS
    plain = getattr(ref, f"{name}_ref")
    uniq = torch.unique(ids[ids >= 0])
    zero = torch.zeros(src[0].shape[0], dtype=torch.int32,
                       device=ids.device)
    leaves_k, leaves_p = ([t.clone() for t in src] for _ in range(2))
    ver_k, ver_p = zero.clone(), zero.clone()
    vals_k = kernels[name](*leaves_k, ids, lazy_lr=LAZY_LR, zmax=ZMAX,
                           version=ver_k)
    vals_p = plain(*leaves_p, ids, lazy_lr=LAZY_LR, zmax=ZMAX,
                   version=ver_p)
    torch.cuda.synchronize()
    first = 3 if int8 else 0
    err = max([max_err(vals_k, vals_p)]
              + [max_err(a[uniq], b[uniq])
                 for a, b in zip(leaves_k[first:], leaves_p[first:])])
    require(err <= ATOL_ROWS, f"{name} {label} disagrees: {err}")
    require(torch.equal(ver_k, ver_p), f"{name} {label}: versions differ")
    require(owners_agree(vals_k, ids),
            f"{name} {label}: a duplicate read another row than its owner")
    n_half = check_codes(leaves_k[:3], leaves_p[:3], src, uniq,
                         f"{name} {label}") if int8 else 0
    rows = [a[uniq].clone() for a in leaves_k + [ver_k]]
    for a, b in zip(leaves_k + [ver_k], list(src) + [zero]):
        a[uniq] = b[uniq]               # untouched rows stay as they were
        require(torch.equal(a, b), f"{name} {label} wrote an untouched row")
    return err, n_half, vals_k, rows[:-1], rows[-1]


def phase2_lookup(name, int8, src, ids, pending):
    """A fused lookup at the serve batch and at a batch of 1024 spread
    over 128 blocks, each against its plain version and repeated
    (bit-identical); its time at both batches and its plain version's;
    then the whole CudaBackend op on the same bank: one launch, no host
    sync (torch's sync debug mode raises on one), its kernels under
    torch.profiler and its time."""
    kernels = ops.LAUNCHERS
    plain = getattr(ref, f"{name}_ref")
    wide = spread_ids(N_ROWS, ids.device)
    wide[-1] = -1                       # the Pallas padding id
    out = {}
    for label, batch in (("B 32", ids), ("B 1024", wide)):
        err, n_half, vals, rows, ver = check_lookup(name, int8, src, batch,
                                                    label)
        again = check_lookup(name, int8, src, batch, label)
        require(torch.equal(again[2], vals)
                and all(torch.equal(a, b) for a, b in zip(again[3], rows))
                and torch.equal(again[4], ver),
                f"{name} {label}: a repeated run is not bit-identical")
        n_pend = int(pending[torch.unique(batch[batch >= 0])].sum())
        log(f"phase 2: {name} {label} ({torch.unique(batch).numel()} "
            f"distinct, {n_pend} pending): max_abs_err={err}, versions "
            f"exact ({int(ver.sum())} bumped), repeated run bit-identical"
            + (f", {n_half} codes rounded the other way at a half-integer"
               if int8 else ""))
        out["max_abs_err"] = max(out.get("max_abs_err", 0.0), err)
    ver = torch.zeros(N_ROWS, dtype=torch.int32, device=ids.device)
    leaves_k, leaves_p = ([t.clone() for t in src] for _ in range(2))
    out["ms"] = time_ms(lambda: kernels[name](
        *leaves_k, ids, lazy_lr=LAZY_LR, zmax=ZMAX, version=ver), 50,
        restorer(leaves_k, src, ids))
    out["plain_ms"] = time_ms(lambda: plain(
        *leaves_p, ids, lazy_lr=LAZY_LR, zmax=ZMAX, version=ver), 50,
        restorer(leaves_p, src, ids))
    out["library_ms"] = None
    ms_wide = time_ms(lambda: kernels[name](
        *leaves_k, wide, lazy_lr=LAZY_LR, zmax=ZMAX, version=ver), 50,
        restorer(leaves_k, src, wide))
    log(f"phase 2: {name} B 1024: {ms_wide} ms")
    del leaves_p

    # the whole op, as the engine queues it
    restorer(leaves_k, src, ids)()
    n = N_ROWS
    state = kbm.KBState(leaves_k[0], torch.zeros(n, dtype=torch.int32,
                                                 device=ids.device),
                        *leaves_k[-3:],
                        norm_ema=torch.zeros(n, device=ids.device),
                        step=torch.zeros((), dtype=torch.int32,
                                         device=ids.device))
    bk = CudaBackend()
    torch.cuda.synchronize()
    before = ops.launch_counts()
    torch.cuda.set_sync_debug_mode("error")
    try:
        if int8:
            vals, _ = bk.lookup_q(state, leaves_k[1], leaves_k[2], ids,
                                  lazy_lr=LAZY_LR, zmax=ZMAX)
        else:
            vals, _ = bk.lookup(state, ids, lazy_lr=LAZY_LR, zmax=ZMAX)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    require(ops.launch_counts() == {**before, name: before[name] + 1},
            f"the {name} op launched other than one {name}")
    want = check_lookup(name, int8, src, ids, "op")[2]
    require(torch.equal(vals, want),
            f"the {name} op differs from its kernel's call")
    restorer(leaves_k, src, ids)()
    op = lookup_op(int8, leaves_k, ids)
    require(op["kernels"] == 1 and op["host_syncs"] == 0,
            f"the {name} op queued {op['kernels']} kernels and made "
            f"{op['host_syncs']} host syncs")
    log(f"phase 2: CudaBackend.{'lookup_q' if int8 else 'lookup'} op (B "
        f"32, ids on the card): {op['ms']} ms by events, "
        f"{op['kernels']} device kernel(s) {op['kernel_names']} (profile "
        f"capture {op['captures']}), {op['host_syncs']} host syncs, "
        f"{op['host_us']} us of host time a call")
    out.update(op_ms=op["ms"], op_kernels=op["kernels"], ms_b1024=ms_wide)
    return out


def lookup_bytes(ids, pending, dim: int, int8: bool) -> int:
    """The bytes a fused lookup of ``ids`` must move on this run's data,
    each input read once and each output written once: the ids; every
    distinct row's stored row (fp32, or codes, scale and offset) and
    grad_cnt; for each row with pending gradients its grad_sum row and
    grad_sqnorm read, its stored row, zeroed grad_sum row and counters
    written, and its version read and written (the other rows' caches are
    zero already); B output rows."""
    uniq = torch.unique(ids[ids >= 0])
    n_p = int(pending[uniq].sum())
    d4 = dim * 4
    row_bytes = dim + 8 if int8 else d4
    return (ids.numel() * 8 + uniq.numel() * (row_bytes + 4)
            + n_p * (d4 + 4 + row_bytes + d4 + 8 + 8) + ids.numel() * d4)


def trainer_ids() -> np.ndarray:
    """The 64 neighbour ids of ``train_carls``'s first batch at phase 8's
    configuration: ``SyntheticGraphCorpus(num_nodes=2048, seed=0)``, batch
    8 drawn from ``default_rng(seed + 1)``, 8 neighbours a sample."""
    cfg = get_config("yi-6b")
    corpus = SyntheticGraphCorpus(
        num_nodes=TRAIN_NODES, vocab_size=cfg.vocab_size,
        seq_len=TRAIN_SEQ + 1, neighbors_per_node=cfg.carls.num_neighbors)
    return corpus.batch(np.random.default_rng(1),
                        TRAIN_B)["neighbor_ids"].reshape(-1)


def phase2_trainer_lookup(floor_ms: float) -> dict:
    """``kb_fused_lookup`` at the trainer's shape: a 2048 x 4096 fp32 bank
    (``lookup_bank``'s distribution, a fifth of its rows pending) and the
    64 ids of the trainer's first batch, duplicates included; rows against
    the plain version, versions exact, a repeat bit-identical; its time
    and its plain version's by events, beside the bytes bound and the
    launch floor."""
    name = "kb_fused_lookup"
    dim = get_config("yi-6b").d_model
    g = torch.Generator(device="cuda").manual_seed(3)
    *src, pending = lookup_bank(g, TRAIN_NODES, dim)
    ids = torch.from_numpy(trainer_ids()).long().cuda()
    rows = fused_lookup_block(ids.numel(), dim)
    staged = stage_lookup_ids(ids.numel(), dim, rows)
    err, _, vals, kept, ver = check_lookup(name, False, src, ids,
                                           "trainer")
    again = check_lookup(name, False, src, ids, "trainer")
    require(torch.equal(again[2], vals)
            and all(torch.equal(a, b) for a, b in zip(again[3], kept))
            and torch.equal(again[4], ver),
            f"{name} trainer: a repeated run is not bit-identical")
    leaves_k, leaves_p = ([t.clone() for t in src] for _ in range(2))
    zero = torch.zeros(TRAIN_NODES, dtype=torch.int32, device="cuda")
    out = dict(
        max_abs_err=err,
        ms=time_ms(lambda: ops.LAUNCHERS[name](
            *leaves_k, ids, lazy_lr=LAZY_LR, zmax=ZMAX, version=zero), 50,
            restorer(leaves_k, src, ids)),
        plain_ms=time_ms(lambda: ref.kb_fused_lookup_ref(
            *leaves_p, ids, lazy_lr=LAZY_LR, zmax=ZMAX, version=zero), 50,
            restorer(leaves_p, src, ids)),
        bound=bound(lookup_bytes(ids, pending, dim, False), 0.0),
        launch_floor_ms=floor_ms)
    n_uniq = torch.unique(ids).numel()
    n_pend = int(pending[torch.unique(ids)].sum())
    log(f"phase 2: {name} trainer shape ({TRAIN_NODES} x {dim} fp32, "
        f"{ids.numel()} ids, {n_uniq} distinct, {n_pend} pending; {rows} "
        f"warps a block, ids staged in shared memory: {staged}): "
        f"max_abs_err={err} (exact: {err == 0.0}), versions exact "
        f"({int(ver.sum())} bumped), repeated run bit-identical; "
        f"{out['ms']} ms by events, plain {out['plain_ms']} ms, bound "
        f"{out['bound'][0]} ms ({out['bound'][1]}), launch floor "
        f"{floor_ms} ms")
    return out


def phase2_kernels():
    """Each kernel against its plain version at the serve path's shapes."""
    kernels = ops.LAUNCHERS
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)
    table, grad_sum, grad_cnt, grad_sqnorm, pending = lookup_bank(g)
    base = (table, grad_sum, grad_cnt, grad_sqnorm)
    n_pending = int(pending.sum())
    log(f"phase 2: {n_pending} of {N_ROWS} rows hold pending gradients")

    ids = lookup_ids(g, pending, BATCH)
    uniq = torch.unique(ids)
    n_uniq = uniq.numel()
    queries = torch.randn((BATCH, DIM), generator=g, device=dev)
    results = {}
    floor_ms = time_ms(lambda: torch.cuda._sleep(0), 200)
    log(f"phase 2: launch floor (torch.cuda._sleep(0), one thread that "
        f"returns at once, by the same events): {floor_ms} ms")

    # -- the fused lookups: in place on the touched rows, with version ----
    codes, qscale, qoffset = kbm.quantize_rows(table)
    base_q = (codes, qscale, qoffset, grad_sum, grad_cnt, grad_sqnorm)
    D4 = DIM * 4
    for name, int8, src in (("kb_fused_lookup", False, base),
                            ("kb_fused_lookup_q", True, base_q)):
        results[name] = phase2_lookup(name, int8, src, ids, pending)
        results[name]["launch_floor_ms"] = floor_ms
        results[name]["bound"] = bound(
            lookup_bytes(ids, pending, DIM, int8), 0.0)
    results["kb_fused_lookup"]["trainer"] = phase2_trainer_lookup(floor_ms)

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
        bound=bound(nbytes, 0.0),
        # its bytes bound is ~1/600 of an empty launch: the floor is the
        # bound that a launch can reach
        launch_floor_ms=floor_ms)

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
    del leaves_k, leaves_p, base, base_q, grad_sum

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
    s_2, i_2 = kernels["nn_search"](queries, table, K)
    require(torch.equal(s_2, s_k) and torch.equal(i_2, i_k),
            "nn_search: a repeated run is not bit-identical")
    # not the same function (no top-k), so not its library_ms: cuBLAS's
    # fp32 product of the scores alone, the FMA work's yardstick
    log(f"phase 2: nn_search's scores alone by torch.matmul (fp32, "
        f"{BATCH} x {N_ROWS} x {DIM}): "
        f"{time_ms(lambda: torch.matmul(queries, table.T), 20)} ms")
    phase2_nn_cases(table, queries)
    nbytes = (N_ROWS + BATCH) * D4 + BATCH * K * 12
    results["nn_search"] = dict(
        max_abs_err=err,
        ms=time_ms(lambda: kernels["nn_search"](queries, table, K),
                   20),
        plain_ms=time_ms(lambda: ref.nn_search_ref(queries, table, K),
                         5),
        library_ms=None,
        bound=bound(nbytes, 2.0 * BATCH * N_ROWS * DIM))

    results.update(phase2_ivf(table, codes, qscale, qoffset, ids))
    del codes, qscale, qoffset, table
    torch.cuda.empty_cache()
    results["nn_search"]["maker"], wide = phase2_wide()
    for name, r in wide.items():
        results[name]["wide"] = r
    results["flash_attention"] = phase2_flash()
    results["rwkv_wkv"] = phase2_wkv()
    results["mamba_scan"] = phase2_mamba()
    results.update(phase2_backward())
    results["adamw"] = phase2_adamw()

    for name, r in results.items():
        b_ms, b_by = r["bound"]
        log(f"phase 2: {name} ok: max_abs_err={r['max_abs_err']} "
            f"ms={r['ms']} plain_ms={r['plain_ms']} "
            f"library_ms={r['library_ms']} bound_ms={b_ms} ({b_by})")
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


def _sync(dst: KBEngine, src: KBEngine) -> None:
    """Give ``dst`` copies of ``src``'s state, side-cars and masters."""
    dst.state = kbm.KBState(*(t.clone() for t in src.state))
    if src._qscale is not None:
        dst._qscale, dst._qoffset = src._qscale.clone(), src._qoffset.clone()
    dst._masters = type(src._masters)(src._masters)


def _int8_before(eng: KBEngine):
    st = eng.state
    return tuple(t.clone() for t in (st.table, eng._qscale, eng._qoffset,
                                     st.grad_sum, st.grad_cnt,
                                     st.grad_sqnorm))


def _int8_lockstep():
    """The int8 op stream through a cuda and a dense engine in lockstep:
    after each op every leaf, scale and offset and the versions are held
    against the dense engine's, which the cuda engine then takes over, so
    that a code rounded the other way at a half-integer does not carry
    on. Returns the count of such codes and the cuda engine's launches."""
    n, d = 100_003, DIM
    rng = np.random.default_rng(11)
    eng_c, eng_d = (KBEngine(n, d, backend=b, storage="int8",
                             master_rows=64, device="cuda")
                    for b in ("cuda", "dense"))
    fill = rng.standard_normal((n, d), dtype=np.float32)
    ids = np.array([3, 17, 42, 3, n - 1, 17, 3, 500, 9_999, 42, 77])
    q = rng.standard_normal((5, d)).astype(np.float32)
    q[0] = fill[500]
    steps = [
        ("update", lambda e: e.update(np.arange(n), fill)),
        ("lazy_grad", lambda e: e.lazy_grad(ids, 0.1 * fill[:ids.size])),
        ("lookup", lambda e: e.lookup(ids)),
        ("update", lambda e: e.update(ids[:5], fill[5:10])),
        ("lazy_grad", lambda e: e.lazy_grad(ids[2:], 0.5 * fill[:9])),
        ("lookup", lambda e: e.lookup(ids[::-1].reshape(1, -1))),
        ("lazy_grad", lambda e: e.lazy_grad(ids, 30.0 * fill[20:31])),
        ("flush", lambda e: e.flush()),
        ("nn", lambda e: e.nn_search(q, K)),
        ("nn_excl", lambda e: e.nn_search(q, K, exclude_ids=np.stack(
            [np.full(5, 500), np.full(5, -1)], 1))),
    ]
    n_half = 0
    ops.reset_launch_counts()
    for label, step in steps:
        before = _int8_before(eng_d)
        touched = torch.unique(eng_d.state.grad_cnt.nonzero()[:, 0])
        out_c, out_d = step(eng_c), step(eng_d)
        torch.cuda.synchronize()
        if isinstance(out_d, tuple):
            require(np.abs(out_c[0] - out_d[0]).max() <= ATOL_SCORES
                    and np.array_equal(out_c[1], out_d[1]),
                    f"int8 cuda vs dense {label}")
        elif out_d is not None:
            require(np.abs(out_c - out_d).max() <= ATOL_ROWS,
                    f"int8 cuda vs dense {label}")
        st_c, st_d = eng_c.state, eng_d.state
        n_half += check_codes((st_c.table, eng_c._qscale, eng_c._qoffset),
                              (st_d.table, eng_d._qscale, eng_d._qoffset),
                              before, touched, f"int8 {label}")
        others = torch.ones(n, dtype=torch.bool, device="cuda")
        others[touched] = False
        require(torch.equal(st_c.table[others], st_d.table[others])
                and torch.equal(st_c.version, st_d.version)
                and torch.equal(st_c.grad_cnt, st_d.grad_cnt)
                and torch.equal(st_c.step, st_d.step)
                and all(max_err(getattr(st_c, f), getattr(st_d, f)) <= 1e-6
                        for f in ("grad_sum", "grad_sqnorm", "norm_ema")),
                f"int8 cuda vs dense state after {label}")
        _sync(eng_c, eng_d)
    return n_half, ops.launch_counts()


def _int8_stream_bits():
    """One int8 cuda run, as its final leaves and outputs (the repeated
    run must give the same bits)."""
    n, d = 100_003, DIM
    rng = np.random.default_rng(12)
    eng = KBEngine(n, d, backend="cuda", storage="int8", device="cuda")
    eng.update(np.arange(n), rng.standard_normal((n, d), dtype=np.float32))
    ids = np.array([3, 17, 42, 3, n - 1, 17, 3, 500])
    eng.lazy_grad(ids, rng.standard_normal((ids.size, d)))
    out = [eng.lookup(ids)]
    eng.lazy_grad(ids[::-1], rng.standard_normal((ids.size, d)))
    eng.flush()
    out += list(eng.nn_search(rng.standard_normal((4, d)), K))
    return out + [t.cpu() for t in (*eng.state, eng._qscale, eng._qoffset)]


def _ivf_parity(storage: str):
    """cuda and dense engines serving IVF searches from ONE index that the
    cuda engine built (on its build stream); and two builds of one
    snapshot identical."""
    n, d = 100_003, DIM
    # scaled to scores of a few tens, as those of the N(0, 1) serve bank
    bank = 0.2 * ann_index.clustered_bank(n, d, 256, noise=0.5, seed=13)
    eng_c, eng_d = (KBEngine(n, d, backend=b, storage=storage,
                             search_mode="ivf", ann_nlist=NLIST,
                             ann_nprobe=NPROBE, device="cuda")
                    for b in ("cuda", "dense"))
    for e in (eng_c, eng_d):
        e.update(np.arange(n), bank)
    eng_c.rebuild_ann_index()
    first = eng_c.ann_index
    eng_c.rebuild_ann_index()
    require(all(torch.equal(a, b) for a, b in
                zip(first.tensors(), eng_c.ann_index.tensors())),
            f"two {storage} index builds of one snapshot differ")
    eng_d.set_ann_index(eng_c.ann_index)
    rng = np.random.default_rng(14)
    q = (bank[rng.integers(0, n, 8)]
         + 0.05 * rng.standard_normal((8, d))).astype(np.float32)
    excl = np.stack([np.full(8, 7), np.full(8, -1)], 1)
    n_decided = 0
    for kw in ({}, {"exclude_ids": excl}):
        (s_c, i_c), (s_d, i_d) = (e.nn_search(q, K, **kw)
                                  for e in (eng_c, eng_d))
        require(np.abs(s_c - s_d).max() <= ATOL_SCORES,
                f"{storage} ivf scores: cuda vs dense")
        # the last rank is decided by the dense (k+1)-th score, where the
        # dense top-(k+1) extends the top-k
        s_d1, i_d1 = eng_d.nn_search(q, K + 1, **kw)
        last = np.where((i_d1[:, :K] == i_d).all(1),
                        s_d[:, -1] - s_d1[:, K], 0.0)
        gap = np.concatenate([s_d[:, :-1] - s_d[:, 1:], last[:, None]], 1)
        ok = (gap > ID_GAP) & (np.roll(gap, 1, 1) > ID_GAP)
        ok[:, 0] = gap[:, 0] > ID_GAP
        n_decided += int(ok.sum())
        require(np.array_equal(i_c[ok], i_d[ok]),
                f"{storage} ivf ids: cuda vs dense")
    require(eng_c.search_stats["ivf"] == 2 and eng_c.search_stats["exact"]
            == 0, f"{storage} ivf parity fell back: {eng_c.search_stats}")
    return n_decided


class ShardedReference(ShardedBackend):
    """The plain reference of ``ShardedBackend`` on the card: the dense
    backend's row ops and exact search (the bank's exact top-k is what the
    shards' merged top-k lists hold), and IVF through the meshless oracle
    ``ivf_search_sharded_ref`` (with the 4k shortlist of an int8 index)."""

    def __init__(self, n_shards: int):
        super().__init__(n_shards)
        dense = DenseBackend()
        self.lookup, self.update = dense.lookup, dense.update
        self.lazy_grad, self.flush = dense.lazy_grad, dense.flush
        self.nn_search = dense.nn_search

    def ivf_search(self, state, index, queries, k, nprobe):
        if hasattr(index, "packed_codes"):
            rows, kq = index.packed_codes, 4 * k
            extra = dict(packed_scale=index.packed_scale,
                         packed_offset=index.packed_offset)
        else:
            rows, kq, extra = index.packed_vecs, k, {}
        s, i = ivf_search_sharded_ref(state.table, index.centroids, rows,
                                      index.packed_ids, queries, kq, nprobe,
                                      n_shards=index.n_shards, **extra)
        return s[:, :k], i[:, :k]


def _sharded_stream(plain: bool, storage: str):
    """One op stream through a SHARDS-shard engine, the kernel backend or
    its plain reference: the row ops, exact search per shard with and
    without exclusion, then IVF through one sharded index that the kernel
    engine built (``index``: reuse it), with and without exclusion.
    Returns the outputs, the final state as numpy, and the index."""
    n, d = 100_002, DIM                 # SHARDS x 33,334
    rng = np.random.default_rng(16)
    bank = 0.2 * ann_index.clustered_bank(n, d, 256, noise=0.5, seed=17)
    backend = ShardedReference(SHARDS) if plain else ShardedBackend(SHARDS)
    eng = KBEngine(n, d, backend=backend,
                   storage=storage, search_mode="ivf", ann_nlist=NLIST,
                   ann_nprobe=NPROBE, device="cuda")
    eng.update(np.arange(n), bank)
    # ids straddle the shard boundaries (33,334 and 66,668)
    ids = np.array([3, 33_333, 33_334, 3, n - 1, 66_667, 66_668, 500])
    out = {}
    eng.lazy_grad(ids, rng.standard_normal((ids.size, d)))
    out["lookup"] = eng.lookup(ids)
    eng.lazy_grad(ids[::-1], rng.standard_normal((ids.size, d)))
    eng.flush()
    q = (bank[rng.integers(0, n, 8)]
         + 0.05 * rng.standard_normal((8, d))).astype(np.float32)
    out["exact_s"], out["exact_i"] = eng.nn_search(q, K, mode="exact")
    excl = np.stack([out["exact_i"][:, 0], out["exact_i"][:, 1],
                     np.full(8, -1)], 1)
    out["exactx_s"], out["exactx_i"] = eng.nn_search(q, K, mode="exact",
                                                     exclude_ids=excl)
    return eng, q, excl, out


def _sharded_parity(storage: str):
    """The sharded kernel backend against its plain reference on one op
    stream (state, lookups, exact and IVF searches), the kernel run twice
    bit for bit, two sharded builds of one snapshot identical, and the
    launches of the kernel run."""
    ops.reset_launch_counts()
    runs = []
    for _ in range(2):
        eng, q, excl, out = _sharded_stream(False, storage)
        eng.rebuild_ann_index()
        out["ivf_s"], out["ivf_i"] = eng.nn_search(q, K)
        out["ivfx_s"], out["ivfx_i"] = eng.nn_search(q, K, exclude_ids=excl)
        torch.cuda.synchronize()
        runs.append((eng, out, convert.kb_state_to_numpy(eng.state)))
    counts = ops.launch_counts()
    (eng_c, out_c, st_c), (eng_c2, out_c2, st_c2) = runs
    require(all(torch.equal(a, b) for a, b in
                zip(eng_c.ann_index.tensors(), eng_c2.ann_index.tensors())),
            f"two sharded {storage} builds of one snapshot differ")
    eng_d, q, excl, out_d = _sharded_stream(True, storage)
    eng_d.set_ann_index(eng_c.ann_index)
    out_d["ivf_s"], out_d["ivf_i"] = eng_d.nn_search(q, K)
    out_d["ivfx_s"], out_d["ivfx_i"] = eng_d.nn_search(q, K,
                                                       exclude_ids=excl)
    st_d = convert.kb_state_to_numpy(eng_d.state)
    for key in st_c:
        require(np.array_equal(st_c[key], st_c2[key]),
                f"sharded {storage}: repeated run differs in {key}")
        tol = 0 if key in ("version", "grad_cnt", "step") else 1e-6
        err = np.abs(st_c[key].astype(np.float64)
                     - st_d[key].astype(np.float64)).max()
        require(err <= tol, f"sharded {storage} vs plain {key}: {err}")
    n_decided = 0
    for key in out_c:
        require(np.array_equal(out_c[key], out_c2[key]),
                f"sharded {storage}: repeated run differs in {key}")
        if key.endswith("_i"):
            s_d = out_d[key[:-1] + "s"]
            gap = np.concatenate([s_d[:, :-1] - s_d[:, 1:],
                                  np.full((len(s_d), 1), np.inf)], 1)
            ok = (gap > ID_GAP) & (np.roll(gap, 1, 1) > ID_GAP)
            n_decided += int(ok.sum())
            require(np.array_equal(out_c[key][ok], out_d[key][ok]),
                    f"sharded {storage} vs plain {key}")
        else:
            tol = ATOL_ROWS if key == "lookup" else ATOL_SCORES
            require(np.abs(out_c[key] - out_d[key]).max() <= tol,
                    f"sharded {storage} vs plain {key}")
    require(eng_c.search_stats == {"exact": 2, "ivf": 2},
            f"sharded {storage}: {eng_c.search_stats}")
    kern = "ivf_stage2_sharded" + ("_q" if storage == "int8" else "")
    require(counts[kern] > 0 and counts["nn_search"] > 0
            and counts["kb_fused_lookup"] > 0 and counts["ivf_stage2"] == 0
            and counts["ivf_stage2_q"] == 0,
            f"sharded {storage} engine launches: {counts}")
    return eng_c, n_decided, counts


def shard_rows(t, sh: int):
    """Shard ``sh``'s block of a shard-major index array."""
    per = t.shape[0] // SHARDS
    return t[sh * per:(sh + 1) * per]


def _sharded_partial_rebuild(eng):
    """Rewrite 5000 rows of shard 1 of a built SHARDS-shard engine and
    rebuild that shard alone on the card: shards 0 and 2 keep their arrays
    and their clocks."""
    old, clocks = eng.ann_index, eng._ann_shard_built_at.copy()
    n_local = eng.num_entries // SHARDS
    rows = np.arange(n_local, n_local + 5000)
    # scaled by 1.01 (tests/test_sharded_ivf.py's perturbation): the
    # buckets keep their sizes, so the common capacity holds
    eng.update(rows, 1.01 * eng.table_snapshot()[rows])
    require(eng.rebuild_ann_index(shards=[1]) == 1,
            "a partial rebuild of shard 1 re-clustered another shard")
    new = eng.ann_index
    require(new.bucket_cap == old.bucket_cap, "the capacity changed")
    for sh in range(SHARDS):
        same = all(torch.equal(shard_rows(a, sh), shard_rows(b, sh))
                   for a, b in zip(old.tensors(), new.tensors()))
        require(same == (sh != 1), f"partial rebuild: shard {sh} "
                f"{'kept its arrays' if same else 'changed'}")
    kept = [0, 2]
    require(np.array_equal(eng._ann_shard_built_at[kept], clocks[kept])
            and eng.ann_shard_staleness_rows[1] == 0,
            "partial rebuild: the clocks moved")


def _ids_refused():
    """Out-of-range ids on a cuda server, fp32 and int8: each request is
    refused with KBIdError, the bank stays bit-identical, and the next
    request is served (the CUDA context is intact)."""
    n, d = 10_007, DIM
    fill = np.random.default_rng(15).standard_normal((n, d)).astype(
        np.float32)
    for storage in ("fp32", "int8"):
        srv = KnowledgeBankServer(n, d, backend="cuda", storage=storage,
                                  device="cuda")
        srv.update(np.arange(n), fill)
        srv.lazy_grad(np.array([1, 2]), fill[:2])
        want = srv.lookup(np.array([5, 6]))
        eng = srv.engine

        def bank():
            return [t.clone() for t in eng.state] + [
                t.clone() for t in (eng._qscale, eng._qoffset)
                if t is not None]

        before = bank()
        refused = 0
        for bad in (n, -1):
            for call in (lambda: srv.lookup(np.array([3, bad])),
                         lambda: srv.update(np.array([bad]), fill[:1]),
                         lambda: srv.lazy_grad(np.array([bad]), fill[:1]),
                         # -1 is an exclusion list's inert padding
                         lambda: srv.nn_search(fill[:2], K, exclude_ids=(
                             np.array([[-2 if bad < 0 else bad],
                                       [-1]])))):
                try:
                    call()
                except KBIdError:
                    refused += 1
        torch.cuda.synchronize()
        require(refused == 8, f"{storage}: {8 - refused} bad requests "
                "were not refused")
        require(all(torch.equal(a, b) for a, b in zip(bank(), before)),
                f"{storage}: a refused request changed the bank")
        require(np.array_equal(srv.lookup(np.array([5, 6])), want),
                f"{storage}: the server did not serve the next request")
        srv.close()
    log("phase 3: out-of-range ids (N and -1) refused with KBIdError on a "
        "cuda server, fp32 and int8 (lookup, update, lazy_grad, nn_search "
        "exclusion); bank unchanged; next request served")


def phase3_engine():
    _ids_refused()
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
    n_half, counts["int8"] = _int8_lockstep()
    require(counts["int8"]["kb_fused_lookup_q"] > 0,
            "the int8 engine never launched kb_fused_lookup_q")
    a, b = _int8_stream_bits(), _int8_stream_bits()
    require(all(np.array_equal(np.asarray(x), np.asarray(y))
                for x, y in zip(a, b)), "repeated int8 cuda run differs")
    log(f"phase 3: int8: cuda == dense op by op (every leaf, scale, offset, "
        f"versions; {n_half} codes rounded the other way at a "
        f"half-integer); repeated cuda run bit-identical; launches "
        f"{counts['int8']}")
    for storage in ("fp32", "int8"):
        ops.reset_launch_counts()
        n_decided = _ivf_parity(storage)
        counts[f"ivf_{storage}"] = ops.launch_counts()
        log(f"phase 3: {storage} ivf on one index: cuda == dense ({n_decided}"
            f" decided ids exact); two builds of one snapshot identical; "
            f"launches {counts[f'ivf_{storage}']}")
    for storage in ("fp32", "int8"):
        eng, n_decided, counts[f"sharded_{storage}"] = _sharded_parity(
            storage)
        log(f"phase 3: sharded ({SHARDS} shards) {storage}: kernel backend "
            f"== plain reference (state, lookups, exact and ivf searches, "
            f"{n_decided} decided ids exact); repeated run bit-identical; "
            f"two builds of one snapshot identical; launches "
            f"{counts[f'sharded_{storage}']}")
        _sharded_partial_rebuild(eng)
        log(f"phase 3: sharded {storage}: a partial rebuild of shard 1 on "
            f"the card left shards 0 and 2 bit-identical, their clocks "
            f"kept")
        del eng
    return counts


# the repo's own cold-tier configuration (benchmarks/kb_serving.py:336-343:
# 8,192 rows over 2,048 slots, cold after 1,024 written rows) at the serve
# width
TIER_ROWS, TIER_SLOTS, TIER_COLD_AFTER = 8_192, 2_048, 1_024
TIER_WAVE = 1_024
# phase 3's tiered engines: (label, storage, lazy_update, on disk)
TIER_CONFIGS = (("fp32", "fp32", True, False),
                ("immediate", "fp32", False, False),
                ("int8", "int8", True, False),
                ("disk", "fp32", True, True))
# phase 4: ogbn-mag at the repo's 4x oversubscription (a quarter of the
# bank resident), cold after half the slots' worth of written rows
TIER_SERVE_SLOTS = 484_936
TIER_SERVE_COLD_AFTER = 242_468


def _tier_inputs():
    """The tiered op stream's data: N(0, 1) rows from a seed; waves of an
    update of TIER_WAVE rows, lazy gradients on half of them and a lookup
    of 16 rows of the earlier waves (all cold by then) beside 8 draws of
    the wave's own; then queries near bank rows."""
    rng = np.random.default_rng(21)
    bank = rng.standard_normal((TIER_ROWS, DIM), dtype=np.float32)
    waves = []
    for lo in range(0, TIER_ROWS, TIER_WAVE):
        sel = np.arange(lo, lo + TIER_WAVE)
        cold = rng.choice(lo, 16, replace=False) if lo else sel[:16]
        waves.append((sel, bank[sel], rng.standard_normal(
            (TIER_WAVE // 2, DIM), dtype=np.float32),
            np.concatenate([cold, rng.choice(sel, 8)])))
    q = (bank[rng.integers(TIER_ROWS - TIER_WAVE, TIER_ROWS, 8)]
         + 0.05 * rng.standard_normal((8, DIM))).astype(np.float32)
    return waves, q


def _tier_engine(storage, lazy_update, tiered, device="cuda",
                 cold_dir=None):
    kw = (dict(resident_rows=TIER_SLOTS, cold_after_rows=TIER_COLD_AFTER,
               cold_dir=cold_dir) if tiered else {})
    return KBEngine(TIER_ROWS, DIM, storage=storage, lazy_update=lazy_update,
                    search_mode="ivf", ann_nlist=NLIST, ann_nprobe=NPROBE,
                    device=device, **kw)


def _tier_stream(eng, ivf: bool):
    """One op stream; returns its outputs (lookups, the table and
    versions before the flush, exact searches with and without exclusion,
    and with ``ivf`` a search through an index that a refresher built
    over the slots) and the tier bookkeeping after each wave."""
    waves, q = _tier_inputs()
    out, marks = {}, []
    for w, (sel, vals, g, look) in enumerate(waves):
        eng.update(sel, vals)
        eng.lazy_grad(sel[:TIER_WAVE // 2], g)
        out[f"lookup{w}"] = eng.lookup(look)
        if eng.tiered:
            marks.append((eng._slot_of.copy(), eng._slot_id.copy(),
                          list(eng._free_slots), eng._touch.copy(),
                          eng._gen, eng.tier_faults, eng.tier_spills))
    out["table"], out["version"] = (eng.table_snapshot(),
                                    eng.version_snapshot())
    eng.flush()
    out["nn_s"], out["nn_i"] = eng.nn_search(q, K, mode="exact")
    excl = np.stack([out["nn_i"][:, 0], np.full(len(q), -1)], 1)
    out["nnx_s"], out["nnx_i"] = eng.nn_search(q, K, mode="exact",
                                               exclude_ids=excl)
    if ivf:
        refresher = ann_index.IVFRefresher(eng, min_period_s=0.01)
        refresher.start()
        deadline = time.perf_counter() + 120.0
        while eng.ann_index is None:
            require(refresher.last_error is None
                    and time.perf_counter() < deadline,
                    f"tiered index build failed: {refresher.last_error}")
            time.sleep(0.01)
        refresher.stop()
        out["ivf_s"], out["ivf_i"] = eng.nn_search(q, K, mode="ivf")
        require(eng.search_stats["ivf"] == 1,
                f"the tiered ivf search fell back: {eng.search_stats}")
    torch.cuda.synchronize()
    return out, marks, q


def _check_tier_search(eng, out, q, keys) -> int:
    """Ids global and resident, scores exact for the ids returned (the
    flushed slot rows' float64 dot products), and for the exact searches
    the live ids those of the top k over the resident rows wherever their
    scores are more than ID_GAP apart (a freed slot's stale row may take a
    rank, which then reads (-inf, -1)). Returns the count of those."""
    gids = np.sort(eng._slot_id[eng._slot_id >= 0])
    rows = eng.table_snapshot()[gids].astype(np.float64)
    want = q.astype(np.float64) @ rows.T            # (B, resident rows)
    n_decided = 0
    for key in keys:
        s, i = out[key + "_s"], out[key + "_i"]
        live = i >= 0
        require(bool(live[:, 0].all()) and np.isin(i[live], gids).all(),
                f"tiered {key}: ids not resident global ids")
        b, j = np.nonzero(live)
        col = np.searchsorted(gids, i[b, j])
        require(np.abs(s[b, j] - want[b, col]).max() <= ATOL_SCORES,
                f"tiered {key}: scores not exact for the ids returned")
        if key == "ivf":
            continue
        w = want.copy()
        if key == "nnx":            # the exclusion: each query's first id
            w[np.arange(len(q)), np.searchsorted(gids, out["nn_i"][:, 0])] \
                = -np.inf
        top = np.argsort(-w, 1, kind="stable")[:, :K + 1]
        ws = np.take_along_axis(w, top, 1)
        gap = ws[:, :-1] - ws[:, 1:]                 # below each rank
        above = np.concatenate([np.full((len(q), 1), np.inf),
                                gap[:, :-1]], 1)
        ok = (gap > ID_GAP) & (above > ID_GAP) & live
        n_decided += int(ok.sum())
        require(np.array_equal(i[ok], gids[top[:, :K]][ok]),
                f"tiered {key}: ids differ from the resident top k")
    return n_decided


def _tier_config(label, storage, lazy_update, on_disk):
    """One tiered configuration on the card: its launches, and its checks
    against the untiered cuda engine, a tiered engine on the CPU and a
    repeat."""
    with tempfile.TemporaryDirectory() as tmp:
        ops.reset_launch_counts()
        eng = _tier_engine(storage, lazy_update, True,
                           cold_dir=tmp if on_disk else None)
        out, marks, q = _tier_stream(eng, ivf=lazy_update)
        counts = ops.launch_counts()
        cold_rows = len(eng.cold_store)
        n_decided = _check_tier_search(
            eng, out, q, ("nn", "nnx") + (("ivf",) if lazy_update else ()))
        again, _, _ = _tier_stream(_tier_engine(storage, lazy_update, True),
                                   ivf=lazy_update)
    flat, _, _ = _tier_stream(_tier_engine(storage, lazy_update, False),
                              ivf=False)
    cpu = _tier_engine(storage, lazy_update, True, device="cpu")
    cpu_out, cpu_marks, _ = _tier_stream(cpu, ivf=False)
    for key in out:
        require(np.array_equal(out[key], again[key]),
                f"tiered {label}: a repeat differs in {key}")
    for key in flat:
        if key.startswith("lookup") or key in ("table", "version"):
            require(np.array_equal(out[key], flat[key]),
                    f"tiered {label}: {key} differs from the untiered "
                    f"cuda engine")
    for w, (a, b) in enumerate(zip(marks, cpu_marks)):
        require(all(np.array_equal(np.asarray(x), np.asarray(y))
                    for x, y in zip(a, b)),
                f"tiered {label}: slot maps or counts differ from the CPU "
                f"engine's after wave {w}")
    for key in cpu_out:
        if key.startswith("lookup"):
            require(np.abs(out[key] - cpu_out[key]).max() <= ATOL_ROWS,
                    f"tiered {label}: {key} against the CPU engine")
    require(np.array_equal(out["version"], cpu_out["version"]),
            f"tiered {label}: versions against the CPU engine")
    faults, spills = eng.tier_faults, eng.tier_spills
    require(faults > 0 and spills > 0 and cold_rows > 0,
            f"tiered {label}: faults {faults}, spills {spills}, "
            f"{cold_rows} cold rows")
    log(f"phase 3: tiered {label} ({TIER_ROWS} x {DIM} over {TIER_SLOTS} "
        f"slots, cold after {TIER_COLD_AFTER}"
        f"{', disk store' if on_disk else ''}): lookups, table and versions "
        f"bit-identical to the untiered cuda engine's; slot maps, "
        f"{faults} faults and {spills} spills exact against the CPU "
        f"engine; search ids global, scores exact ({n_decided} decided "
        f"ids exact); a repeat{' from a host-RAM store' if on_disk else ''}"
        f" bit-identical; launches {counts}")
    return counts


def _export_import():
    """export_rows -> import_rows between two cuda engines, and leaves
    exported on the CPU imported on the card, bit-identical, fp32 and
    int8."""
    rng = np.random.default_rng(22)
    n, ids = 10_007, np.arange(0, 10_007, 3)
    vals = rng.standard_normal((n, DIM), dtype=np.float32)
    for storage in ("fp32", "int8"):
        src, dst = (KBEngine(n, DIM, storage=storage, device="cuda")
                    for _ in range(2))
        cpu = KBEngine(n, DIM, storage=storage, device="cpu")
        for e in (src, cpu):
            e.update(np.arange(n), vals)
            e.lazy_grad(ids[::2], vals[:ids[::2].size])
        leaves = src.export_rows(ids)
        dst.import_rows(ids, leaves)
        back = dst.export_rows(ids)
        require(all(np.array_equal(back[f], leaves[f]) for f in leaves),
                f"{storage}: export -> import -> export between two cuda "
                f"engines differs")
        host = cpu.export_rows(ids)
        dst.import_rows(ids, host)
        back = dst.export_rows(ids)
        require(all(back[f].dtype == host[f].dtype
                    and np.array_equal(back[f], host[f]) for f in host),
                f"{storage}: CPU-exported leaves imported on the card "
                f"differ")
    log("phase 3: export_rows -> import_rows between two cuda engines and "
        "from the CPU to the card bit-identical (every leaf, fp32 and "
        "int8, pending gradients included)")


def phase3_tiered() -> dict:
    c = {cfg[0]: _tier_config(*cfg) for cfg in TIER_CONFIGS}
    require(c["fp32"]["kb_fused_lookup"] > 0 and c["fp32"]["nn_search"] > 0
            and c["fp32"]["lazy_apply"] > 0 and c["fp32"]["ivf_stage2"] > 0,
            f"the tiered fp32 engine missed a kernel: {c['fp32']}")
    require(c["immediate"]["kb_gather"] > 0,
            f"the tiered lazy_update=False engine never launched "
            f"kb_gather: {c['immediate']}")
    require(c["int8"]["kb_fused_lookup_q"] > 0
            and c["int8"]["ivf_stage2_q"] > 0,
            f"the tiered int8 engine missed a kernel: {c['int8']}")
    _export_import()
    return c


def serve_run(label: str, extra, rounds: int):
    """One full-width serve run through the launcher, with every kernel
    counter set to 0 just before it and read just after (``extra`` may
    name another ``--kb-backend``)."""
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    res = serve.main(["--kb", "--kb-backend", "cuda", "--kb-entries",
                      str(N_ROWS), "--kb-dim", str(DIM), "--clients", "8",
                      "--batch", "4", "--gen", str(rounds), *extra])
    counts = ops.launch_counts()
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    eng = res["engine"]
    st = eng.state
    rows = (kbm.dequantize_rows(st.table, eng._qscale, eng._qoffset)
            if eng.storage == "int8" else st.table)
    require(bool(torch.isfinite(rows).all()), f"{label}: bank not finite")
    require(float(st.grad_cnt.abs().sum()) == 0.0
            and float(st.grad_sum.abs().sum()) == 0.0,
            f"{label}: caches not empty after the final flush")
    require(res["coalescing_factor"] > 1.0, f"{label}: nothing coalesced")
    first = res["first_index_s"]
    log(f"phase 4: {label}: {res['req_per_s']} req/s over {rounds} rounds "
        f"of 8 clients ({res['requests']} requests, {res['dispatches']} "
        f"dispatches), nn ivf/exact={res['search_stats']['ivf']}/"
        f"{res['search_stats']['exact']}, index rebuilds="
        f"{res['index_rebuilds']} ({res['shard_rebuilds']} shard builds), "
        f"first index built in "
        f"{'n/a' if first is None else f'{first:.3f} s'}; {wall:.1f} s with "
        f"fill and warm-up; peak device memory {peak} bytes; launches "
        f"{counts} (one of each non-IVF kernel in the warm-up on a scratch "
        f"bank)")
    res["peak"] = peak
    return res, counts


def phase4_serve():
    paths = {}
    res, paths["serve_exact"] = serve_run("fp32 exact", [], SERVE_ROUNDS)
    c = paths["serve_exact"]
    # the warm-up launches each kernel once on a scratch bank; the rest
    # are the clients' requests and the final flush
    require(c["kb_fused_lookup"] > 1 and c["nn_search"] > 1
            and c["lazy_apply"] > 1,
            f"the exact serve path missed a kernel: {c}")
    peak_untiered = res["peak"]
    del res
    gc.collect()
    paths["serve_exact_tiered"] = serve_tiered(peak_untiered)
    for storage, kern in (("fp32", "ivf_stage2"), ("int8", "ivf_stage2_q")):
        label = f"serve_{storage}_ivf"
        res, c = serve_run(f"{storage} ivf",
                           ["--kb-storage", storage, "--kb-search", "ivf",
                            "--nlist", str(NLIST), "--nprobe", str(NPROBE)],
                           SERVE_ROUNDS)
        paths[label] = c
        # the index is never stale in this run (ann_stale_rows defaults to
        # the bank's size), so every search, the clients' and the warm-up,
        # must go through it: one exact fallback fails the run
        require(res["search_stats"]["exact"] == 0
                and res["search_stats"]["ivf"] > 0 and c[kern] > 1,
                f"{storage} ivf serve did not search through the index: "
                f"{res['search_stats']}, {c}")
        if storage == "int8":
            require(c["kb_fused_lookup_q"] > 1,
                    f"the int8 serve path missed kb_fused_lookup_q: {c}")
    paths["serve_sharded_ivf"] = serve_sharded()
    return paths


def serve_tiered(peak_untiered: int) -> dict:
    """The fp32 exact serve of ogbn-mag from a device tier a quarter of its
    size, the rest in host RAM: the device table must hold the slots only,
    rows must fault in and spill, the lookup, search and flush kernels must
    launch."""
    res, c = serve_run("fp32 exact tiered",
                       ["--kb-resident-rows", str(TIER_SERVE_SLOTS),
                        "--kb-cold-after", str(TIER_SERVE_COLD_AFTER)],
                       SERVE_ROUNDS)
    eng = res["engine"]
    st = eng.storage_stats()
    require(tuple(eng.state.table.shape) == (TIER_SERVE_SLOTS, DIM)
            and st["resident_rows"] == TIER_SERVE_SLOTS,
            f"tiered serve: device table {tuple(eng.state.table.shape)}")
    require(st["tier_faults"] > 0 and st["tier_spills"] > 0,
            f"tiered serve: faults {st['tier_faults']}, spills "
            f"{st['tier_spills']}")
    require(c["kb_fused_lookup"] > 1 and c["nn_search"] > 1
            and c["lazy_apply"] > 1,
            f"the tiered exact serve path missed a kernel: {c}")
    t0 = time.perf_counter()
    store = eng.cold_store
    cold = [g for g in store.ids() if eng._slot_of[g] < 0]
    pending = sum(1 for g in cold if store.get(g)["grad_cnt"] > 0)
    host_bytes = store.bytes_stored()
    walk_s = time.perf_counter() - t0
    # a search over the slots after serving: freed slots keep stale rows,
    # which the translation masks to (-inf, -1) after the top k
    q = np.random.default_rng(23).standard_normal((BATCH, DIM),
                                                   dtype=np.float32)
    _, ids = eng.nn_search(q, K)
    log(f"phase 4: fp32 exact tiered: {TIER_SERVE_SLOTS} of {N_ROWS} rows "
        f"resident, cold after {TIER_SERVE_COLD_AFTER} written rows; fill "
        f"{res['fill_s']:.3f} s; {res['req_per_s']} req/s; "
        f"{st['tier_faults']} faults, {st['tier_spills']} spills; "
        f"{st['cold_rows']} rows in the cold store, {len(cold)} of them "
        f"not resident, {pending} holding pending gradients; cold store "
        f"{host_bytes} bytes (bytes_stored; walked in {walk_s:.1f} s); peak "
        f"device memory {res['peak']} bytes against {peak_untiered} "
        f"untiered; a search of {BATCH} queries after serving: "
        f"{int((ids < 0).sum())} of {ids.size} ids -1 (freed slots' stale "
        f"rows in the top {K})")
    return c


def serve_sharded():
    """``--kb-backend sharded --kb-shards SHARDS --kb-search ivf`` at full
    width through the launcher, then the partial rebuilds on a server of
    the same configuration (``sharded_rewrites``)."""
    res, c = serve_run(f"fp32 sharded ivf ({SHARDS} shards)",
                       ["--kb-backend", "sharded", "--kb-shards",
                        str(SHARDS), "--kb-search", "ivf", "--nlist",
                        str(NLIST), "--nprobe", str(NPROBE)], SERVE_ROUNDS)
    require(res["search_stats"]["exact"] == 0
            and res["search_stats"]["ivf"] > 0
            and c["ivf_stage2_sharded"] > 1 and c["ivf_stage2"] == 0
            and c["kb_fused_lookup"] > 1 and c["lazy_apply"] > 1,
            f"the sharded ivf serve did not search through its index: "
            f"{res['search_stats']}, {c}")
    for st in res["engine"].ann_index.shard_stats():
        log(f"phase 4: sharded ivf shard {st}")
    first_s = res["first_index_s"]
    del res
    gc.collect()
    torch.cuda.empty_cache()
    sharded_rewrites(first_s)
    return c


def _await_rebuild(refresher, before: int, acked: float) -> float:
    """Wait until the refresher's ``shard_rebuilds`` leaves ``before``;
    the seconds from ``acked`` to then."""
    deadline = acked + 120.0
    while refresher.shard_rebuilds == before:
        require(refresher.last_error is None and time.perf_counter()
                < deadline, f"no rebuild: {refresher.last_error}")
        time.sleep(0.001)
    return time.perf_counter() - acked


def _shards_same(old, new, shards) -> bool:
    return all(torch.equal(shard_rows(a, sh), shard_rows(b, sh))
               for sh in shards for a, b in zip(old.tensors(),
                                                new.tensors()))


def sharded_rewrites(first_s: float):
    """A server of the served configuration (the launcher's seed-0 bank,
    SHARDS shards, NLIST buckets each) with its refresher; the rows of
    shard 1 that the refresher's per-shard budget asks for are rewritten
    twice. First with their own values: the buckets keep their sizes, so
    the refresher must rebuild shard 1 alone (shard_rebuilds + 1), shards
    0 and 2 keeping their arrays bit for bit and their clocks. Then with
    fresh N(0, 1) values: the refresher stays partial only if shard 1's
    new buckets fit the common capacity, else it repacks every shard at a
    larger one (shard_rebuilds + SHARDS); which one it took, the capacity
    before and after and the headroom are printed, and searches for the
    rewritten rows through the new index must find what the exact search
    finds. Last, the full and the one-shard
    build are timed in turns on the same bank and lock."""
    server = KnowledgeBankServer(N_ROWS, DIM,
                                 backend=ShardedBackend(SHARDS),
                                 search_mode="ivf", ann_nlist=NLIST,
                                 ann_nprobe=NPROBE, device="cuda")
    try:
        eng = server.engine
        server.update(np.arange(N_ROWS), np.random.default_rng(0)
                      .standard_normal((N_ROWS, DIM), dtype=np.float32))
        refresher = server.start_ann_refresher(min_period_s=0.01)
        serve._first_index(server, refresher)
        n_local, budget = N_ROWS // SHARDS, refresher.rebuild_shard_rows
        rows = np.arange(n_local, n_local + budget)

        # 1. the rows' own current values
        old, clocks = eng.ann_index, eng._ann_shard_built_at.copy()
        before = refresher.shard_rebuilds
        values = eng.state.table[n_local:n_local + budget].cpu().numpy()
        t0 = time.perf_counter()
        server.update(rows, values)
        acked = time.perf_counter()
        seen_s = _await_rebuild(refresher, before, acked)
        new = eng.ann_index
        require(refresher.shard_rebuilds == before + 1
                and new.bucket_cap == old.bucket_cap,
                f"the refresher rebuilt {refresher.shard_rebuilds - before} "
                f"shards (capacity {old.bucket_cap} -> {new.bucket_cap})")
        require(_shards_same(old, new, (0, 2)),
                "the partial rebuild changed shard 0 or 2")
        require(np.array_equal(eng._ann_shard_built_at[[0, 2]],
                               clocks[[0, 2]]), "the untouched clocks moved")
        stats = server.stats()
        log(f"phase 4: partial rebuild of shard 1 after {budget} rows "
            f"written with their own values: {refresher.last_build_s:.4f} s "
            f"snapshot to publication, seen {seen_s:.4f} s after the write "
            f"was acknowledged ({acked - t0:.4f} s after it was sent); the "
            f"first full build ({SHARDS} shards) took {first_s:.4f} s; "
            f"shards 0 and 2 bit-identical, their clocks kept; server "
            f"stats: rebuilds {stats['rebuilds']}, shard_rebuilds "
            f"{stats['shard_rebuilds']} (was {before})")

        # 2. fresh values: the buckets of shard 1 change their sizes
        old, before = eng.ann_index, refresher.shard_rebuilds
        head = [st["headroom"] for st in old.shard_stats()]
        fresh = np.random.default_rng(1).standard_normal(
            (budget, DIM), dtype=np.float32)
        server.update(rows, fresh)
        acked = time.perf_counter()
        seen_s = _await_rebuild(refresher, before, acked)
        new, grew = eng.ann_index, refresher.shard_rebuilds - before
        if grew == 1:
            require(new.bucket_cap == old.bucket_cap
                    and _shards_same(old, new, (0, 2)),
                    "a partial rebuild moved the capacity or shards 0, 2")
        else:
            require(grew == SHARDS and new.bucket_cap > old.bucket_cap,
                    f"fresh rewrite: {grew} shard builds, capacity "
                    f"{old.bucket_cap} -> {new.bucket_cap}")
        probe = fresh[::budget // 256][:256]
        exact = eng.search_stats["exact"]
        _, top = server.nn_search(probe, k=K)
        require(eng.search_stats["exact"] == exact,
                f"a search fell back to exact: {eng.search_stats}")
        _, want = server.nn_search(probe, k=K, mode="exact")
        found = float(np.mean(top[:, 0] == want[:, 0]))
        require(found >= 0.95, f"rewritten rows as queries: top-1 through "
                f"the index == exact for {found}")
        log(f"phase 4: {budget} rows of shard 1 rewritten with fresh "
            f"N(0, 1) values: the refresher "
            f"{'stayed partial' if grew == 1 else 'repacked every shard'} "
            f"(shard_rebuilds + {grew}), {refresher.last_build_s:.4f} s "
            f"snapshot to publication, seen {seen_s:.4f} s after the "
            f"acknowledgement; bucket_cap {old.bucket_cap} -> "
            f"{new.bucket_cap}; headroom before {head}, after "
            f"{[st['headroom'] for st in new.shard_stats()]}; "
            f"{len(probe)} rewritten rows as queries: top-1 through the "
            f"index == exact for {found}")

        # 3. the two builds warm, in turns, on the same bank and lock
        refresher.stop()
        took = {"full": [], "shard 1": []}
        for label, shards in (("full", None), ("shard 1", [1])) * 3:
            t0 = time.perf_counter()
            n = eng.rebuild_ann_index(shards=shards, lock=refresher.lock)
            took[label].append(time.perf_counter() - t0)
            require(n == (1 if shards else SHARDS), f"{label}: {n} shards")
        log(f"phase 4: rebuild_ann_index on the served bank, in turns: "
            f"all {SHARDS} shards {took['full']} s, shard 1 alone "
            f"{took['shard 1']} s")
    finally:
        server.close()


def _to(tree, device):
    if isinstance(tree, dict):
        return {k: _to(v, device) for k, v in tree.items()}
    return tree.to(device)


def _phase(arch: str) -> str:
    return {"yi-6b": "phase 5", "rwkv6-7b": "phase 6",
            JAMBA: "phase 7"}.get(arch, "phase 11")


def frontend_inputs(cfg, B: int, seed: int, device, dtype) -> dict:
    """The front-end's inputs of ``cfg``, N(0, 1) from
    ``np.random.default_rng(seed)``: internvl's patch embeddings, whisper's
    frames, each (B, num_frontend_tokens, d_model); {} for a text model."""
    if cfg.frontend == "none":
        return {}
    x = np.random.default_rng(seed).standard_normal(
        (B, cfg.num_frontend_tokens, cfg.d_model)).astype(np.float32)
    key = "patch_embs" if cfg.frontend == "vision" else "frames"
    return {key: torch.from_numpy(x).to(device=device, dtype=dtype)}


def reduced_parity(arch: str, kernels: dict, rtol: float, head_dim: int = 0):
    """The reduced ``arch`` (fp32, d 128; ``head_dim`` in place of its 32
    where given) on the card against the CPU, on one set of parameters,
    prompts and front-end inputs: the prefill's hidden states and every
    cache entry (the path's kernels on the card, their plain versions on
    the CPU), then four decode steps fed the CPU's greedy ids, their
    logits and ids. Each value within ATOL_LM plus ``rtol`` of its CPU
    value; ``kernels`` gives each kernel's launches in the card's
    prefill."""
    cfg = get_config(arch).reduced()
    if head_dim:
        cfg = cfg.replace(head_dim=head_dim)
    model = build_model(cfg)
    p_cpu = model.init(torch.Generator().manual_seed(0))
    p_dev = _to(p_cpu, "cuda")
    toks = torch.from_numpy(np.random.default_rng(2).integers(
        0, cfg.vocab_size, (2, LM_PROMPT)).astype(np.int32))
    x_cpu = frontend_inputs(cfg, 2, 3, "cpu", torch.float32)
    x_dev = _to(x_cpu, "cuda")
    prefix = cfg.num_frontend_tokens if cfg.frontend == "vision" else 0
    C = LM_PROMPT + prefix + 5

    def err(a, b, what):
        a = a.cpu()
        over = (a - b).abs() - rtol * b.abs() > ATOL_LM
        require(not bool(over.any()), f"reduced {arch} card vs CPU: {what} "
                f"off at {int(over.sum())} entries")
        return max_err(a, b)

    with torch.inference_mode():
        ops.reset_launch_counts()
        cache_d, h_d = model.prefill(p_dev, toks.cuda(), x_dev, cache_len=C)
        launches = ops.launch_counts()
        cache_c, h_c = model.prefill(p_cpu, toks, x_cpu, cache_len=C)
        errs = {"hidden": err(h_d, h_c, "hidden")}
        for pk, ent in cache_c["groups"].items():
            for n, leaf in ent.items():
                e = err(cache_d["groups"][pk][n], leaf, f"cache {pk} {n}")
                errs[f"cache {n}"] = max(errs.get(f"cache {n}", 0.0), e)
        last, errs["logits"], decided = toks[:, -1:], 0.0, 0
        for _ in range(4):
            l_d = model.decode_step(p_dev, cache_d, last.cuda())[0][:, -1]
            l_c = model.decode_step(p_cpu, cache_c, last)[0][:, -1]
            errs["logits"] = max(errs["logits"], err(l_d, l_c, "logits"))
            l_d = l_d.cpu()
            top2 = l_c.topk(2).values
            ok = (top2[:, 0] - top2[:, 1]) > ID_GAP
            require(torch.equal(l_d.argmax(-1)[ok], l_c.argmax(-1)[ok]),
                    f"reduced {arch}: card and CPU ids differ")
            decided += int(ok.sum())
            last = l_c.argmax(-1, keepdim=True).to(torch.int32)
    got = {k: launches[k] for k in kernels}
    require(got == kernels,
            f"reduced {arch} prefill launched {got}, not {kernels}")
    log(f"{_phase(arch)}: reduced {arch} ({cfg.num_layers} layers, d "
        f"{cfg.d_model}, head dim {cfg.head_dim_}, fp32), prompt 2 x "
        f"{LM_PROMPT} (+ {cfg.num_frontend_tokens} {cfg.frontend} front-end "
        f"inputs), 4 decode steps: "
        f"card vs CPU max abs err {errs}; ids equal on the {decided} "
        f"decided steps; launches in the card's prefill {got}")


def lm_run(label: str, cfg, kernels: dict, prompt: int = LM_PROMPT,
           params=None, extra=None):
    """``serve_lm`` at the full width of ``cfg`` (on ``params`` and the
    front-end inputs ``extra`` where given), with every kernel counter set
    to 0 just before it and read just after; each kernel of ``kernels``
    must have been launched that many times in the prefill and never in
    the decode."""
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    res = serve.serve_lm(cfg, batch=LM_B, prompt_len=prompt, gen=LM_GEN,
                         seed=0, device="cuda", params=params, extra=extra)
    counts = ops.launch_counts()
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    gen = res["generated"]
    require(gen.shape == (LM_B, LM_GEN)
            and bool(((gen >= 0) & (gen < cfg.vocab_size)).all())
            and bool(torch.isfinite(res["last_logits"]).all()),
            f"{label}: ids out of range or logits not finite")
    for kernel, n in kernels.items():
        require(res["prefill_launches"][kernel] == n
                and res["decode_launches"][kernel] == 0,
                f"{label}: {kernel} launches {res['prefill_launches']} in "
                f"the prefill, {res['decode_launches']} in the decode")
    log(f"{_phase(cfg.name)}: {label}: prefill({LM_B}x{prompt}) "
        f"{res['prefill_ms']} ms, decode {res['decode_ms_per_token']} "
        f"ms/token, peak device memory {peak} bytes, {wall:.1f} s with "
        f"init; launches {counts}")
    return res, counts


# kernel names in a profile, by the part of the model they serve
PROFILE_PARTS = (("GEMMs", ("gemm", "nvjet", "cutlass", "xmma", "sm90_")),
                 ("mamba_scan", ("scan_kernel",)),
                 ("flash_attention", ("flash",)),
                 ("rwkv_wkv", ("wkv_kernel",)),
                 ("gathers, sorts, scatters", ("index", "gather", "sort",
                                               "scatter", "bincount",
                                               "radix", "cub")))


def device_parts(prof):
    """From a finished ``torch.profiler`` run: the device time in ms, its
    split by part of the model (PROFILE_PARTS) and its largest kernels.
    Device-side events only, the capture's lead (SPIN) left out: a CPU
    op's device time repeats that of the kernels it launched."""
    from torch.autograd import DeviceType
    ev = [e for e in prof.key_averages()
          if e.device_type == DeviceType.CUDA
          and e.self_device_time_total > 0 and SPIN not in e.key]
    parts = {}
    for e in ev:
        key = e.key.lower()
        part = next((n for n, pats in PROFILE_PARTS
                     if any(p in key for p in pats)), "elementwise and other")
        parts[part] = parts.get(part, 0.0) + e.self_device_time_total / 1e3
    top = sorted(ev, key=lambda e: -e.self_device_time_total)[:8]
    return (sum(e.self_device_time_total for e in ev) / 1e3,
            "; ".join(f"{n} {v:.4g} ms" for n, v in
                      sorted(parts.items(), key=lambda kv: -kv[1])),
            "; ".join(f"{e.key[:60]} x{e.count} "
                      f"{e.self_device_time_total / 1e3:.4g} ms"
                      for e in top))


# A capture drops its first device records: none early in a process, a
# dozen or more once a full-width model has trained for a while (the
# training step's first copies, its lookup kernel and the lookup range's
# device-side annotation, capture after capture). Padding the capture with
# idle host time saves nothing; a lead of kernels does. Each capture starts
# with PROFILE_LEAD sleep kernels (SPIN, which every reading skips) and a
# sync, and is taken again when none of them survived, since the loss may
# then have reached ``fn``'s own records.
PROFILE_LEAD = 256
SPIN = "spin_kernel"        # torch.cuda._sleep's kernel


def profiled(fn, need=None):
    """Run ``fn`` under ``torch.profiler`` after PROFILE_LEAD sleep
    kernels; (wall ms of ``fn``, profile). A capture that kept none of the
    lead, or fails ``need(profile)``, lost records (CUPTI now and then
    delivers none, or drops a range's device-side annotation), so ``fn``
    runs again under a new one, at most ``PROFILE_CAPTURES`` times."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    for _ in range(PROFILE_CAPTURES):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(PROFILE_LEAD):
                torch.cuda._sleep(1000)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
        lead = sum(SPIN in e.name for e in prof.events()
                   if e.device_type == DeviceType.CUDA)
        if lead and (need is None or need(prof)):
            return wall_ms, prof
        log(f"torch.profiler lost device records ({PROFILE_LEAD - lead} of "
            f"the {PROFILE_LEAD} lead kernels); capturing again")
    require(False, f"torch.profiler lost the device records of "
            f"{PROFILE_CAPTURES} captures in a row")


def profile_lm(cfg):
    """One prefill and four decode steps of the full-width ``cfg`` under
    ``torch.profiler``: wall time, device time by part of the model and
    by kernel, busy share."""
    phase = _phase(cfg.name)
    model = build_model(cfg)
    params = model.init(torch.Generator(device="cuda").manual_seed(0))
    toks = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (LM_B, LM_PROMPT)).astype(np.int32)).cuda()
    state = {}

    def prefill():
        state["cache"], _ = model.prefill(
            params, toks, cache_len=LM_PROMPT + LM_GEN + 1)

    def decode():
        last = toks[:, -1:]
        for _ in range(4):
            logits, _ = model.decode_step(params, state["cache"], last)
            last = logits[:, -1].argmax(-1, keepdim=True).to(torch.int32)

    with torch.inference_mode():
        for label, fn in (("prefill", prefill), ("decode 4 steps", decode)):
            wall_ms, prof = profiled(fn)
            dev_ms, parts, top = device_parts(prof)
            log(f"{phase}: profiled {cfg.name} {label} ({LM_B}x{LM_PROMPT}): "
                f"wall {wall_ms} ms, device {dev_ms} ms "
                f"({100 * dev_ms / wall_ms:.1f}% busy under the profiler); "
                f"by part: {parts}; top: {top}")


def profile_mamba_layer(cfg):
    """One full-width Mamba mixer (``ssm.mamba_apply_state``) on a
    prefill's input (B 4, S 2048, N(0, 1) in bf16) under the profiler,
    after a warm-up call: the split of the layer's device time between
    its GEMMs, the scan and its elementwise passes."""
    from repro_torch.models import ssm
    params = ssm.mamba_init(torch.Generator(device="cuda").manual_seed(0),
                            cfg)
    g = torch.Generator(device="cuda").manual_seed(1)
    x = torch.randn((LM_B, LM_PROMPT, cfg.d_model), generator=g,
                    device="cuda").to(torch.bfloat16)
    with torch.inference_mode():
        ssm.mamba_apply_state(params, x, cfg)
        wall_ms, prof = profiled(lambda: ssm.mamba_apply_state(params, x,
                                                               cfg))
    dev_ms, parts, top = device_parts(prof)
    log(f"phase 7: profiled one {cfg.name} Mamba layer ({LM_B}x{LM_PROMPT}):"
        f" wall {wall_ms} ms, device {dev_ms} ms; by part: {parts}; top: "
        f"{top}")


def free_weights(phase: str, before: str) -> None:
    """Drop the last model's weights and reset the peak-memory counter;
    raise if more than 1 GiB is still allocated."""
    gc.collect()
    torch.cuda.empty_cache()
    held = torch.cuda.memory_allocated()
    require(held < 2 ** 30, f"{held} bytes still allocated before the "
            f"{before} runs: the last model's weights were not freed")
    torch.cuda.reset_peak_memory_stats()
    log(f"{phase}: {held} bytes allocated before the full-width runs")


def phase5_lm():
    cfg = get_config("yi-6b")
    flash = {"flash_attention": cfg.num_layers}
    reduced_parity("yi-6b", {"flash_attention": 2}, rtol=0.0)
    res1, counts = lm_run("yi-6b full width run 1", cfg, flash)
    res2, _ = lm_run("yi-6b full width run 2", cfg, flash)
    require(np.array_equal(res1["generated"], res2["generated"]),
            "the two full-width runs generated different ids")
    log("phase 5: the two full-width runs generated the same ids")
    del res1, res2
    profile_lm(cfg)
    return counts


def phase6_rwkv():
    # the state S is a sum over the 2048 steps: RTOL_WKV of its value too
    reduced_parity("rwkv6-7b", {"rwkv_wkv": 2, "flash_attention": 0},
                   rtol=RTOL_WKV)
    free_weights("phase 6", "rwkv6-7b")
    cfg = get_config("rwkv6-7b")
    wkv = {"rwkv_wkv": cfg.num_layers, "flash_attention": 0}
    res1, counts = lm_run("rwkv6-7b full width run 1", cfg, wkv)
    res2, _ = lm_run("rwkv6-7b full width run 2", cfg, wkv)
    require(np.array_equal(res1["generated"], res2["generated"]),
            "the two full-width rwkv6-7b runs generated different ids")
    log("phase 6: the two full-width runs generated the same ids")
    del res1, res2
    profile_lm(cfg)
    return counts


def phase7_jamba():
    """jamba's hybrid group: the reduced model (8 layers, d 128, 4
    experts, fp32) card against CPU; then, rwkv6-7b's weights freed, the
    cut config (JAMBA_CUT) at full width twice and profiled."""
    # the states h are sums over the 2048 steps: RTOL_SCAN of their value
    per_prefill = {"mamba_scan": 7, "flash_attention": 1, "rwkv_wkv": 0}
    reduced_parity(JAMBA, per_prefill, rtol=RTOL_SCAN)
    free_weights("phase 7", JAMBA)
    cfg = get_config(JAMBA).replace(**JAMBA_CUT)
    log(f"phase 7: {JAMBA} cut to {JAMBA_CUT}: {cfg.param_count()} "
        f"parameters, {cfg.active_param_count()} active a token")
    res1, counts = lm_run(f"{JAMBA} full width run 1", cfg, per_prefill)
    res2, _ = lm_run(f"{JAMBA} full width run 2", cfg, per_prefill)
    require(np.array_equal(res1["generated"], res2["generated"]),
            f"the two full-width {JAMBA} runs generated different ids")
    log("phase 7: the two full-width runs generated the same ids")
    del res1, res2
    profile_lm(cfg)
    gc.collect()
    torch.cuda.empty_cache()
    profile_mamba_layer(cfg)
    return counts


# phase 11: the rest of the zoo at full width, bf16, random weights, each
# cut to one card by its layer count (kimi-k2 also by its expert count)
# alone: widths, heads, head dims, vocab and top-k as published. Parameters
# by param_count(): minitron-4b 5.10 B, internvl2-2b 1.89 B, whisper-tiny
# 0.061 B whole; granite-34b 44 of 88 layers 23.9 B; command-r-plus-104b
# 16 of 64 layers 28.3 B; grok-1-314b 5 of 64 layers, all 8 experts,
# 26.2 B; kimi-k2-1t-a32b 4 of 61 layers and 128 of 384 experts, top-8,
# 25.4 B (~48-57 GB in bf16, below jamba's 56.1 GB peak in phase 7)
ZOO_CUTS = {
    "minitron-4b": {},
    "internvl2-2b": {},
    "whisper-tiny": {},
    "granite-34b": dict(num_layers=44),
    "command-r-plus-104b": dict(num_layers=16),
    "grok-1-314b": dict(num_layers=5),
    "kimi-k2-1t-a32b": dict(num_layers=4, num_experts=128),
}
KIMI = "kimi-k2-1t-a32b"
# whisper's prompt: its 448-token text context less the decoded tokens
WHISPER_PROMPT = 448 - LM_GEN


def zoo_flash_launches(cfg, prompt: int) -> int:
    """Flash launches in one prefill of ``cfg`` over ``prompt`` tokens:
    the attention layers whose (query, key) pairs reach the flash branch
    (the vision prefix counted), and whisper's encoder layers, which
    always take it on the card."""
    from repro_torch.models.layers import FLASH_MIN_PAIRS
    S = prompt + (cfg.num_frontend_tokens if cfg.frontend == "vision"
                  else 0)
    n = cfg.num_layers if S * S >= FLASH_MIN_PAIRS else 0
    return n + (cfg.enc_layers if cfg.cross_attention else 0)


def profile_prefill(model, params, prompt: int, extra) -> None:
    """One prefill of ``model`` on ``params`` under ``torch.profiler``:
    wall time, device time by part and by kernel, busy share."""
    cfg = model.cfg
    toks = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (LM_B, prompt)).astype(np.int32)).cuda()
    with torch.inference_mode():
        model.prefill(params, toks, extra, cache_len=prompt + LM_GEN + 1)
        wall_ms, prof = profiled(lambda: model.prefill(
            params, toks, extra, cache_len=prompt + LM_GEN + 1))
    dev_ms, parts, top = device_parts(prof)
    log(f"phase 11: profiled {cfg.name} prefill ({LM_B}x{prompt}): wall "
        f"{wall_ms} ms, device {dev_ms} ms ({100 * dev_ms / wall_ms:.1f}% "
        f"busy under the profiler); by part: {parts}; top: {top}")


def phase11_zoo() -> dict:
    """The seven archs that phases 5-7 do not serve: (b) each reduced
    config card against CPU (kimi-k2 also at its head dim 112); (c) each
    at full width (ZOO_CUTS), weights built once and the prompt served
    twice, the same ids both times; kimi-k2's prefill profiled. Returns
    each full-width model's launches by path (``serve_zoo_<arch>``)."""
    for arch in ZOO_CUTS:
        cfg = get_config(arch).reduced()
        reduced_parity(arch, {"flash_attention": zoo_flash_launches(
            cfg, LM_PROMPT)}, rtol=RTOL_LM)
    reduced_parity(KIMI, {"flash_attention": 2}, rtol=RTOL_LM, head_dim=112)
    paths = {}
    for arch, cut in ZOO_CUTS.items():
        free_weights("phase 11", arch)
        cfg = get_config(arch).replace(**cut)
        prompt = WHISPER_PROMPT if cfg.name == "whisper-tiny" else LM_PROMPT
        flash = {"flash_attention": zoo_flash_launches(cfg, prompt),
                 "rwkv_wkv": 0, "mamba_scan": 0}
        t0 = time.perf_counter()
        model = build_model(cfg)
        params = model.init(torch.Generator(device="cuda").manual_seed(0))
        extra = frontend_inputs(cfg, LM_B, 0, "cuda", model.dtype)
        torch.cuda.synchronize()
        log(f"phase 11: {arch} cut to {cut or 'nothing'}: "
            f"{cfg.param_count()} parameters ({cfg.active_param_count()} "
            f"active a token), {cfg.num_layers} layers, d {cfg.d_model}, "
            f"heads {cfg.num_heads}/{cfg.num_kv_heads} of {cfg.head_dim_}, "
            f"vocab {cfg.vocab_size}; built in "
            f"{time.perf_counter() - t0:.1f} s")
        runs = [lm_run(f"{arch} full width run {i}", cfg, flash,
                       prompt=prompt, params=params, extra=extra)
                for i in (1, 2)]
        require(np.array_equal(runs[0][0]["generated"],
                               runs[1][0]["generated"]),
                f"the two full-width {arch} runs generated different ids")
        log(f"phase 11: {arch}: the two full-width runs generated the same "
            f"ids")
        paths[f"serve_zoo_{arch}"] = runs[0][1]
        if arch == KIMI:
            profile_prefill(model, params, prompt, extra)
        del runs, params, extra, model
    return paths


def train_bank_leaves(n: int, dim: int) -> dict:
    """A bank as numpy leaves: N(0, 0.01²) rows, a fifth of them holding
    1-2 pending gradients of 0.01 N(0, 1), half the rows with a norm
    EMA (tests/test_torch_trainer.py's bank)."""
    rng = np.random.default_rng(0)
    pend = rng.random(n) < 0.2
    gsum = (rng.standard_normal((n, dim)) * 0.01
            * pend[:, None]).astype(np.float32)
    return dict(
        table=(rng.standard_normal((n, dim)) * 0.01).astype(np.float32),
        version=np.zeros(n, np.int32), grad_sum=gsum,
        grad_cnt=np.where(pend, rng.integers(1, 3, n), 0).astype(
            np.float32),
        grad_sqnorm=(np.sum(gsum ** 2, -1) * 1.5).astype(np.float32),
        norm_ema=np.where(rng.random(n) < 0.5, 1e-4, 0.0).astype(
            np.float32),
        step=np.int32(3))


def _one_step(model, params, leaves, batch, device):
    """One ``make_carls_train_step`` step on ``device``: (params, AdamW
    state, bank, metrics, the neighbour gradient pushed to the lazy cache,
    the launches it made)."""
    cc = model.cfg.carls
    opt = AdamW(lr=constant_lr(PARITY_LR))
    st = opt.init(params)
    kb = convert.kb_state_from_numpy(leaves, device=device)
    pushed = []
    base = make_kb_ops(backend="cuda", lazy_lr=cc.lazy_lr,
                       zmax=cc.outlier_zmax, apply_pending=cc.lazy_update)
    kb_ops = base._replace(lazy_grad=lambda kb, ids, g: pushed.append(g)
                           or base.lazy_grad(kb, ids, g))
    step = make_carls_train_step(model, opt, kb_ops=kb_ops)
    tb = {k: torch.from_numpy(v).to(device) for k, v in batch.items()}
    ops.reset_launch_counts()
    params, st, kb, m = step(params, st, kb, tb)
    if device == "cuda":
        torch.cuda.synchronize()
    return params, st, kb, m, pushed[0], ops.launch_counts()


def phase8_reduced_parity(arch: str, want: dict,
                          grad_rtol: float = 0.0) -> dict:
    """The reduced ``arch`` takes one CARLS step on the card and on the CPU
    from one set of parameters, one bank and one batch; everything the
    step produces is compared at the CPU tests' bounds (the gradients of
    rwkv6-7b and jamba, whose card step runs the WKV or scan backward
    kernel, at the CPU tests' atol plus ``grad_rtol`` of the value, as
    tests/test_torch_backward.py holds the plain backwards). ``want``
    gives the launches the card's step must make; returns them."""
    cfg = get_config(arch).reduced()
    model = build_model(cfg)
    p_cpu = model.init(torch.Generator().manual_seed(0))
    p_dev = _to(p_cpu, "cuda")
    leaves = train_bank_leaves(cfg.carls.kb_entries, cfg.d_model)
    corpus = SyntheticGraphCorpus(
        num_nodes=cfg.carls.kb_entries, vocab_size=cfg.vocab_size,
        seq_len=TRAIN_SEQ + 1, neighbors_per_node=cfg.carls.num_neighbors)
    batch = corpus.batch(np.random.default_rng(1), TRAIN_B)
    d = _one_step(model, p_dev, leaves, batch, "cuda")
    c = _one_step(model, p_cpu, leaves, batch, "cpu")
    errs = {}

    def close(a, b, what, atol, rtol=0.0):
        a, b = a.detach().float().cpu(), b.detach().float()
        over = (a - b).abs() - rtol * b.abs() > atol
        require(not bool(over.any()), f"reduced step card vs CPU: {what} "
                f"off at {int(over.sum())} entries")
        errs[what.split(" ")[0]] = max(errs.get(what.split(" ")[0], 0.0),
                                       max_err(a, b))

    require(set(d[3]) == set(c[3]), "metric names differ")
    for k, v in c[3].items():
        if k in ("acc", "tokens", "kb_pending"):
            require(float(d[3][k]) == float(v), f"metric {k} differs")
        else:
            close(d[3][k], v, f"metric {k}", 1e-5, 1e-5)
    close(d[4], c[4], "neighbour_grad", ATOL_GRAD)
    for f in kbm.KBState._fields:
        a, b = getattr(d[2], f), getattr(c[2], f)
        if b.is_floating_point():
            close(a, b, f"bank {f}", ATOL_GRAD)
        else:
            require(torch.equal(a.cpu(), b), f"bank {f} differs")
    require(int(d[1].count) == int(c[1].count) == 1, "counts differ")
    for name in ("mu", "nu"):
        for (k, a), (_, b) in zip(tree_items(getattr(d[1], name)),
                                  tree_items(getattr(c[1], name))):
            close(a, b, f"moments {name} {k}", ATOL_GRAD)
    decided = total = 0
    for (k, pd), (_, pc), (_, md), (_, mc) in zip(
            tree_items(d[0]), tree_items(c[0]), tree_items(d[1].mu),
            tree_items(c[1].mu)):
        g_c = mc / (1 - ADAM_B1)
        close(md / (1 - ADAM_B1), g_c, f"grads {k}", ATOL_GRAD, grad_rtol)
        sure = g_c.abs() > SIGN_T
        err = (pd.cpu() - pc).abs()
        require(float(err[sure].max()) <= ATOL_GRAD if sure.any() else True,
                f"post-step {k} off where the gradient is decided")
        require(float(err.max()) <= 2 * PARITY_LR + ATOL_GRAD,
                f"post-step {k} off by more than two Adam steps")
        errs["params_decided"] = max(errs.get("params_decided", 0.0),
                                     float(err[sure].max())
                                     if sure.any() else 0.0)
        errs["params_other"] = max(errs.get("params_other", 0.0),
                                   float(err[~sure].max())
                                   if (~sure).any() else 0.0)
        decided += int(sure.sum())
        total += sure.numel()
    got = {k: d[5][k] for k in want}
    require(got == want, f"the card's step launched {got}, not {want}")
    log(f"phase 8: reduced {arch} ({cfg.num_layers} layers, d "
        f"{cfg.d_model}, fp32), one CARLS step, batch {TRAIN_B} x seq "
        f"{TRAIN_SEQ}, "
        f"{cfg.carls.kb_entries} x {cfg.d_model} bank: loss card "
        f"{float(d[3]['loss'])} CPU {float(c[3]['loss'])}; card vs CPU max "
        f"abs err {errs}; parameters held at {ATOL_GRAD} on {decided} of "
        f"{total} entries (|grad| > {SIGN_T}); launches on the card {got}")
    return got


# the training step's profiler ranges (repro_torch.core.trainer)
TRAIN_RANGES = ("carls.lookup", "carls.kb_push", "carls.optimizer")
# the AdamW kernel's device kernels (csrc/adamw.cu)
ADAMW_KERNELS = ("adamw_update", "sumsq_partials", "norm_finalize")


def has_train_ranges(prof) -> bool:
    """Whether each of TRAIN_RANGES shows as a device-side annotation."""
    from torch.autograd import DeviceType
    names = {e.name for e in prof.events()
             if e.device_type == DeviceType.CUDA}
    return all(n in names for n in TRAIN_RANGES)


def train_parts(prof, wall_ms: float) -> str:
    """One profiled training step: device time, its split by part (GEMMs,
    the lookup kernel, the optimizer's kernels, the rest) and the busy
    share. The step's ranges (``carls.lookup``, ``carls.kb_push``,
    ``carls.optimizer``) appear on the device as annotations spanning
    their kernels; a part's time is the sum of the kernels that start
    inside its annotations (one stream, so no other kernel runs there).
    The forward and backward are the rest of the step."""
    from torch.autograd import DeviceType
    dev = [e for e in prof.events() if e.device_type == DeviceType.CUDA
           and SPIN not in e.name]
    kernels = [e for e in dev if not e.name.startswith("carls.")]
    dur = {id(e): e.time_range.elapsed_us() / 1e3 for e in kernels}
    total = sum(dur.values())

    def named(pats):
        return sum(dur[id(e)] for e in kernels
                   if any(p in e.name.lower() for p in pats))

    def inside(name):
        spans = [(a.time_range.start, a.time_range.end) for a in dev
                 if a.name == name]
        require(bool(spans), f"no device annotation for {name} in the "
                "profile")
        return sum(dur[id(e)] for e in kernels
                   if any(b <= e.time_range.start < f for b, f in spans))

    gemm = named(dict(PROFILE_PARTS)["GEMMs"])
    lookup = named(("fused_lookup",))
    adamw = named(ADAMW_KERNELS)
    ranges = {n: inside(n) for n in TRAIN_RANGES}
    optim = ranges["carls.optimizer"]
    require(optim + gemm + lookup <= total * (1 + 1e-9),
            f"the profile's parts exceed its device time: {ranges}")
    require(adamw <= optim * (1 + 1e-9), f"the AdamW kernel's launches "
            f"({adamw} ms) lie outside the optimizer's range ({optim} ms)")
    ranges["forward, backward and the rest"] = total - sum(ranges.values())
    top = sorted(prof.key_averages(), key=lambda e: -e.self_device_time_total)
    top = [e for e in top if e.device_type == DeviceType.CUDA
           and not e.key.startswith("carls.") and SPIN not in e.key][:8]
    return (f"wall {wall_ms} ms, device {total} ms "
            f"({100 * total / wall_ms:.1f}% busy under the profiler); by "
            f"part: GEMMs {gemm:.4g} ms, kb_fused_lookup {lookup:.4g} ms, "
            f"the optimizer {optim:.4g} ms (the AdamW kernel's launches "
            f"{adamw:.4g} ms), elementwise and other "
            f"{total - gemm - lookup - optim:.4g} ms; by range: "
            + "; ".join(f"{k} {v:.4g} ms" for k, v in ranges.items())
            + "; top: " + "; ".join(
                f"{e.key[:60]} x{e.count} "
                f"{e.self_device_time_total / 1e3:.4g} ms" for e in top))


def train_run(label: str, cfg, want: dict, batch: int = TRAIN_B,
              seq: int = TRAIN_SEQ, steps: int = TRAIN_STEPS,
              phase: str = "phase 8", must_fall: bool = True):
    """``train_carls`` at phase 8's configuration (or at ``batch`` x
    ``seq``, for ``steps`` steps, the maker pass on the last) with every
    kernel counter set to 0 just before it and read just after; ``want``
    gives the launches the run must make. The loss must be finite and,
    with ``must_fall``, fall."""
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    res = train.train_carls(
        cfg, steps=steps, batch=batch, seq=seq,
        nodes=TRAIN_NODES, lr=TRAIN_LR, maker_every=steps, seed=0,
        device="cuda", log=lambda line: log(f"{phase}: {label}: {line}"))
    counts = ops.launch_counts()
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    losses = res["losses"]
    ms = float(np.mean(res["step_ms"][2:]))
    log(f"{phase}: {label}: {steps} steps at lr {TRAIN_LR}, losses "
        f"{losses}; {ms} ms a step (steps 3-{steps}; each "
        f"{res['step_ms']}); peak device memory {peak} bytes; {wall:.1f} s "
        f"with init; launches {counts}")
    require(bool(np.isfinite(losses).all()), f"{label}: a loss is not "
            f"finite: {losses}")
    if must_fall:
        require(bool(np.mean(losses[-3:]) < losses[0]),
                f"{label}: the loss did not fall: {losses}")
        log(f"{phase}: {label}: the loss fell (mean of the last 3 steps "
            "below the first)")
    got = {k: counts[k] for k in want}
    require(got == want, f"{label}: launches {got}, not {want}")
    res.update(ms=ms, peak=peak)
    return res, counts


# the sequence kernels, forward and backward, none of which the yi-6b step
# at 8 x 64 launches
SEQ_KERNELS = ("flash_attention", "rwkv_wkv", "mamba_scan",
               "flash_attention_bwd", "rwkv_wkv_bwd", "mamba_scan_bwd")
NONE_LAUNCHED = {k: 0 for k in SEQ_KERNELS}
# the reduced jamba's Mamba layers: one group of 7 Mamba and 1 attention
REDUCED_JAMBA_MAMBA = 7
# the WKV kernels' device functions, read from a profiled rwkv6-7b step
WKV_PROFILE = {"rwkv_wkv_bwd": ("wkv_bwd", "du_sum"),
               "rwkv_wkv": ("wkv_kernel",)}


def compare_runs(label: str, losses1, losses2, phase: str = "phase 8"):
    """Two runs from one seed: every step's loss within 1%."""
    rel = [abs(a - b) / abs(b) for a, b in zip(losses2, losses1)]
    require(max(rel) <= 0.01, f"{label}: the two runs' losses differ by "
            f"more than 1%: {losses1} vs {losses2}")
    log(f"{phase}: {label}: the two full-width runs' losses bit-identical: "
        f"{losses1 == losses2}; largest relative gap {max(rel)}")


def kernel_ms(prof, pats) -> float:
    """Device ms of the profiled kernels whose names hold one of
    ``pats``."""
    from torch.autograd import DeviceType
    return sum(e.time_range.elapsed_us() / 1e3 for e in prof.events()
               if e.device_type == DeviceType.CUDA
               and any(p in e.name for p in pats))


def train_twice(label: str, cfg, want: dict, profile_kernels=None,
                **kw):
    """``train_run`` twice from one seed -> (the first run's launches, its
    {"ms": ms a step, "peak": peak device bytes}). With
    ``profile_kernels`` ({label: name patterns}), one more step of the
    first run under ``torch.profiler``: its parts and each named kernel's
    device time and share of the step's."""
    res, counts = train_run(f"{label} run 1", cfg, want, **kw)
    losses1 = res["losses"]
    stats = {"ms": res["ms"], "peak": res["peak"]}
    if profile_kernels:
        wall_ms, prof = profiled(res["loop"].step, need=has_train_ranges)
        log(f"phase 8: {label}: profiled step {TRAIN_STEPS + 1}: "
            f"{train_parts(prof, wall_ms)}")
        total = kernel_ms(prof, ("",)) - kernel_ms(prof, (SPIN, "carls."))
        log(f"phase 8: {label}: profiled step {TRAIN_STEPS + 1}, device "
            "time by kernel: " + "; ".join(
                f"{k} {kernel_ms(prof, pats):.4g} ms "
                f"({100 * kernel_ms(prof, pats) / total:.2f}% of {total:.4g})"
                for k, pats in profile_kernels.items()))
        del prof
    del res
    gc.collect()
    res, _ = train_run(f"{label} run 2", cfg, want, **kw)
    losses2 = res["losses"]
    del res
    gc.collect()
    compare_runs(label, losses1, losses2)
    return counts, stats


def phase8_jamba_layer() -> dict:
    """One full-width jamba Mamba layer (JAMBA_CUT's widths, bf16) forward
    and backward on a prefill's input (B 4, S 2048), with gradients on y
    and on the final state: through the scan kernels (the Function), then
    through the plain scan, both on the card; every gradient (x and each
    parameter) within LAYER_REL of the plain one's norm. Returns the
    launches of the kernel run."""
    from repro_torch.models import ssm
    cfg = get_config(JAMBA).replace(**JAMBA_CUT)
    dev = torch.device("cuda")
    params = ssm.mamba_init(torch.Generator(device=dev).manual_seed(0), cfg)
    g = torch.Generator(device=dev).manual_seed(1)
    x = torch.randn((LM_B, LM_PROMPT, cfg.d_model), generator=g,
                    device=dev).to(torch.bfloat16)
    cot = torch.randn(x.shape, generator=g, device=dev).to(torch.bfloat16)
    di = cfg.ssm_expand * cfg.d_model
    cot_h = torch.randn((LM_B, di, cfg.ssm_state_dim), generator=g,
                        device=dev)

    def grads() -> dict:
        leaves = {k: v.detach().clone().requires_grad_()
                  for k, v in params.items()}
        xl = x.clone().requires_grad_()
        y, st = ssm.mamba_apply_state(leaves, xl, cfg)
        ((y.float() * cot.float()).sum() + (st["h"] * cot_h).sum()
         ).backward()
        out = {"x": xl.grad, **{k: v.grad for k, v in leaves.items()}}
        torch.cuda.synchronize()
        return out

    grads()                                      # a warm-up
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    got = grads()
    ms = (time.perf_counter() - t0) * 1e3
    counts = ops.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    want = {**NONE_LAUNCHED, "mamba_scan": 1, "mamba_scan_bwd": 1}
    require({k: counts[k] for k in want} == want,
            f"the jamba layer's kernel run launched {counts}")
    kernel_scan = ops.mamba_scan
    ops.mamba_scan = ref.mamba_scan_ref          # the plain scan
    t0 = time.perf_counter()
    plain = grads()
    plain_ms = (time.perf_counter() - t0) * 1e3
    ops.mamba_scan = kernel_scan
    errs = {}
    for k, gk in got.items():
        gp = plain[k].float()
        rel = float((gk.float() - gp).norm() / gp.norm().clamp_min(1e-30))
        require(bool(torch.isfinite(gk).all()) and rel <= LAYER_REL,
                f"the jamba layer's gradient of {k} is off the plain "
                f"scan's by {rel} of its norm")
        errs[k] = (rel, max_err(gk.float(), gp))
    log(f"phase 8: one {JAMBA} Mamba layer at full width (d {cfg.d_model}, "
        f"di {di}, ds {cfg.ssm_state_dim}, bf16), forward and backward at "
        f"{LM_B} x {LM_PROMPT}: {ms} ms through the kernels, {plain_ms} ms "
        f"through the plain scan; peak device memory {peak} bytes (the "
        f"kernel run); gradients against the plain scan's (relative norm "
        f"error, max abs error): {errs}; launches {counts}")
    return counts


def phase8_train() -> dict:
    """The trainer: the reduced yi-6b, rwkv6-7b and jamba steps card
    against CPU; then, jamba's weights freed, ``train_carls`` at full
    width twice (yi-6b, 16 layers, 8 x 64) and one step profiled; then
    rwkv6-7b at full width cut to 12 layers, 8 x 64, twice; yi-6b's 16
    layers at 2 x 2048, twice; and one full-width jamba Mamba layer
    forward and backward. Returns the launches of each path."""
    paths = {}
    phase8_reduced_parity("yi-6b", {**NONE_LAUNCHED, "kb_fused_lookup": 1,
                                    "adamw": 1})
    phase8_reduced_parity("rwkv6-7b", {**NONE_LAUNCHED, "kb_fused_lookup": 1,
                                       "adamw": 1, "rwkv_wkv": 2,
                                       "rwkv_wkv_bwd": 2},
                          grad_rtol=RTOL_GRAD)
    phase8_reduced_parity(JAMBA, {**NONE_LAUNCHED, "kb_fused_lookup": 1,
                                  "adamw": 1,
                                  "mamba_scan": REDUCED_JAMBA_MAMBA,
                                  "mamba_scan_bwd": REDUCED_JAMBA_MAMBA},
                          grad_rtol=RTOL_GRAD)
    free_weights("phase 8", "yi-6b training")
    cfg = get_config("yi-6b").replace(num_layers=TRAIN_LAYERS)
    log(f"phase 8: yi-6b cut to {TRAIN_LAYERS} of 32 layers: "
        f"{cfg.param_count()} parameters")
    # one launch of the AdamW kernel a step
    want = {**NONE_LAUNCHED, "kb_fused_lookup": TRAIN_STEPS,
            "adamw": TRAIN_STEPS}
    res, paths["train"] = train_run("yi-6b full width run 1", cfg, want)
    losses1 = res["losses"]
    wall_ms, prof = profiled(res["loop"].step, need=has_train_ranges)
    log(f"phase 8: profiled step {TRAIN_STEPS + 1}: "
        f"{train_parts(prof, wall_ms)}")
    del res, prof
    gc.collect()
    res, _ = train_run("yi-6b full width run 2", cfg, want)
    losses2 = res["losses"]
    del res
    gc.collect()
    compare_runs("yi-6b", losses1, losses2)
    # rwkv6-7b: WKV forward and backward in each of the 12 layers a step,
    # and the forward again in the maker pass on the last step
    free_weights("phase 8", "rwkv6-7b training")
    cfg = get_config("rwkv6-7b").replace(num_layers=TRAIN_RWKV_LAYERS)
    log(f"phase 8: rwkv6-7b cut to {TRAIN_RWKV_LAYERS} of 32 layers: "
        f"{cfg.param_count()} parameters")
    n = TRAIN_RWKV_LAYERS
    # the config's remat: each layer's WKV forward runs again in the
    # backward's recompute, so 2 a layer a step, and the maker pass's
    rwkv_want = {**NONE_LAUNCHED, "kb_fused_lookup": TRAIN_STEPS,
                 "adamw": TRAIN_STEPS,
                 "rwkv_wkv": (2 * TRAIN_STEPS + 1) * n,
                 "rwkv_wkv_bwd": TRAIN_STEPS * n}
    paths["train_rwkv"] = train_twice("rwkv6-7b full width", cfg, rwkv_want,
                                      profile_kernels=WKV_PROFILE)[0]
    # the same at 2 x 2048, where the WKV backward runs at the prefill's
    # sequence length
    free_weights("phase 8", f"rwkv6-7b training at seq {TRAIN_LONG_SEQ}")
    paths["train_rwkv_2048"] = train_twice(
        f"rwkv6-7b at {TRAIN_LONG_B} x {TRAIN_LONG_SEQ}", cfg, rwkv_want,
        profile_kernels=WKV_PROFILE, batch=TRAIN_LONG_B,
        seq=TRAIN_LONG_SEQ)[0]
    # yi-6b at 2 x 2048: flash forward and backward in each layer a step,
    # the forward again in the recompute; then once without remat
    free_weights("phase 8", "yi-6b training at seq 2048")
    cfg = get_config("yi-6b").replace(num_layers=TRAIN_LAYERS)
    n = TRAIN_LAYERS
    long = dict(batch=TRAIN_LONG_B, seq=TRAIN_LONG_SEQ)
    label = f"yi-6b at {TRAIN_LONG_B} x {TRAIN_LONG_SEQ}"
    paths["train_yi_2048"], remat = train_twice(
        label, cfg, {**NONE_LAUNCHED, "kb_fused_lookup": TRAIN_STEPS,
                     "adamw": TRAIN_STEPS,
                     "flash_attention": (2 * TRAIN_STEPS + 1) * n,
                     "flash_attention_bwd": TRAIN_STEPS * n}, **long)
    free_weights("phase 8", "yi-6b training at seq 2048 without remat")
    res, _ = train_run(
        f"{label} without remat", cfg.replace(remat=False),
        {**NONE_LAUNCHED, "kb_fused_lookup": TRAIN_STEPS,
         "adamw": TRAIN_STEPS, "flash_attention": (TRAIN_STEPS + 1) * n,
         "flash_attention_bwd": TRAIN_STEPS * n}, **long)
    log(f"phase 8: {label}, remat (policy {cfg.remat_policy}) against "
        f"none: {remat['ms']} against {res['ms']} ms a step "
        f"({100 * (remat['ms'] / res['ms'] - 1):.1f}% more), peak "
        f"{remat['peak']} against {res['peak']} bytes "
        f"({res['peak'] - remat['peak']} fewer)")
    del res
    gc.collect()
    free_weights("phase 8", "the jamba Mamba layer")
    paths["train_jamba_layer"] = phase8_jamba_layer()
    return paths


# phase 12: the seven archs that phase 8 does not train, at full width,
# cut in depth only as far as one card forces (param_count(): minitron
# whole 5.10 B parameters, granite 5 of 88 layers 3.25 B, command-r 1 of
# 64 3.15 B of it the tied 256k x 12288 embedding, 4.72 B in all, grok 1
# of 64 and 4 of its 8 experts 4.12 B, kimi 2 of 61 and 16 of its 384
# experts with top-8 kept 3.99 B, internvl whole 1.89 B, whisper whole
# 0.06 B), bf16 parameters and fp32 AdamW moments (12 bytes a parameter
# before activations): {arch: (cut, batch, seq)}. whisper's seq is its
# 448-token context less 16, as phase 11 serves it, at a batch of 8.
ZOO_TRAIN = {
    "minitron-4b": ({}, 2, 2048),
    "granite-34b": (dict(num_layers=5), 2, 2048),
    "command-r-plus-104b": (dict(num_layers=1), 2, 2048),
    "grok-1-314b": (dict(num_layers=1, num_experts=4), 2, 2048),
    "kimi-k2-1t-a32b": (dict(num_layers=2, num_experts=16), 2, 2048),
    "internvl2-2b": ({}, 2, 2048),
    "whisper-tiny": ({}, 8, WHISPER_PROMPT),
}
ZOO_TRAIN_STEPS = 6
# the archs whose flash backward runs a variant no other training run
# takes (kimi-k2's d 112, grok-1's soft cap): trained twice from one seed
ZOO_TRAIN_TWICE = ("grok-1-314b", "kimi-k2-1t-a32b")


def zoo_train_want(cfg, seq: int, steps: int, maker: bool) -> dict:
    """The exact launches of ``steps`` training steps of ``cfg`` at
    ``seq`` tokens: a lookup and an AdamW update a step; each decoder
    attention layer whose (query, key) pairs reach the flash branch (the
    vision prefix counted) launches flash forward once and, under remat,
    again in the backward's recompute, and its backward once; whisper's
    encoder layers, outside the checkpointed groups, flash forward and
    backward once a step; the maker pass on the last step, ``maker``, a
    forward of the decoder layers."""
    n = zoo_flash_launches(cfg, seq) - (cfg.enc_layers
                                        if cfg.cross_attention else 0)
    enc = cfg.enc_layers if cfg.cross_attention else 0
    fwd = (2 if cfg.remat else 1) * n + enc
    return {**NONE_LAUNCHED, "kb_fused_lookup": steps, "adamw": steps,
            "flash_attention": steps * fwd + (n if maker else 0),
            "flash_attention_bwd": steps * (n + enc)}


def frontend_train_run(label: str, cfg, want: dict, batch: int, seq: int,
                       steps: int):
    """``make_carls_train_step`` on ``cfg`` (internvl2-2b, whisper-tiny)
    as ``train_carls`` runs the text archs (random bf16 weights from seed
    0, AdamW at TRAIN_LR with weight decay 0.01, a TRAIN_NODES x d_model
    bank of N(0, 0.01²) rows, the corpus's batches), each batch carrying
    the front-end's input, N(0, 1) from numpy (internvl's 256 patch
    embeddings, whisper's 1,500 frames); no maker pass (the embedding
    maker reads tokens alone, as JAX's). Kernel counters set to 0 just
    before and read just after; ``want`` gives the launches. Returns
    ({"losses", "step_ms", "ms", "peak"}, counts)."""
    dev = torch.device("cuda")
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    cfg = cfg.replace(carls=cfg.carls.__class__(
        **{**cfg.carls.__dict__, "kb_entries": TRAIN_NODES}))
    model = build_model(cfg)
    params = model.init(torch.Generator(device=dev).manual_seed(0))
    opt = AdamW(lr=warmup_cosine(TRAIN_LR, steps // 10, steps),
                weight_decay=0.01)
    st = opt.init(params)
    kb = kbm.kb_create(TRAIN_NODES, cfg.d_model, device=dev,
                       generator=torch.Generator(device=dev).manual_seed(1))
    corpus = SyntheticGraphCorpus(
        num_nodes=TRAIN_NODES, vocab_size=cfg.vocab_size, seq_len=seq + 1,
        neighbors_per_node=cfg.carls.num_neighbors)
    step = make_carls_train_step(model, opt)
    rng = np.random.default_rng(1)
    losses, step_ms = [], []
    for i in range(steps):
        tb = {k: torch.from_numpy(v).to(dev)
              for k, v in corpus.batch(rng, batch).items()}
        tb.update(frontend_inputs(cfg, batch, 100 + i, dev, torch.float32))
        torch.cuda.synchronize()
        ts = time.perf_counter()
        params, st, kb, m = step(params, st, kb, tb)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - ts) * 1e3)
        losses.append(float(m["loss"]))
    counts = ops.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    ms = float(np.mean(step_ms[2:]))
    log(f"phase 12: {label}: {steps} steps at lr {TRAIN_LR}, losses "
        f"{losses}; {ms} ms a step (steps 3-{steps}; each {step_ms}); "
        f"peak device memory {peak} bytes; "
        f"{time.perf_counter() - t0:.1f} s with init; launches {counts}")
    require(bool(np.isfinite(losses).all()), f"{label}: a loss is not "
            f"finite: {losses}")
    got = {k: counts[k] for k in want}
    require(got == want, f"{label}: launches {got}, not {want}")
    del params, st, kb, m, tb
    return {"losses": losses, "step_ms": step_ms, "ms": ms,
            "peak": peak}, counts


def phase12_zoo_train() -> dict:
    """The seven archs of ZOO_TRAIN train at full width, cut in depth:
    the text archs through ``train_carls`` (the maker pass on the last
    step), internvl2-2b and whisper-tiny through ``make_carls_train_step``
    with their front-end inputs in each batch; ZOO_TRAIN_STEPS steps each
    at the config's remat, with their exact launches, ms a step and peak
    memory; ZOO_TRAIN_TWICE's archs twice from one seed, the losses
    within 1%. Returns each run's launches (``train_zoo_<arch>``)."""
    paths = {}
    for arch, (cut, batch, seq) in ZOO_TRAIN.items():
        free_weights("phase 12", f"{arch} training")
        cfg = get_config(arch).replace(**cut)
        text = cfg.frontend == "none"
        want = zoo_train_want(cfg, seq, ZOO_TRAIN_STEPS, maker=text)
        log(f"phase 12: {arch} cut to {cut or 'nothing'}: "
            f"{cfg.param_count()} parameters, {cfg.num_layers} layers, d "
            f"{cfg.d_model}, heads {cfg.num_heads}/{cfg.num_kv_heads} of "
            f"{cfg.head_dim_}, remat {cfg.remat} ({cfg.remat_policy}), "
            f"batch {batch} x seq {seq}; launches a run must be {want}")
        runs = []
        for i in range(2 if arch in ZOO_TRAIN_TWICE else 1):
            label = f"{arch} full width run {i + 1}"
            if text:
                res, counts = train_run(label, cfg, want, batch=batch,
                                        seq=seq, steps=ZOO_TRAIN_STEPS,
                                        phase="phase 12", must_fall=False)
                del res["loop"]
            else:
                res, counts = frontend_train_run(label, cfg, want, batch,
                                                 seq, ZOO_TRAIN_STEPS)
            runs.append(res)
            gc.collect()
            if i == 0:
                paths[f"train_zoo_{arch}"] = counts
                per_step = {k: v / ZOO_TRAIN_STEPS for k, v in want.items()
                            if v}
                log(f"phase 12: {arch}: {res['ms']} ms a step, peak "
                    f"{res['peak']} bytes; launches a step {per_step}")
        if len(runs) == 2:
            compare_runs(arch, runs[0]["losses"], runs[1]["losses"],
                         phase="phase 12")
        del runs
    return paths


def phase9_quickstart() -> dict:
    """(a) examples/quickstart.py's run on the card, its lines and its
    three trends; returns the run's launch counts."""
    cfg = get_config("yi-6b").reduced().replace(num_layers=2)
    corpus = SyntheticGraphCorpus(
        num_nodes=QS_NODES, vocab_size=cfg.vocab_size, seq_len=QS_SEQ,
        num_clusters=QS_CLUSTERS, neighbors_per_node=cfg.carls.num_neighbors)
    ops.reset_launch_counts()
    res = run_async_training(build_model(cfg), corpus, steps=QS_STEPS,
                             batch_size=QS_B, num_makers=QS_MAKERS,
                             maker_batch=QS_MAKER_B, ckpt_period=QS_CKPT,
                             lr=QS_LR, seed=0, kb_backend="cuda",
                             device="cuda")
    counts = ops.launch_counts()
    loss0, loss1 = res.losses[0], float(np.mean(res.losses[-5:]))
    reg0, reg1 = res.reg_losses[0], float(np.mean(res.reg_losses[-5:]))
    m = res.server.metrics
    tbl = res.server.table_snapshot()
    same = np.einsum("id,id->i", tbl[corpus.neighbor_table[:, 0]], tbl)
    rng = np.random.default_rng(0)
    rand = np.einsum("id,id->i", tbl[rng.integers(0, corpus.num_nodes,
                                                  corpus.num_nodes)], tbl)
    for line in (
            f"loss: {loss0:.4f} -> {loss1:.4f}",
            f"graph-reg: {reg0:.4f} -> {reg1:.4f}",
            f"maker refreshes (concurrent with training): "
            f"{res.maker_refreshes}",
            f"mean embedding staleness (trainer steps): "
            f"{res.mean_staleness:.2f}",
            f"mean trainer step: {np.mean(res.step_times[2:]) * 1e3:.1f} ms",
            f"kb server: {m['requests']} requests -> {m['dispatches']} "
            f"device dispatches (coalescing "
            f"x{res.server.coalescing_factor:.1f}, longest merged run "
            f"{m['max_run']})",
            f"avg similarity to graph neighbor: {same.mean():.4f}  "
            f"to random node: {rand.mean():.4f}",
            f"launches {counts}"):
        log(f"phase 9: quickstart: {line}")
    require(loss1 < loss0 - 0.5, f"quickstart: the loss did not fall "
            f"(~6.4 -> ~5.3): {loss0} -> {loss1}")
    require(reg1 < 0.1, f"quickstart: graph-reg ends at {reg1}, not < 0.1")
    require(same.mean() > 2 * rand.mean() and same.mean() - rand.mean() > 0.3,
            f"quickstart: neighbour similarity {same.mean()} not well above "
            f"random {rand.mean()}")
    require(all(s["maker_steps"] > 0 and s["errors"] == 0
                for s in res.maker_stats.values()),
            f"quickstart: a maker failed or never stepped: {res.maker_stats}")
    require(counts["kb_fused_lookup"] > 0, f"quickstart: no lookup kernel: "
            f"{counts}")
    return counts


def contention_parts(prof, steps: int) -> str:
    """Whose device work a contended triangle's steps 3-``steps`` held.
    Every thread launches on the default stream, so the kernels run one
    at a time and their durations sum to the device's busy time. The
    profiler records the host ops of the thread that started it, the
    trainer's, and of autograd's thread, which runs the trainer's
    backward: the kernels tied to those ops are the trainer's, split by
    the innermost trainer range (``carls.*``) around their op. The rest
    of the busy time is the other threads', the makers' and the server
    dispatcher's, split by kernel name (the search and lookup kernels,
    then PROFILE_PARTS). The window runs
    from the third train core's start to the last one's end (a sync), by
    the host's clock."""
    from torch.autograd import DeviceType
    ev = prof.events()
    cpu = [e for e in ev if e.device_type == DeviceType.CPU
           and not e.is_async]
    ranges = sorted((e.time_range.start, e.time_range.end, e.name)
                    for e in cpu if e.name.startswith("carls."))
    cores = [(a, b) for a, b, n in ranges if n == "carls.train_core"]
    require(len(cores) == steps, f"the profile holds {len(cores)} train "
            f"cores, not {steps}")
    lo, hi = cores[2][0], cores[-1][1]
    starts = [a for a, _, _ in ranges]
    main = {e.thread for e in cpu if e.name == "carls.train_core"}

    def innermost(t0):
        """The latest-starting trainer range still open at ``t0`` (the
        ranges nest), or None."""
        i = bisect.bisect_right(starts, t0) - 1
        while i >= 0 and ranges[i][1] <= t0:
            i -= 1
        return ranges[i][2] if i >= 0 else None

    mine, mine_by_name = {}, {}
    for e in cpu:
        if not e.kernels or not lo <= e.time_range.start < hi:
            continue
        who = ((innermost(e.time_range.start) or "trainer, outside its "
                "ranges") if e.thread in main
               else "backward (autograd's thread)")
        for k in e.kernels:
            mine[who] = mine.get(who, 0.0) + k.duration / 1e3
            mine_by_name[k.name] = mine_by_name.get(k.name, 0.0) \
                + k.duration / 1e3
    all_by_name = {}
    for e in ev:
        if e.device_type == DeviceType.CUDA and lo <= e.time_range.start < hi \
                and not e.name.startswith("carls."):
            all_by_name[e.name] = all_by_name.get(e.name, 0.0) \
                + e.time_range.elapsed_us() / 1e3
    busy = sum(all_by_name.values())
    others = {}
    parts = (("searches and lookups", ("nn_search", "fused_lookup")),
             *PROFILE_PARTS)
    for name, v in all_by_name.items():
        rest = v - mine_by_name.get(name, 0.0)
        part = next((p for p, pats in parts
                     if any(x in name.lower() for x in pats)),
                    "elementwise and other")
        others[part] = others.get(part, 0.0) + rest
    wall, n, trainer = (hi - lo) / 1e3, steps - 2, sum(mine.values())

    def listed(d):
        return "; ".join(f"{k} {v / n:.6g}" for k, v in
                         sorted(d.items(), key=lambda kv: -kv[1]))
    return (f"steps 3-{steps}: wall {wall / n} ms a step, device busy "
            f"{busy / n} ms a step ({100 * busy / wall:.1f}%): the "
            f"trainer's kernels {trainer / n} ms, the makers' and the "
            f"server's {(busy - trainer) / n} ms; the trainer's by range "
            f"(ms a step): {listed(mine)}; the others' by kernel (ms a "
            f"step): {listed(others)}")


def triangle_run(label: str, cfg, use_makers: bool, period: float = 0.0,
                 steps: int = ASYNC_STEPS, profile: bool = False):
    """(b) run_async_training at full width for ``steps`` steps, the
    makers paced by ``period`` seconds, every kernel counter set to 0 just
    before it and read just after; with ``profile``, under
    ``torch.profiler``, its contention read by ``contention_parts``. With
    makers, each of the four kinds must step and none may fail."""
    corpus = SyntheticGraphCorpus(
        num_nodes=TRAIN_NODES, vocab_size=cfg.vocab_size,
        seq_len=TRAIN_SEQ + 1, neighbors_per_node=cfg.carls.num_neighbors,
        num_clusters=4, labeled_frac=0.3, label_noise=0.3, seed=0)
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    out = {}

    def run():
        out["res"] = run_async_training(
            build_model(cfg), corpus, steps=steps, batch_size=TRAIN_B,
            makers=list(MakerRuntime.MAKER_KINDS) if use_makers else None,
            use_makers=use_makers, maker_batch=ASYNC_MAKER_B,
            maker_period_s=period, ckpt_period=ASYNC_CKPT, lr=TRAIN_LR,
            trainer_push=True, kb_backend="cuda", seed=0, device="cuda")
    prof = profiled(run)[1] if profile else run()
    res = out.pop("res")
    counts = ops.launch_counts()
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    core = float(np.median(res.step_times[2:]) * 1e3)
    loop = float(np.median(res.loop_times[2:]) * 1e3)
    m = res.server.metrics
    log(f"phase 9: {label}: {steps} steps, losses {res.losses}; "
        f"ms a step (median of steps 3-{steps}): train core {core}, "
        f"whole loop step {loop}; each core "
        f"{[round(t * 1e3, 3) for t in res.step_times]} ms; peak device "
        f"memory {peak} bytes; kb server {m['requests']} requests -> "
        f"{m['dispatches']} dispatches (coalescing "
        f"x{res.server.coalescing_factor:.2f}); {wall:.1f} s with init; "
        f"launches {counts}")
    for line in format_maker_stats(res.maker_stats):
        log(f"phase 9: {label}: {line}")
    require(bool(np.isfinite(res.losses).all()), f"{label}: a loss is not "
            f"finite: {res.losses}")
    if use_makers:
        st = res.maker_stats
        require(sorted(s["kind"] for s in st.values())
                == sorted(MakerRuntime.MAKER_KINDS)
                and all(s["maker_steps"] > 0 and s["errors"] == 0
                        for s in st.values()),
                f"{label}: a maker kind is missing, never stepped or "
                f"failed: {st}")
    if profile:
        log(f"phase 9: {label}: under torch.profiler, "
            f"{contention_parts(prof, steps)}")
        del prof
    out = dict(counts=counts, core_ms=core, loop_ms=loop, peak=peak,
               losses=res.losses)
    del res
    gc.collect()
    return out


def phase9_triangle() -> dict:
    """(b) the full-width triangle, with the makers unpaced (the
    launcher's default) and without them, then with them paced at
    SERVE_MAKER_PERIOD s; returns the first run's launch counts."""
    free_weights("phase 9", "yi-6b async training")
    cfg = get_config("yi-6b").replace(num_layers=TRAIN_LAYERS)
    with_m = triangle_run("yi-6b full width with all four makers", cfg, True)
    without = triangle_run("yi-6b full width without makers", cfg, False)
    paced = triangle_run(f"yi-6b full width with all four makers paced at "
                         f"{SERVE_MAKER_PERIOD} s", cfg, True,
                         SERVE_MAKER_PERIOD)
    triangle_run("yi-6b full width with all four makers, profiled", cfg,
                 True, steps=ASYNC_PROFILE_STEPS, profile=True)
    TRIANGLE_MS.update({
        "with makers": (with_m["core_ms"], with_m["loop_ms"]),
        "without": (without["core_ms"], without["loop_ms"]),
        "paced makers": (paced["core_ms"], paced["loop_ms"])})
    c = with_m["counts"]
    require(c["kb_fused_lookup"] > 0 and c["nn_search"] > 0,
            f"the triangle did not reach both kernels at width "
            f"{cfg.d_model}: {c}")
    log(f"phase 9: ms a step with makers / without: train core "
        f"{with_m['core_ms']} / {without['core_ms']}, whole loop step "
        f"{with_m['loop_ms']} / {without['loop_ms']}; peak device memory "
        f"{with_m['peak']} / {without['peak']} bytes; losses equal: "
        f"{with_m['losses'] == without['losses']}; paced makers: train "
        f"core {paced['core_ms']}, loop step {paced['loop_ms']}, peak "
        f"{paced['peak']} bytes")
    return c


def phase9_serve_makers() -> dict:
    """(c) phase 4's fp32 exact serve with the graph builder beside it."""
    res, counts = serve_run("fp32 exact with --kb-makers graph_builder",
                            ["--kb-makers", "graph_builder"], SERVE_ROUNDS)
    st = res["maker_stats"]["graph_builder0"]
    log(f"phase 9: serve with a maker: {st}")
    require(st["rows_written"] > 0 and st["errors"] == 0,
            f"the serving bank's graph builder wrote nothing: {st}")
    require(counts["nn_search"] > 0, f"serve with a maker: {counts}")
    return counts


def phase9_makers() -> dict:
    """Phase 9: the makers and their runtime; returns the launch counts of
    its three paths."""
    paths = {"quickstart": phase9_quickstart()}
    paths["train_async"] = phase9_triangle()
    paths["serve_makers"] = phase9_serve_makers()
    return paths


# ---------------------------------------------------------------------------
# phase 10: the wire protocol v4 and the fleet, each bank, member, worker
# and trainer a process of its own on the card
# ---------------------------------------------------------------------------

WIRE_SEED = 7
WIRE_ROUNDS = 8                     # rounds of the bit-compared op stream
WIRE_BOOT_S = 300.0                 # a child's fill, kernel load, warm-up
WIRE_TRAIN_S = 900.0                # the trainer child's whole run
WIRE_WRITES, WIRE_KILL_AT = 24, 12  # writes streamed; acked before SIGKILL
DEVICE_BYTES = 80e9                 # the card's memory, for the summed peak
WIRE_KERNELS = ("kb_fused_lookup", "lazy_apply", "nn_search")
CHILD_ENV = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
# the trainer child: the train launcher's async mode (``run_async``) on
# its parser's arguments and phase 8's full-width config (the launcher's
# own config is always the reduced one), then its run's numbers as one
# JSON line
WIRE_TRAINER = (
    "import json, sys, torch\n"
    "from repro_torch.configs import get_config\n"
    "from repro_torch.env import resolve_device\n"
    "from repro_torch.kernels import ops\n"
    "from repro_torch.launch import train\n"
    "args = train.build_parser().parse_args(sys.argv[1:])\n"
    "cfg = get_config(args.arch).replace(num_layers=args.layers)\n"
    "out = train.run_async(cfg, args, resolve_device(args.device))\n"
    "res = out['result']\n"
    "print('wire trainer: ' + json.dumps({\n"
    "    'losses': res.losses,\n"
    "    'core_ms': [t * 1e3 for t in res.step_times],\n"
    "    'loop_ms': [t * 1e3 for t in res.loop_times],\n"
    "    'launches': ops.launch_counts(), 'seconds': out['seconds'],\n"
    "    'peak': torch.cuda.max_memory_allocated()}), flush=True)\n")
TRIANGLE_MS = {}                    # phase 9's in-process triangle
CHILDREN = []


class Child:
    """A launcher run as a process of its own (``python`` with ``argv``
    from the checkout's root), its output drained by a thread; the port
    of its "listening on" line is read as it comes."""

    def __init__(self, name: str, argv):
        self.name, self.port, self.lines = name, None, []
        self.listening = threading.Event()
        self.proc = subprocess.Popen(
            [sys.executable, *argv], cwd=ROOT, env=CHILD_ENV,
            stdin=subprocess.DEVNULL, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True)
        CHILDREN.append(self)
        self.reader = threading.Thread(target=self._read, daemon=True)
        self.reader.start()

    def _read(self):
        for line in self.proc.stdout:
            self.lines.append(line)
            m = re.search(r"listening on 127\.0\.0\.1:(\d+)", line)
            if m and self.port is None:
                self.port = int(m.group(1))
                self.listening.set()
        self.listening.set()                # EOF: it will never listen

    def wait_port(self) -> int:
        self.listening.wait(WIRE_BOOT_S)
        require(self.port is not None, f"{self.name} did not listen within "
                f"{WIRE_BOOT_S} s (exit {self.proc.poll()}):\n"
                + "".join(self.lines[-40:]))
        return self.port

    def wait(self, timeout: float) -> int:
        try:
            self.proc.wait(timeout)
        except subprocess.TimeoutExpired:
            self.proc.kill()
            self.proc.wait(30)
            require(False, f"{self.name} ran past {timeout} s:\n"
                    + "".join(self.lines[-40:]))
        self.reader.join(30)
        return self.proc.returncode

    def stop(self, sig=signal.SIGTERM, timeout: float = 120.0) -> int:
        if self.proc.poll() is None:
            self.proc.send_signal(sig)
        return self.wait(timeout)

    def output(self) -> str:
        return "".join(self.lines)

    def log_output(self) -> None:
        for line in self.lines:
            log(f"phase 10: [{self.name}] {line.rstrip()}")


def stop_children() -> None:
    """Kill every child still running (a failed check's way out)."""
    for c in CHILDREN:
        if c.proc.poll() is None:
            c.proc.kill()
            c.proc.wait(30)
    CHILDREN.clear()


def serve_child(name: str, *extra, rows: int = None,
                dim: int = None) -> Child:
    """``repro_torch.launch.serve --kb --listen 127.0.0.1:0`` on the card
    (seed 0, the 8 x 4 drive's warm-up) of ``rows`` x ``dim`` (phase 4's
    bank by default), ``extra`` appended."""
    return Child(name, ["-m", "repro_torch.launch.serve", "--kb",
                        "--kb-entries", str(rows or N_ROWS), "--kb-dim",
                        str(dim or DIM), "--listen", "127.0.0.1:0",
                        "--clients", "8", "--batch", "4", *extra])


def monitor(port: int):
    """A client of its own to one process's bank, to read its stats."""
    return RemoteKnowledgeBank("127.0.0.1", port, max_retries=0,
                               connect_timeout_s=30.0)


def device_stats(client) -> dict:
    return client.stats()["device"]


def launches_since(before: dict, after: dict) -> dict:
    return {k: after["launches"][k] - before["launches"][k]
            for k in after["launches"]}


def launched(counts: dict) -> dict:
    """The kernels that launched, for the log."""
    return {k: v for k, v in counts.items() if v}


def require_launched(label: str, counts: dict, kernels) -> None:
    missing = [k for k in kernels if counts[k] <= 0]
    require(not missing, f"{label}: {missing} never launched in its "
            f"process: {counts}")


def inprocess_bank() -> KnowledgeBankServer:
    """The serve launcher's bank in this process: the same seed, fill and
    warm-up, so its state equals a serving child's bit for bit."""
    srv = KnowledgeBankServer(N_ROWS, DIM, device="cuda")
    fill = np.random.default_rng(0).standard_normal((N_ROWS, DIM),
                                                    dtype=np.float32)
    srv.update(np.arange(N_ROWS), fill)
    del fill
    srv.warmup(BATCH)
    return srv


def wire_stream(client):
    """One fixed op stream over ``client``: lookups, lazy gradients,
    updates, searches with and without exclusion, a flush and a lookup of
    every touched row. Returns (every result in order, the touched
    ids)."""
    rng = np.random.default_rng(WIRE_SEED)
    out, touched = [], []
    for r in range(WIRE_ROUNDS):
        ids = rng.integers(0, N_ROWS, BATCH)
        out.append(client.lookup(ids, trainer_step=r))
        client.lazy_grad(ids, 0.01 * rng.standard_normal((BATCH, DIM),
                                                         dtype=np.float32))
        up = rng.integers(0, N_ROWS, 8)
        client.update(up, rng.standard_normal((8, DIM), dtype=np.float32),
                      src_step=r)
        out.append(client.lookup(ids[:8], trainer_step=r))
        q = rng.standard_normal((BATCH, DIM), dtype=np.float32)
        out.extend(client.nn_search(q, K))
        out.extend(client.nn_search(q[:8], K, exclude_ids=ids[:8, None]))
        touched += [ids, up]
    client.flush()
    touched = np.unique(np.concatenate(touched))
    out.append(client.lookup(touched))
    return out, touched


def require_bit_identical(label: str, got, want) -> None:
    bad = [i for i, (a, b) in enumerate(zip(got, want))
           if a.dtype != b.dtype or a.shape != b.shape
           or not np.array_equal(a, b)]
    require(len(got) == len(want) and not bad, f"{label}: results "
            f"{bad} of {len(want)} differ from the single server's")


def wire_drive(clients, rounds: int) -> float:
    """The serve launcher's drive over ``clients`` (one a thread, 8
    threads x batch 4: lookup -> lazy_grad -> nn_search); returns
    req/s."""
    def run(t: int, c):
        crng = np.random.default_rng(1 + t)
        for _ in range(rounds):
            ids = crng.integers(0, N_ROWS, 4)
            vals = c.lookup(ids)
            c.lazy_grad(ids, 0.01 * vals)
            c.nn_search(vals, k=K)

    threads = [threading.Thread(target=run, args=(t, c))
               for t, c in enumerate(clients)]
    t0 = time.perf_counter()
    for th in threads:
        th.start()
    for th in threads:
        th.join()
    return len(clients) * rounds * 3 / (time.perf_counter() - t0)


def phase10_remote(paths: dict) -> None:
    """(a) one bank served to this process over the wire against the same
    bank in process: the fixed op stream bit-identical (lookups, scores,
    ids, the table, every leaf of the touched rows, versions included),
    then the 8-client drive's req/s over each, one sample each."""
    child = serve_child("wire server")
    ref = inprocess_bank()
    port = child.wait_port()
    mon = monitor(port)
    before = device_stats(mon)
    client = RemoteKnowledgeBank("127.0.0.1", port, connect_timeout_s=30.0)
    t0 = time.perf_counter()
    got, touched = wire_stream(client)
    wire_s = time.perf_counter() - t0
    want, _ = wire_stream(ref)
    require_bit_identical("phase 10 (a)", got, want)
    leaves_w, leaves_r = client.export_rows(touched), ref.export_rows(touched)
    require(all(np.array_equal(leaves_w[k], leaves_r[k]) for k in leaves_r),
            "phase 10 (a): the touched rows' leaves differ")
    require(np.array_equal(client.table_snapshot(), ref.table_snapshot()),
            "phase 10 (a): the served table differs from the in-process one")
    log(f"phase 10: (a) wire vs in-process bank ({N_ROWS} x {DIM} fp32 "
        f"exact): {len(want)} results of {WIRE_ROUNDS} rounds bit-identical "
        f"(lookups, scores, ids), the table and the {touched.size} touched "
        f"rows' leaves {sorted(leaves_r)} bit-identical; the stream took "
        f"{wire_s:.3f} s over the wire")
    clients = [RemoteKnowledgeBank("127.0.0.1", port, connect_timeout_s=30.0)
               for _ in range(8)]
    wire_rps = wire_drive(clients, SERVE_ROUNDS)
    local_rps = wire_drive([ref] * 8, SERVE_ROUNDS)
    for c in clients + [client]:
        c.close()
    after = device_stats(mon)
    mon.close()
    counts = launches_since(before, after)
    require_launched("phase 10 (a) wire server", counts, WIRE_KERNELS)
    paths["wire_serve"] = counts
    rc = child.stop()
    child.log_output()
    require(rc == 0, f"the wire server exited {rc}")
    log(f"phase 10: (a) 8 clients x batch 4, {SERVE_ROUNDS} rounds: "
        f"{wire_rps} req/s over the wire, {local_rps} req/s in process "
        f"(one sample each, no claim); the server process's launches "
        f"{launched(counts)}, peak device memory {after['peak_bytes']} "
        f"bytes")
    ref.close()


def phase10_fleet(paths: dict) -> None:
    """(b) members 0/2 and 1/2 and a --replica-of standby of member 0 on
    the card, behind a KBRouter: the fixed op stream bit-identical to one
    in-process bank; then writes stream while member 0 is SIGKILLed, the
    router promotes the standby, and every acknowledged write reads
    back."""
    p0 = serve_child("member 0/2", "--kb-join", "0/2")
    p1 = serve_child("member 1/2", "--kb-join", "1/2")
    ref = inprocess_bank()
    port0, port1 = p0.wait_port(), p1.wait_port()
    s0 = serve_child("standby of 0/2", "--kb-join", "0/2", "--replica-of",
                     f"127.0.0.1:{port0}")
    sport = s0.wait_port()
    t0 = time.perf_counter()
    router = connect_kb(f"127.0.0.1:{port0}|127.0.0.1:{sport},"
                        f"127.0.0.1:{port1}", max_retries=1,
                        connect_timeout_s=30.0)
    attach_s = time.perf_counter() - t0
    require(router.standby_status() == [True, False],
            f"the standby is not attached: {router.standby_status()}")
    mons = {name: monitor(port) for name, port in
            (("fleet_member0", port0), ("fleet_member1", port1),
             ("fleet_standby0", sport))}
    before = {name: device_stats(m) for name, m in mons.items()}
    got, _ = wire_stream(router)
    want, _ = wire_stream(ref)
    require_bit_identical("phase 10 (b)", got, want)
    require(np.array_equal(router.table_snapshot(), ref.table_snapshot()),
            "phase 10 (b): the fleet's table differs from one bank's")
    log(f"phase 10: (b) fleet of 2 members ({router.pmap.counts.tolist()} "
        f"rows)"
        f" and a standby of member 0 (attached and filled in "
        f"{attach_s:.2f} s): {len(want)} results bit-identical to one "
        f"in-process bank, the table bit-identical")
    ref.close()
    del ref
    gc.collect()
    torch.cuda.empty_cache()
    # writes stream from a thread; member 0 dies after WIRE_KILL_AT acks
    rng = np.random.default_rng(WIRE_SEED + 1)
    acked, acks, errors = {}, threading.Semaphore(0), []
    kill_go = threading.Event()

    def writer():
        try:
            for i in range(WIRE_WRITES):
                if i == WIRE_KILL_AT:
                    kill_go.set()
                    time.sleep(0.05)        # the kill lands mid-stream
                ids = rng.choice(N_ROWS, BATCH, replace=False)
                vals = rng.standard_normal((BATCH, DIM), dtype=np.float32)
                router.update(ids, vals, src_step=100 + i)
                acked.update(zip(ids.tolist(), vals))
                acks.release()
        except Exception as e:          # reported below
            errors.append(e)
        kill_go.set()

    th = threading.Thread(target=writer)
    th.start()
    kill_go.wait(600)
    last0 = device_stats(mons["fleet_member0"])
    p0.proc.kill()                      # SIGKILL: its CUDA context goes too
    t_kill = time.perf_counter()
    th.join(600)
    require(not errors, f"phase 10 (b): a write failed: {errors}")
    ids = np.array(sorted(acked))
    back = router.lookup(ids)
    lost = int((back != np.stack([acked[g] for g in ids])).any(1).sum())
    promote_s = time.perf_counter() - t_kill
    q = np.random.default_rng(WIRE_SEED + 2).standard_normal(
        (BATCH, DIM), dtype=np.float32)
    s_nn, i_nn = router.nn_search(q, K)
    require(bool(np.isfinite(s_nn).all()) and (i_nn >= 0).all(),
            "phase 10 (b): a search after the promotion failed")
    rm = dict(router.router_metrics)
    after = {"fleet_member0": last0,
             "fleet_member1": device_stats(mons["fleet_member1"]),
             "fleet_standby0": device_stats(mons["fleet_standby0"])}
    for m in mons.values():
        m.close()
    router.close()
    require(rm["promotions"] == 1 and lost == 0,
            f"phase 10 (b): {rm['promotions']} promotions, {lost} of "
            f"{ids.size} acknowledged writes lost")
    for name in mons:
        counts = launches_since(before[name], after[name])
        require_launched(f"phase 10 (b) {name}", counts, WIRE_KERNELS)
        paths[name] = counts
        log(f"phase 10: (b) {name}: launches {launched(counts)}, peak "
            f"device memory "
            f"{after[name]['peak_bytes']} bytes"
            + (" (read just before its SIGKILL)"
               if name == "fleet_member0" else ""))
    log(f"phase 10: (b) {WIRE_WRITES} writes of {BATCH} rows streamed, "
        f"member 0 SIGKILLed after {WIRE_KILL_AT}: {rm['promotions']} "
        f"promotion, {ids.size} acknowledged rows read back, {lost} lost; "
        f"{promote_s:.3f} s from the kill to the read-back; router "
        f"{rm}")
    for c, want_rc in ((s0, 0), (p1, 0)):
        rc = c.stop()
        c.log_output()
        require(rc == want_rc, f"{c.name} exited {rc}")
    require(p0.wait(60) == -signal.SIGKILL, f"member 0 exited "
            f"{p0.proc.returncode}")
    p0.log_output()


def phase10_trainer(paths: dict) -> None:
    """(c) the train launcher at phase 8's full width (yi-6b, 16 layers, 8
    x 64, lr 1e-4, the graph builder in its runtime) against a bank of
    2048 x 4096 in another process, set to zeros as the in-process
    triangle's, with a maker_worker process's graph builder beside it."""
    bank = serve_child("train bank", rows=TRAIN_NODES, dim=WIDE_DIM)
    port = bank.wait_port()
    mon = monitor(port)
    mon.update(np.arange(TRAIN_NODES),
               np.zeros((TRAIN_NODES, WIDE_DIM), np.float32))
    before = device_stats(mon)
    spec = f"127.0.0.1:{port}"
    worker = Child("maker worker", [
        "-m", "repro_torch.launch.maker_worker", "--connect", spec,
        "--makers", "graph_builder", "--batch", str(ASYNC_MAKER_B)])
    trainer = Child("trainer", [
        "-c", WIRE_TRAINER, "--layers", str(TRAIN_LAYERS),
        "--makers", "graph_builder", "--kb-connect", spec,
        "--steps", str(ASYNC_STEPS), "--batch", str(TRAIN_B),
        "--seq", str(TRAIN_SEQ), "--nodes", str(TRAIN_NODES),
        "--lr", str(TRAIN_LR), "--maker-batch", str(ASYNC_MAKER_B),
        "--ckpt-period", str(ASYNC_CKPT)])
    rc = trainer.wait(WIRE_TRAIN_S)
    trainer.log_output()
    require(rc == 0, f"the trainer exited {rc}")
    rc = worker.stop()
    worker.log_output()
    require(rc == 0, f"the maker worker exited {rc}")
    line = next((ln for ln in trainer.lines
                 if ln.startswith("wire trainer: ")), None)
    require(line is not None, "the trainer printed no result")
    res = json.loads(line[len("wire trainer: "):])
    m = re.search(r"maker-worker done: steps=(\d+) rows_written=(\d+) "
                  r"errors=(\d+)", worker.output())
    require(m is not None and int(m.group(1)) > 0 and int(m.group(2)) > 0
            and int(m.group(3)) == 0, f"the maker worker: {m and m.group(0)}")
    after = device_stats(mon)
    mon.close()
    bank_counts = launches_since(before, after)
    require_launched("phase 10 (c) bank", bank_counts,
                     ("kb_fused_lookup", "nn_search"))
    require_launched("phase 10 (c) trainer", res["launches"], ("adamw",))
    rc = bank.stop()
    bank.log_output()
    require(rc == 0, f"the train bank exited {rc}")
    paths["wire_train_bank"] = bank_counts
    paths["wire_trainer"] = res["launches"]
    losses = res["losses"]
    require(bool(np.isfinite(losses).all())
            and np.mean(losses[-3:]) < losses[0],
            f"phase 10 (c): losses not finite or not falling: {losses}")
    core = float(np.median(res["core_ms"][2:]))
    loop = float(np.median(res["loop_ms"][2:]))
    mine = torch.cuda.memory_allocated()
    total = res["peak"] + after["peak_bytes"] + mine
    require(total < DEVICE_BYTES, f"phase 10 (c): the processes' summed "
            f"peak {total} bytes is not under {DEVICE_BYTES}")
    log(f"phase 10: (c) yi-6b cut to {TRAIN_LAYERS} layers, {TRAIN_B} x "
        f"{TRAIN_SEQ}, over the wire: losses {losses}; ms a step (median "
        f"of steps 3-{ASYNC_STEPS}): train core {core}, whole loop step "
        f"{loop}; phase 9 in process, train core / loop step: "
        f"{TRIANGLE_MS}; maker worker {m.group(0)}; launches: trainer "
        f"{launched(res['launches'])}, bank {launched(bank_counts)}; peak "
        f"device bytes: "
        f"trainer {res['peak']}, bank {after['peak_bytes']}, this "
        f"process {mine}: {total} in all")


def phase10_wire() -> dict:
    """Phase 10: the wire and the fleet; returns each process's launches
    by path (each read from its process's stats before and after the
    path, so counted as if set to 0 just before it)."""
    free_weights("phase 10", "wire and fleet")
    paths = {}
    try:
        phase10_remote(paths)
        phase10_fleet(paths)
        phase10_trainer(paths)
    finally:
        stop_children()
    return paths


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
    tier_counts = phase3_tiered()
    log(f"phase 3: {time.perf_counter() - t:.1f} s")
    t = time.perf_counter()
    paths = phase4_serve()
    log(f"phase 4: {time.perf_counter() - t:.1f} s")
    t = time.perf_counter()
    paths["serve_lm"] = phase5_lm()
    log(f"phase 5: {time.perf_counter() - t:.1f} s")
    t = time.perf_counter()
    paths["serve_rwkv"] = phase6_rwkv()
    log(f"phase 6: {time.perf_counter() - t:.1f} s")
    t = time.perf_counter()
    paths["serve_jamba"] = phase7_jamba()
    log(f"phase 7: {time.perf_counter() - t:.1f} s")
    t = time.perf_counter()
    paths.update(phase11_zoo())
    log(f"phase 11: {time.perf_counter() - t:.1f} s")
    t = time.perf_counter()
    paths.update(phase8_train())
    log(f"phase 8: {time.perf_counter() - t:.1f} s")
    t = time.perf_counter()
    paths.update(phase12_zoo_train())
    log(f"phase 12: {time.perf_counter() - t:.1f} s")
    t = time.perf_counter()
    paths.update(phase9_makers())
    log(f"phase 9: {time.perf_counter() - t:.1f} s")
    t = time.perf_counter()
    paths.update(phase10_wire())
    log(f"phase 10: {time.perf_counter() - t:.1f} s")
    paths["engine_lazy"] = engine_counts[True]
    paths["engine_immediate"] = engine_counts[False]
    paths["engine_int8"] = engine_counts["int8"]
    paths["engine_fp32_ivf"] = engine_counts["ivf_fp32"]
    paths["engine_int8_ivf"] = engine_counts["ivf_int8"]
    paths["engine_sharded_fp32"] = engine_counts["sharded_fp32"]
    paths["engine_sharded_int8"] = engine_counts["sharded_int8"]
    for label, c in tier_counts.items():
        paths[f"engine_tiered_{label}"] = c

    record = []
    for name, replaces in KERNELS.items():
        r = results[name]
        # a kernel's launches are those of the path it serves (KERNEL_PATH)
        launches = paths[KERNEL_PATH[name]][name]
        require(launches > 0, f"{name} was never launched on its path")
        record.append({
            "name": name, "route": "cuda",
            "source": f"src/repro_torch/kernels/csrc/{name}.cu",
            "replaces": replaces, "launches": launches,
            "path": KERNEL_PATH[name],
            "launches_by_path": {p: c[name] for p, c in paths.items()},
            "max_abs_err": r["max_abs_err"], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound"][0],
            "bound_by": r["bound"][1], "library_ms": r["library_ms"],
            **{k: r[k] for k in ("fp32", "launch_floor_ms", "ms_b1024",
                                 "op_ms", "op_kernels", "autograd_err",
                                 "train_shape", "library", "gn_rel_err",
                                 "leaves", "entries", "zoo")
               if k in r}})
        if KERNEL_PATH[name] in ("train", "train_rwkv", "train_yi_2048"):
            record[-1]["launches_per_step"] = launches // TRAIN_STEPS
        if "trainer" in r:      # kb_fused_lookup on the trainer's path
            t = r["trainer"]
            record[-1]["trainer"] = {
                "launches": paths["train"][name],
                "launches_per_step": paths["train"][name] // TRAIN_STEPS,
                "rows": TRAIN_NODES, "ids": TRAIN_B * get_config(
                    "yi-6b").carls.num_neighbors,
                "dim": get_config("yi-6b").d_model,
                "max_abs_err": t["max_abs_err"], "ms": t["ms"],
                "plain_ms": t["plain_ms"], "bound_ms": t["bound"][0],
                "bound_by": t["bound"][1], "library_ms": None}
        if "maker" in r:        # nn_search on the makers' path, at 4096
            record[-1]["maker"] = {
                "launches": paths["train_async"][name],
                "rows": TRAIN_NODES, "queries": MAKER_B, "dim": WIDE_DIM,
                **{kk: {"k": int(kk[1:]), "max_abs_err": v["max_abs_err"],
                        "ms": v["ms"], "plain_ms": v["plain_ms"],
                        "bound_ms": v["bound"][0],
                        "bound_by": v["bound"][1], "library_ms": None}
                   for kk, v in r["maker"].items()}}
        if "wide" in r:         # a stage-2 entry at D 4096
            w = r["wide"]
            record[-1]["wide"] = {
                "dim": WIDE_DIM, "rows": WIDE_IVF_ROWS, "queries": BATCH,
                "max_abs_err": w["max_abs_err"], "ms": w["ms"],
                "plain_ms": w["plain_ms"], "bound_ms": w["bound"][0],
                "bound_by": w["bound"][1], "library_ms": None}
    log("kernels: " + "; ".join(
        f"{k['name']} err={k['max_abs_err']:.3g} ms={k['ms']:.4g} "
        f"plain={k['plain_ms']:.4g} bound={k['bound_ms']:.4g} "
        f"({k['bound_by']}) library={k['library_ms']} "
        f"launches={k['launches']} ({k['path']})" for k in record))
    log(f"total {time.perf_counter() - t_all:.1f} s")
    print(json.dumps({"kernels": record}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
