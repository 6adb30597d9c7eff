"""Plain PyTorch versions of the port's kernels.

Each has its kernel's exact contract (the same in-place writes, the same
treatment of ids outside [0, N), the same formula), so a kernel wrapper
can run it for a tensor that lies on the CPU, the CPU tests can hold it
against the Pallas kernel it replaces, and ``chip_smoke.py`` can hold the
CUDA kernel against it on the card. Nothing on the card's serving path
calls these.
"""
from __future__ import annotations

import math

import torch

from repro_torch.core.knowledge_bank import (dequantize_rows, pending_delta,
                                             quantize_rows, topk_lowest_id)
from repro_torch.kernels.flash_attention import BWD_KEY_TILE, KV_TILE
from repro_torch.kernels.mamba_scan import CHUNK as SCAN_CHUNK
from repro_torch.kernels.nn_search_ivf import (IMAX, NEG, STAGE2_BLOCK,
                                               _chunk_rows, global_probes,
                                               ivf_chunk_plan)
from repro_torch.kernels.rwkv_wkv import CHUNK as WKV_CHUNK


def _valid(ids: torch.Tensor, n_rows: int) -> torch.Tensor:
    return (ids >= 0) & (ids < n_rows)


def _bump_version(version, grad_cnt, rows) -> None:
    """+1 to each of ``rows``' versions where the row holds pending
    gradients, read before its caches clear; duplicates write equal
    values, so a row is bumped once."""
    if version is not None:
        version[rows] = version[rows] + (grad_cnt[rows] > 0).to(torch.int32)


def kb_fused_lookup_ref(table, grad_sum, grad_cnt, grad_sqnorm, ids, *,
                        lazy_lr: float, zmax: float,
                        version=None) -> torch.Tensor:
    """``kb_lookup(apply_pending=True)`` in place: each requested row gets
    its clipped pending delta and its three caches zeroed, and comes back
    as a (B, D) row; where ``version`` ((N,) int32) is given, each
    requested row with pending gradients is bumped by one (without it,
    the caller bumps). Ids outside [0, N) (the Pallas kernel's -1
    padding) match no row: they read zeros and change nothing. Duplicates
    all read the same updated row."""
    ids = ids.long()
    ok = _valid(ids, table.shape[0])
    rows = ids[ok]
    _bump_version(version, grad_cnt, rows)
    new = table[rows] + pending_delta(grad_sum[rows], grad_cnt[rows],
                                      grad_sqnorm[rows], lazy_lr=lazy_lr,
                                      zmax=zmax)
    table[rows] = new
    grad_sum[rows] = 0.0
    grad_cnt[rows] = 0.0
    grad_sqnorm[rows] = 0.0
    vals = torch.zeros((ids.shape[0], table.shape[1]), dtype=torch.float32,
                       device=table.device)
    vals[ok] = new
    return vals


def kb_gather_ref(table, ids) -> torch.Tensor:
    """Rows by id, (B,) -> (B, D); ids outside [0, N) give zero rows."""
    ids = ids.long()
    ok = _valid(ids, table.shape[0])
    out = torch.zeros((ids.shape[0], table.shape[1]), dtype=table.dtype,
                      device=table.device)
    out[ok] = table[ids[ok]]
    return out


def lazy_apply_ref(table, grad_sum, grad_cnt, grad_sqnorm, *,
                   lazy_lr: float, zmax: float) -> None:
    """``kb_flush`` on the four leaves, in place, with the Pallas kernel's
    own norm, ``sqrt(max(sum(avg²), 1e-24))`` (``lazy_apply.py:33-36``);
    ``pending_delta``'s ``max(|avg|, 1e-12)`` differs only below it."""
    cnt = torch.clamp(grad_cnt, min=1.0)[:, None]
    avg = grad_sum / cnt
    avg_norm = torch.sqrt(torch.clamp(torch.sum(avg * avg, -1, keepdim=True),
                                      min=1e-24))
    rms = torch.sqrt(grad_sqnorm[:, None] / cnt)
    cap = zmax * torch.clamp(rms, min=1e-12)
    scale = torch.clamp(cap / avg_norm, max=1.0)
    delta = -lazy_lr * avg * scale
    pending = grad_cnt > 0
    table[pending] = table[pending] + delta[pending]
    grad_sum.zero_()
    grad_cnt.zero_()
    grad_sqnorm.zero_()


def nn_search_ref(queries, bank, k: int):
    """Exact top-k MIPS, (B, D) x (N, D) -> (scores (B, k), int64 ids
    (B, k)), ties to the lowest id (the Pallas kernel's ``_merge_topk``
    order)."""
    return topk_lowest_id(queries.to(torch.float32) @ bank.T, k)


def kb_fused_lookup_q_ref(codes, qscale, qoffset, grad_sum, grad_cnt,
                          grad_sqnorm, ids, *, lazy_lr: float,
                          zmax: float, version=None) -> torch.Tensor:
    """``kb_lookup_q`` in place on the int8 codes, the scale/offset
    side-cars, the caches and, where given, ``version`` (bumped as
    ``kb_fused_lookup_ref`` bumps it): each requested row with pending
    gradients is dequantized, takes its clipped delta and is re-quantized;
    a row without keeps its exact codes, scale and offset. Every requested
    row's caches are zeroed, and the (B, D) output is the dequantization
    of what the bank now stores. Ids outside [0, N) read zeros and change
    nothing."""
    ids = ids.long()
    ok = _valid(ids, codes.shape[0])
    rows = ids[ok]
    _bump_version(version, grad_cnt, rows)
    c, s, o, cnt = codes[rows], qscale[rows], qoffset[rows], grad_cnt[rows]
    new = dequantize_rows(c, s, o) + pending_delta(
        grad_sum[rows], cnt, grad_sqnorm[rows], lazy_lr=lazy_lr, zmax=zmax)
    c_n, s_n, o_n = quantize_rows(new)
    upd = cnt > 0
    c = torch.where(upd[:, None], c_n, c)
    s = torch.where(upd, s_n, s)
    o = torch.where(upd, o_n, o)
    codes[rows], qscale[rows], qoffset[rows] = c, s, o
    grad_sum[rows] = 0.0
    grad_cnt[rows] = 0.0
    grad_sqnorm[rows] = 0.0
    vals = torch.zeros((ids.shape[0], codes.shape[1]), dtype=torch.float32,
                       device=codes.device)
    vals[ok] = dequantize_rows(c, s, o)
    return vals


def _ivf_stage2(score_rows, packed_ids, bucket_occ, queries, probes,
                k: int):
    """The stage-2 kernels' contract over any row scorer: for each query,
    the candidates are the packed slots of the chunks that
    ``ivf_chunk_plan`` schedules (the occupied chunks of its probed
    buckets); slots with id -1 never enter; the k best come out in
    (score descending, id ascending) order, the Pallas ``_merge_topk``
    order, padded with (NEG, IMAX). -> (scores (B, k) f32, ids (B, k)
    int64), snapshot scores."""
    B = queries.shape[0]
    C = bucket_occ.shape[0]
    cap = packed_ids.shape[0] // C
    lb = _chunk_rows(cap, STAGE2_BLOCK)
    sel, nvalid = ivf_chunk_plan(probes, bucket_occ, cap // lb, lb)
    dev = queries.device
    out_s = torch.full((B, k), NEG, dtype=torch.float32, device=dev)
    out_i = torch.full((B, k), IMAX, dtype=torch.int64, device=dev)
    slot = torch.arange(lb, device=dev)
    for b in range(B):
        chunks = sel[b, :int(nvalid[b])].long()
        rows = (chunks[:, None] * lb + slot[None, :]).reshape(-1)
        ids = packed_ids[rows].long()
        keep = ids >= 0
        rows, ids = rows[keep], ids[keep]
        s = score_rows(queries[b].to(torch.float32), rows)
        by_id = torch.argsort(ids, stable=True)
        s, order = torch.sort(s[by_id], descending=True, stable=True)
        n = min(k, s.shape[0])
        out_s[b, :n] = s[:n]
        out_i[b, :n] = ids[by_id][order[:n]]
    return out_s, out_i


def ivf_stage2_ref(packed_vecs, packed_ids, bucket_occ, queries, probes,
                   k: int):
    """Plain version of ``csrc/ivf_stage2.cu`` (the Pallas
    ``ivf_stage2_pallas``): fp32 snapshot scores ``q . v``."""
    return _ivf_stage2(
        lambda q, rows: packed_vecs[rows].to(torch.float32) @ q,
        packed_ids, bucket_occ, queries, probes, k)


def ivf_stage2_q_ref(packed_codes, packed_scale, packed_offset, packed_ids,
                     bucket_occ, queries, probes, k: int):
    """Plain version of ``csrc/ivf_stage2_q.cu`` (the Pallas
    ``ivf_stage2_quantized_pallas``): int8 snapshot rows scored
    ``scale * (q . c) + sum(q) * offset``, never dequantized."""
    return _ivf_stage2(
        lambda q, rows: ((packed_codes[rows].to(torch.float32) @ q)
                         * packed_scale[rows]
                         + torch.sum(q) * packed_offset[rows]),
        packed_ids, bucket_occ, queries, probes, k)


def _ivf_stage2_sharded(stage2, packed, packed_ids, bucket_occ, queries,
                        probes, k: int):
    """A single-index stage 2 run once per (query, shard) over the
    globalised probes: each row of the (B*S, nprobe) plan is one shard's
    probes of one query, so ``ivf_chunk_plan`` compacts each shard's
    occupied chunks on their own and each (query, shard) keeps its own
    top-k. -> (scores (B, S, k), ids (B, S, k))."""
    B, S, nprobe = probes.shape
    s, i = stage2(*packed, packed_ids, bucket_occ,
                  queries.repeat_interleave(S, 0),
                  global_probes(probes, bucket_occ.shape[0]).reshape(
                      B * S, nprobe), k)
    return s.reshape(B, S, k), i.reshape(B, S, k)


def ivf_stage2_sharded_ref(packed_vecs, packed_ids, bucket_occ, queries,
                           probes, k: int):
    """Plain version of ``csrc/ivf_stage2_sharded.cu`` (the Pallas
    ``ivf_stage2_sharded_pallas``): over a ``ShardedIVFIndex``'s
    shard-major (S*C*cap, D) rows, probes (B, S, nprobe) LOCAL bucket ids
    per shard -> per-(query, shard) shortlists (B, S, k) in (score
    descending, id ascending) order, snapshot scores, global ids, padded
    with (NEG, IMAX) where a shard's probed buckets hold fewer than k
    rows."""
    return _ivf_stage2_sharded(ivf_stage2_ref, (packed_vecs,), packed_ids,
                               bucket_occ, queries, probes, k)


def ivf_stage2_sharded_q_ref(packed_codes, packed_scale, packed_offset,
                             packed_ids, bucket_occ, queries, probes,
                             k: int):
    """``ivf_stage2_sharded_ref`` over a ``QuantizedShardedIVFIndex``'s
    int8 rows, scored ``scale * (q . c) + sum(q) * offset``: the plain
    version of the int8 entry of ``csrc/ivf_stage2_sharded.cu``."""
    return _ivf_stage2_sharded(
        ivf_stage2_q_ref, (packed_codes, packed_scale, packed_offset),
        packed_ids, bucket_occ, queries, probes, k)


def flash_attention_ref(q, k, v, *, causal: bool = True, window: int = 0,
                        softcap: float = 0.0, return_lse: bool = False):
    """Plain version of ``csrc/flash_attention.cu`` (the Pallas
    ``flash_attention_pallas``, and ``flash_attention_jax``), in the JAX
    layout: q (B, S, H, d), k/v (B, S, KV, d) -> (B, S, H, d) in q's
    dtype. Query head h reads KV head h // (H / KV), without a repeated
    copy. The fp32 kernel's arithmetic over KV tiles of ``KV_TILE`` keys,
    all in fp32: q cast and scaled by 1/sqrt(d) before the product, the
    optional tanh soft cap, masked scores -1e30, the online softmax
    (running max m, sum l, accumulator), and out = acc / max(l, 1e-30).
    Tiles that the kernel skips (above the causal diagonal, before the
    window) leave m, l and acc as they are here too, or are wiped by the
    first tile with a live score, so the two agree but for the order of
    their fp32 sums (the bf16 kernel's differences: its source header).
    With ``return_lse`` it also returns each row's log-sum-exp of its
    scaled (and capped) scores, m + log(l), as (B, H, S) fp32: what the
    kernel writes for its backward."""
    B, S, H, d = q.shape
    KV = k.shape[2]
    if k.shape != (B, S, KV, d) or v.shape != k.shape:
        raise ValueError(f"k {tuple(k.shape)} and v {tuple(v.shape)} must be "
                         f"(B, S, KV, d) = ({B}, {S}, KV, {d})")
    qf = (q.float() * (1.0 / math.sqrt(d))).view(B, S, KV, H // KV, d)
    m = torch.full((B, KV, H // KV, S), NEG, device=q.device)
    lsum = torch.zeros_like(m)
    acc = torch.zeros((B, KV, H // KV, S, d), device=q.device)
    qpos = torch.arange(S, device=q.device)[:, None]
    for k0 in range(0, S, KV_TILE):
        kb = k[:, k0:k0 + KV_TILE].float()               # (B, c, KV, d)
        s = torch.einsum("bqkgd,bckd->bkgqc", qf, kb)
        if softcap:
            s = torch.tanh(s / softcap) * softcap
        kpos = torch.arange(k0, k0 + kb.shape[1], device=q.device)[None, :]
        mask = torch.ones((S, kb.shape[1]), dtype=torch.bool,
                          device=q.device)
        if causal:
            mask &= qpos >= kpos
        if window:
            mask &= qpos - kpos < window
        s = torch.where(mask, s, NEG)
        m_new = torch.maximum(m, s.amax(-1))
        p = torch.exp(s - m_new[..., None])
        corr = torch.exp(m - m_new)
        lsum = lsum * corr + p.sum(-1)
        acc = acc * corr[..., None] + torch.einsum(
            "bkgqc,bckd->bkgqd", p, v[:, k0:k0 + KV_TILE].float())
        m = m_new
    out = acc / torch.clamp(lsum, min=1e-30)[..., None]
    out = out.permute(0, 3, 1, 2, 4).reshape(B, S, H, d).to(q.dtype)
    if return_lse:
        return out, (m + torch.log(lsum)).reshape(B, H, S)
    return out


def flash_attention_bwd_ref(q, k, v, out, lse, dout, *, causal: bool = True,
                            window: int = 0, softcap: float = 0.0):
    """Plain version of ``csrc/flash_attention_bwd.cu``: the gradients of
    ``flash_attention_ref`` with respect to q, k and v, given its output
    ``out``, the rows' log-sum-exp ``lse`` (B, H, S) and the output's
    gradient ``dout``, computed as FlashAttention-2 does: P recomputed as
    exp(s - lse) from the scaled (and capped) scores s, masked pairs 0;
    D = rowsum(dout * out); dP = dout . v; dS = P (dP - D), times
    1 - tanh² of the capped score's argument under a soft cap; dq =
    dS . k / sqrt(d), dk = dS^T . q / sqrt(d) and dv = P^T . dout, dk and
    dv summed over the H / KV query heads of each KV head. Key tiles of
    ``BWD_KEY_TILE``, all in fp32; -> (dq, dk, dv), fp32, in the shapes
    of q, k and v."""
    B, S, H, d = q.shape
    KV = k.shape[2]
    scale = 1.0 / math.sqrt(d)
    qf = q.float().view(B, S, KV, H // KV, d)
    do = dout.float().view(B, S, KV, H // KV, d)
    dvec = (dout.float() * out.float()).sum(-1)              # (B, S, H)
    dvec = dvec.view(B, S, KV, H // KV).permute(0, 2, 3, 1)  # (B, KV, G, S)
    lse = lse.float().view(B, KV, H // KV, S)
    dq = torch.zeros((B, KV, H // KV, S, d), device=q.device)
    dk = torch.empty((B, S, KV, d), device=q.device)
    dv = torch.empty((B, S, KV, d), device=q.device)
    qpos = torch.arange(S, device=q.device)[:, None]
    for k0 in range(0, S, BWD_KEY_TILE):
        kb = k[:, k0:k0 + BWD_KEY_TILE].float()          # (B, c, KV, d)
        vb = v[:, k0:k0 + BWD_KEY_TILE].float()
        s = torch.einsum("bqkgd,bckd->bkgqc", qf, kb) * scale
        if softcap:
            th = torch.tanh(s / softcap)
            s = th * softcap
        kpos = torch.arange(k0, k0 + kb.shape[1], device=q.device)[None, :]
        mask = torch.ones((S, kb.shape[1]), dtype=torch.bool,
                          device=q.device)
        if causal:
            mask &= qpos >= kpos
        if window:
            mask &= qpos - kpos < window
        p = torch.where(mask, torch.exp(s - lse[..., None]), 0.0)
        dp = torch.einsum("bqkgd,bckd->bkgqc", do, vb)
        ds = p * (dp - dvec[..., None])
        if softcap:
            ds = ds * (1.0 - th * th)
        dv[:, k0:k0 + BWD_KEY_TILE] = torch.einsum("bkgqc,bqkgd->bckd", p,
                                                   do)
        dk[:, k0:k0 + BWD_KEY_TILE] = torch.einsum(
            "bkgqc,bqkgd->bckd", ds, qf) * scale
        dq += torch.einsum("bkgqc,bckd->bkgqd", ds, kb) * scale
    return dq.permute(0, 3, 1, 2, 4).reshape(B, S, H, d), dk, dv


def rwkv_wkv_ref(r, k, v, w, u):
    """The RWKV6 WKV recurrence (``repro/kernels/ref.py:80``), one time
    step at a time in fp32: r/k/v/w (B, S, H, d) in any float dtype, u
    (H, d). With S_0 = 0, each step takes
    y_t[j] = sum_i r_t[i] (S[i, j] + u[i] k_t[i] v_t[j]), then
    S <- S * w_t[:, None] + k_t v_t^T. Returns (y (B, S, H, d), S_fin
    (B, H, d, d)), both fp32; S_fin is the state after the last step."""
    B, S, H, d = r.shape
    r, k, v, w = (t.float() for t in (r, k, v, w))
    u = u.float()[None, :, :, None]                      # (1, H, d, 1)
    state = torch.zeros((B, H, d, d), device=r.device)
    y = torch.empty((B, S, H, d), device=r.device)
    for t in range(S):
        kv = k[:, t, :, :, None] * v[:, t, :, None, :]   # (B, H, d, d)
        y[:, t] = torch.einsum("bhi,bhij->bhj", r[:, t], state + u * kv)
        state = state * w[:, t, :, :, None] + kv
    return y, state


def rwkv_wkv_bwd_ref(r, k, v, w, u, dy, dS_fin=None):
    """Plain version of ``csrc/rwkv_wkv_bwd.cu``: the gradients of
    ``rwkv_wkv_ref`` with respect to r, k, v, w and u, given the gradients
    of its y (B, S, H, d) and of its final state (B, H, d, d; None is 0).
    With S_t the state after step t and G the gradient of S_t (G starts at
    dS_fin), time walks backward:
    dr_t[i] = sum_j dy_t[j] (S_{t-1}[i, j] + u[i] k_t[i] v_t[j]),
    dk_t[i] = r_t[i] u[i] (dy_t . v_t) + sum_j G[i, j] v_t[j],
    dv_t[j] = dy_t[j] sum_i r_t[i] u[i] k_t[i] + sum_i G[i, j] k_t[i],
    dw_t[i] = sum_j G[i, j] S_{t-1}[i, j],
    du[i] += sum_b r_t[i] k_t[i] (dy_t . v_t), then
    G <- diag(w_t) G + r_t dy_t^T. S_{t-1} is recomputed forward from the
    states kept at the start of each chunk of ``WKV_CHUNK`` steps (never
    by dividing by w_t, which can be ~0), as the kernel does. -> (dr, dk,
    dv, dw, du), fp32."""
    B, S, H, d = r.shape
    r, k, v, w, dy = (t.float() for t in (r, k, v, w, dy))
    u = u.float()[None]                                  # (1, H, d)
    G = (torch.zeros((B, H, d, d), device=r.device) if dS_fin is None
         else dS_fin.float().clone())

    def advance(state, t):
        return state * w[:, t, :, :, None] + k[:, t, :, :, None] * \
            v[:, t, :, None, :]

    starts, state = [], torch.zeros((B, H, d, d), device=r.device)
    for t in range(S):
        if t % WKV_CHUNK == 0:
            starts.append(state)
        state = advance(state, t)
    dr, dk, dv, dw = (torch.empty((B, S, H, d), device=r.device)
                      for _ in range(4))
    du = torch.zeros((H, d), device=r.device)
    for c in reversed(range(len(starts))):
        t0, t1 = c * WKV_CHUNK, min(S, (c + 1) * WKV_CHUNK)
        prev = [starts[c]]                               # S_{t-1}, t in chunk
        for t in range(t0, t1 - 1):
            prev.append(advance(prev[-1], t))
        for t in reversed(range(t0, t1)):
            sp, rt, kt, vt, dyt = prev[t - t0], r[:, t], k[:, t], v[:, t], \
                dy[:, t]
            dyv = (dyt * vt).sum(-1, keepdim=True)       # (B, H, 1)
            ct = (rt * u * kt).sum(-1, keepdim=True)
            dr[:, t] = torch.einsum("bhj,bhij->bhi", dyt, sp) + u * kt * dyv
            dk[:, t] = rt * u * dyv + torch.einsum("bhij,bhj->bhi", G, vt)
            dv[:, t] = dyt * ct + torch.einsum("bhij,bhi->bhj", G, kt)
            dw[:, t] = (G * sp).sum(-1)
            du += (rt * kt * dyv).sum(0)
            G = G * w[:, t, :, :, None] + rt[..., :, None] * dyt[..., None, :]
    return dr, dk, dv, dw, du


def mamba_scan_ref(delta, bm, cm, x, A):
    """The Mamba selective scan (``repro/kernels/ref.py:63``), one time
    step at a time in fp32: delta, x (B, S, di) and bm, cm (B, S, ds) in
    any float dtype, A (di, ds). With h_0 = 0, each step takes
    h <- exp(delta_t A) * h + (delta_t x_t) B_t and y_t = h . C_t (the
    output before the D skip and the gate). Returns (y (B, S, di), h_fin
    (B, di, ds)), both fp32; h_fin is the state after the last step."""
    B, S, di = delta.shape
    delta, bm, cm, x, A = (t.float() for t in (delta, bm, cm, x, A))
    h = torch.zeros((B, di, A.shape[-1]), device=delta.device)
    y = torch.empty((B, S, di), device=delta.device)
    for t in range(S):
        d_t = delta[:, t]
        a_t = torch.exp(d_t[..., None] * A[None])
        h = a_t * h + (d_t * x[:, t])[..., None] * bm[:, t, None, :]
        y[:, t] = torch.einsum("bds,bs->bd", h, cm[:, t])
    return y, h


def mamba_scan_bwd_ref(delta, bm, cm, x, A, dy, dh_fin=None):
    """Plain version of ``csrc/mamba_scan_bwd.cu``: the gradients of
    ``mamba_scan_ref`` with respect to delta, bm, cm, x and A, given the
    gradients of its y (B, S, di) and of its final state (B, di, ds; None
    is 0). With a_t = exp(delta_t A) and Gh the gradient of h_t (starting
    at dh_fin), time walks backward: first Gh += dy_t C_t; then
    dC_t = sum_c dy_t[c] h_t[c, :], dB_t = sum_c Gh[c, :] delta_t[c]
    x_t[c], dx_t = delta_t sum_n Gh B_t, ddelta_t = x_t sum_n Gh B_t +
    sum_n Gh h_{t-1} a_t A, dA += sum_b Gh h_{t-1} a_t delta_t; then
    Gh <- a_t Gh. h_{t-1} is recomputed forward from the states kept at
    the start of each chunk of ``SCAN_CHUNK`` steps (never by dividing by
    a_t, which can be ~0), as the kernel does. -> (ddelta, dbm, dcm, dx,
    dA), fp32."""
    B, S, di = delta.shape
    delta, bm, cm, x, A, dy = (t.float() for t in (delta, bm, cm, x, A, dy))
    G = (torch.zeros((B, di, A.shape[-1]), device=delta.device)
         if dh_fin is None else dh_fin.float().clone())

    def decay(t):
        return torch.exp(delta[:, t, :, None] * A[None])

    def advance(h, t):
        return decay(t) * h + (delta[:, t] * x[:, t])[..., None] * \
            bm[:, t, None, :]

    starts, h = [], torch.zeros_like(G)
    for t in range(S):
        if t % SCAN_CHUNK == 0:
            starts.append(h)
        h = advance(h, t)
    ddelta, dx = (torch.empty((B, S, di), device=delta.device)
                  for _ in range(2))
    dbm, dcm = (torch.empty_like(bm) for _ in range(2))
    dA = torch.zeros_like(A)
    for c in reversed(range(len(starts))):
        t0, t1 = c * SCAN_CHUNK, min(S, (c + 1) * SCAN_CHUNK)
        prev = [starts[c]]                               # h_{t-1}, t in chunk
        for t in range(t0, t1 - 1):
            prev.append(advance(prev[-1], t))
        for t in reversed(range(t0, t1)):
            hp, d_t, a = prev[t - t0], delta[:, t], decay(t)
            dxv = d_t * x[:, t]
            ht = a * hp + dxv[..., None] * bm[:, t, None, :]
            G = G + dy[:, t, :, None] * cm[:, t, None, :]
            dcm[:, t] = torch.einsum("bd,bds->bs", dy[:, t], ht)
            dbm[:, t] = torch.einsum("bds,bd->bs", G, dxv)
            gb = torch.einsum("bds,bs->bd", G, bm[:, t])
            gha = G * hp * a
            dx[:, t] = d_t * gb
            ddelta[:, t] = x[:, t] * gb + (gha * A[None]).sum(-1)
            dA += (gha * d_t[..., None]).sum(0)
            G = a * G
    return ddelta, dbm, dcm, dx, dA


def global_norm_ref(leaves, chunk: int) -> torch.Tensor:
    """sqrt of the sum over ``leaves`` (in their order) of each leaf's
    fp32 sum of squares, a leaf's sum its ``chunk``-entry chunks' sums
    added in order."""
    return torch.sqrt(sum(
        sum(torch.sum(torch.square(c.float()))
            for c in leaf.reshape(-1).split(chunk))
        for leaf in leaves))


def adamw_update_ref(g, m, v, p, scale, bc1, bc2, lr, *, b1: float,
                     b2: float, eps: float, weight_decay: float,
                     chunk: int) -> None:
    """One leaf's AdamW update in place, ``chunk`` entries at a time in
    fp32: ``scale`` (a 0-d tensor, or None for no clip), ``bc1``, ``bc2``
    and ``lr`` are given. Each entry's arithmetic does not depend on the
    chunking; the new parameter and moments are rounded to their dtypes
    (round to nearest even)."""
    for gc, mc, vc, pc in zip(*(t.view(-1).split(chunk)
                                for t in (g, m, v, p))):
        g32 = gc.float()
        if scale is not None:
            g32 = g32 * scale
        m32 = mc.float() * b1 + g32 * (1 - b1)
        v32 = vc.float() * b2 + torch.square(g32) * (1 - b2)
        del g32
        step = (m32 / bc1) / (torch.sqrt(v32 / bc2) + eps)
        if weight_decay:
            step = step + weight_decay * pc.float()
        pc.copy_(pc.float() - lr * step)
        mc.copy_(m32)
        vc.copy_(v32)


def adamw_ref(grads, mus, nus, params, bc1, bc2, lr, *, b1: float,
              b2: float, eps: float, weight_decay: float, clip_norm: float,
              chunk: int):
    """The AdamW kernel's contract (``kernels/adamw.py``) over lists of
    leaves, in place: the global norm of the gradients, the clip scale
    ``min(1, clip_norm / max(gn, 1e-12))`` where ``clip_norm`` > 0, and
    each leaf's update. Returns (gn, scale), 0-d fp32 tensors (scale 1
    where there is no clip)."""
    gn = global_norm_ref(grads, chunk)
    scale = None
    if clip_norm and clip_norm > 0:
        scale = torch.clamp(clip_norm / torch.clamp(gn, min=1e-12), max=1.0)
    for g, m, v, p in zip(grads, mus, nus, params):
        adamw_update_ref(g, m, v, p, scale, bc1, bc2, lr, b1=b1, b2=b2,
                         eps=eps, weight_decay=weight_decay, chunk=chunk)
    return gn, torch.ones_like(gn) if scale is None else scale
