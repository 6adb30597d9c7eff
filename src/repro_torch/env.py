"""Device choice, float precision and kernel block sizing for the port.

Three decisions live here and nowhere else:

1. **The device is explicit.** Every public entry point of the port takes
   ``device=`` with the default ``"cuda"``. ``resolve_device`` raises when
   that default meets a machine with no CUDA device, rather than running
   quietly on the CPU: a CPU run is one the caller asked for by name
   (the tests do). There is no interpret mode; on the CPU the kernel
   wrappers run their plain PyTorch versions because the tensors they were
   given lie there.
2. **fp32 means fp32.** TF32 keeps 10 mantissa bits, so a TF32 matmul
   would move nn_search scores by ~1e-3 and flip the ids of near ties
   against the JAX reference, which computes in full fp32. Both switches
   are set off when this module is imported, which every module of the
   port does.
3. **Block sizes fit Hopper's shared memory.** The JAX package sizes its
   Pallas tiles against a 16 MiB VMEM budget (``repro/env.py:215-266``).
   A CUDA block has at most 227 KB of shared memory, so the same two
   helpers are re-budgeted against that.
"""
from __future__ import annotations

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

# dynamic shared memory one block may opt into on an H100 (232,448 bytes)
SMEM_BYTES = 227 * 1024
DEFAULT_BLOCK_ROWS = 128            # fit_block_rows' default tile rows
DEFAULT_ROWS_PER_BLOCK = 8          # one warp per row: 8 warps, 256 threads


def resolve_device(device="cuda") -> torch.device:
    """The device an entry point runs on. ``"cuda"`` (the default
    everywhere) raises when no CUDA device is present; the CPU is used
    only when the caller names it."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' "
                "(--device cpu) to run the port on the CPU")
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {device!r} (want cuda | cpu)")
    return dev


def _floor_pow2(n: int) -> int:
    return 1 << (n.bit_length() - 1)


def fit_block_rows(dim: int, *, want: int = DEFAULT_BLOCK_ROWS,
                   n_arrays: int = 1, dtype_bytes: int = 4,
                   fixed_bytes: int = 0, budget: int = SMEM_BYTES,
                   minimum: int = 1) -> int:
    """Largest power-of-two row count <= ``want`` whose ``n_arrays``
    (rows, dim) tiles plus ``fixed_bytes`` of other scratch fit one
    block's shared memory. Raises when not even ``minimum`` rows fit."""
    per_row = max(1, dim) * dtype_bytes * n_arrays
    rows = min(want, (budget - fixed_bytes) // per_row)
    if rows < minimum:
        raise ValueError(
            f"{n_arrays} tile(s) of width {dim} plus {fixed_bytes} fixed "
            f"bytes leave room for {max(rows, 0)} rows in {budget} bytes of "
            f"shared memory; at least {minimum} are needed")
    return _floor_pow2(rows)


def fused_lookup_block(batch: int, dim: int, *,
                       want: int = DEFAULT_ROWS_PER_BLOCK,
                       budget: int = SMEM_BYTES) -> int:
    """Rows one block of the fused-lookup kernels takes (one warp per row).
    Each warp keeps two (dim,) fp32 tiles in shared memory, its row's
    averaged gradient and values; a batch smaller than ``want`` gets a
    smaller block so no warp idles."""
    return fit_block_rows(dim, want=min(want, _floor_pow2(max(1, batch))),
                          n_arrays=2, budget=budget)


def stage_lookup_ids(batch: int, dim: int, rows: int, *,
                     budget: int = SMEM_BYTES) -> bool:
    """Whether a block of the fused-lookup kernels stages the batch's ids
    (8 bytes each) in shared memory beside its ``rows`` warps' tiles; a
    batch too large for that is scanned where it lies, in global
    memory."""
    return batch * 8 + rows * 2 * dim * 4 <= budget
