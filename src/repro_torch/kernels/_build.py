"""Build the port's CUDA kernels at first use and bind them with ctypes.

Each ``csrc/<name>.cu`` is compiled by ``nvcc`` for ``sm_90a`` into a
shared library of its own with a plain C interface (no PyTorch headers, so
a build takes seconds), under ``build/repro_torch_kernels/<hash>/`` at the
root of the checkout, where ``<hash>`` covers every source and the flags:
an edited source builds anew, an unchanged one is loaded as it is. Only
CUDA tensors reach these libraries; a missing ``nvcc`` or a failed build
raises, and nothing here gives way to a plain version.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, Iterable, Sequence

import torch

CSRC = Path(__file__).resolve().with_name("csrc")
SOURCES = ("kb_fused_lookup", "kb_gather", "lazy_apply", "nn_search",
           "kb_fused_lookup_q", "ivf_stage2", "ivf_stage2_q",
           "flash_attention", "rwkv_wkv", "ivf_stage2_sharded",
           "mamba_scan", "flash_attention_bwd", "rwkv_wkv_bwd",
           "mamba_scan_bwd", "adamw")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
BUILD_ROOT = Path(__file__).resolve().parents[3] / "build" / \
    "repro_torch_kernels"

_lock = threading.Lock()
_functions: Dict[str, ctypes._CFuncPtr] = {}
_libraries: Dict[str, ctypes.CDLL] = {}


def build_dir() -> Path:
    """``build/repro_torch_kernels/<hash of csrc/* and the flags>``."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in sorted(CSRC.iterdir()):
        h.update(path.name.encode())
        h.update(path.read_bytes())
    return BUILD_ROOT / h.hexdigest()[:16]


def nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin/nvcc"
    if cand.is_file():
        return str(cand)
    raise RuntimeError("nvcc was not found on PATH or under CUDA_HOME "
                       "(/usr/local/cuda); the CUDA kernels cannot be built")


def library_path(name: str) -> Path:
    return build_dir() / f"lib{name}.so"


def build(names: Iterable[str] = SOURCES) -> Dict[str, str]:
    """Compile every named source that is not built yet, one ``nvcc`` per
    source, all started together. Returns ``{name: compiler output}`` for
    the sources compiled now (``-Xptxas -v`` reports each kernel's
    registers and spills); raises if any compile fails."""
    out_dir = build_dir()
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in names:
        if name not in SOURCES:
            raise ValueError(f"unknown kernel source {name!r}")
        if library_path(name).exists():
            continue
        tmp = out_dir / f"lib{name}.so.{os.getpid()}.tmp"
        cmd = [nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp)
    logs, failed = {}, []
    for name, (proc, tmp) in procs.items():
        logs[name] = proc.communicate()[0]
        (out_dir / f"{name}.log").write_text(logs[name])
        if proc.returncode == 0:
            os.replace(tmp, library_path(name))
        else:
            failed.append(name)
    if failed:
        raise RuntimeError("nvcc failed for " + ", ".join(failed) + ":\n"
                           + "\n".join(logs[n] for n in failed))
    return logs


def compiler_log(name: str) -> str:
    """The ``nvcc`` output kept from the build of ``name``."""
    return (build_dir() / f"{name}.log").read_text()


def kernel_function(name: str, symbol: str, argtypes: Sequence,
                    restype=ctypes.c_int) -> ctypes._CFuncPtr:
    """The C entry ``symbol`` of kernel library ``name``, built and loaded
    at first use, with its argument types declared (ctypes would otherwise
    pass every pointer as a 32-bit int)."""
    key = f"{name}.{symbol}"
    fn = _functions.get(key)
    if fn is None:
        with _lock:
            if name not in _libraries:
                build([name])
                _libraries[name] = ctypes.CDLL(str(library_path(name)))
            fn = getattr(_libraries[name], symbol)
            fn.argtypes = list(argtypes)
            fn.restype = restype
            _functions[key] = fn
    return fn


def check_launch(name: str, code: int) -> None:
    """Raise if a launch function returned a CUDA error: a launch the
    CUDA runtime refused never runs, and no later synchronize reports
    it."""
    if code != 0:
        text = kernel_function(name, f"{name}_error_string", [ctypes.c_int],
                               ctypes.c_char_p)
        raise RuntimeError(f"{name} kernel launch failed with CUDA error "
                           f"{code}: {text(code).decode()}")


def launch(name: str, symbol: str, argtypes: Sequence,
           device: torch.device, *args) -> None:
    """Call launch function ``symbol`` of library ``name`` on ``device``
    with ``args`` and PyTorch's current stream there (the last argument of
    every launch function), and raise if it reports a CUDA error."""
    fn = kernel_function(name, symbol, [*argtypes, ctypes.c_void_p])
    with torch.cuda.device(device):
        code = fn(*args, torch.cuda.current_stream(device).cuda_stream)
    check_launch(name, code)


def require_cuda(t: torch.Tensor, what: str, dtype: torch.dtype,
                 ndim: int) -> None:
    """Raise unless ``t`` is a contiguous CUDA tensor of ``dtype`` and
    rank ``ndim``: what every launch function takes, checked before any
    pointer leaves Python."""
    if t.device.type != "cuda":
        raise ValueError(f"{what} lies on {t.device}; the CUDA kernel takes "
                         "CUDA tensors (the plain version runs on the CPU)")
    if t.dtype != dtype or t.dim() != ndim or not t.is_contiguous():
        raise ValueError(f"{what} must be a contiguous {ndim}-d {dtype} "
                         f"tensor, got {t.dim()}-d {t.dtype} (contiguous="
                         f"{t.is_contiguous()})")


def stream_of(t: torch.Tensor):
    """The handle of PyTorch's current stream on ``t``'s CUDA device (None
    for a tensor elsewhere): what an autograd Function's forward launched
    on."""
    if t.device.type != "cuda":
        return None
    return torch.cuda.current_stream(t.device).cuda_stream


def require_same_stream(saved, t: torch.Tensor, name: str) -> None:
    """Raise unless the current stream on ``t``'s device is ``saved``, the
    forward's: autograd runs a backward on a thread of its own, and
    ``launch`` takes that thread's current stream, which autograd sets to
    the forward's."""
    now = stream_of(t)
    if now != saved:
        raise RuntimeError(f"{name}: the backward would launch on stream "
                           f"{now}, not the forward's {saved}")


def require_bank(table, grad_sum, grad_cnt, grad_sqnorm) -> None:
    """Raise unless the four leaves a lazy-apply kernel updates are fp32
    CUDA tensors of one bank: (N, D), (N, D), (N,), (N,) on one device."""
    require_cuda(table, "table", torch.float32, 2)
    require_cuda(grad_sum, "grad_sum", torch.float32, 2)
    require_cuda(grad_cnt, "grad_cnt", torch.float32, 1)
    require_cuda(grad_sqnorm, "grad_sqnorm", torch.float32, 1)
    N = table.shape[0]
    if (grad_sum.shape != table.shape or grad_cnt.shape != (N,)
            or grad_sqnorm.shape != (N,)):
        raise ValueError("bank leaves disagree in shape: table "
                         f"{tuple(table.shape)}, grad_sum "
                         f"{tuple(grad_sum.shape)}, grad_cnt "
                         f"{tuple(grad_cnt.shape)}, grad_sqnorm "
                         f"{tuple(grad_sqnorm.shape)}")
    if len({t.device for t in (table, grad_sum, grad_cnt,
                               grad_sqnorm)}) != 1:
        raise ValueError("bank leaves lie on different devices")
