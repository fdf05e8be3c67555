"""Build and load the port's CUDA kernels.

Every ``csrc/*.cu`` file is compiled by its own ``nvcc`` process for
``sm_90a`` (all started together), and the objects are linked into one
shared library with a plain C interface. The library lives under
``build/repro_torch/<hash>/`` at the repository root, keyed by a hash of
the sources and flags, and is built at first use. It is loaded with
``ctypes``: every pointer and the stream travel as ``c_void_p``, every C
entry returns ``cudaGetLastError()``, and ``check`` raises when it is not
0. Nothing else is built or downloaded.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_ROOT = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
ARCH = ["-gencode", "arch=compute_90a,code=sm_90a"]
FLAGS = ARCH + ["-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

P, I, LL, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
# C entry points: name -> argument types (all return int = cudaError_t).
SIGNATURES = {
    "scatter_rows_launch": [P, LL, I, P, P, P, P, P, P],
    "gather_scores_launch": [P, P, P, P, P, LL, I, I, I, I, P],
    "gather_scores_masked_launch": [P, P, P, P, P, P, P, LL, I, I, I, I, P],
    "flash_attention_launch": [P, P, P, P, P, I, I, I, I, I, I, I, I, I,
                               F, F, I, P],
    "flash_attention_wgmma_launch": [P, P, P, P, P, I, I, I, I, I, I, I, I, I,
                                     F, F, P],
    "decode_attention_launch": [P, P, P, P, P, P, P, P, P, P, I, I, I, I, I, F, F,
                                I, I, I, I, P],
    "frontier_hop_launch": [P, P, P, P, P, P, P, P, P, P, P,
                            LL, I, I, I, I, I, I, P],
    "flat_topk_launch": [P, P, P, P, P, P, P, P, P, P,
                         LL, I, I, I, I, P],
    "mamba_scan_launch": [P, P, P, P, P, P, P, P, P, I, I, I, I, I, P],
    "moe_route_launch": [P, P, P, P, I, I, I, I, I, I, I, I, P],
    "moe_dispatch_launch": [P, P, P, P, P, I, I, I, I, I, P, P],
    "swiglu_cast_launch": [P, P, P, LL, P],
    "moe_combine_launch": [P, P, P, P, I, I, I, I, I, I, P],
}

_LIB: ctypes.CDLL | None = None


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                       "toolkit (sm_90a) on the machine with the card")


def _source_hash() -> str:
    h = hashlib.sha256(" ".join(FLAGS).encode())
    for path in sorted(CSRC.iterdir()):
        if path.suffix in (".cu", ".cuh"):
            h.update(path.name.encode())
            h.update(path.read_bytes())
    return h.hexdigest()[:16]


def build() -> Path:
    """Compile the kernels (if this source hash is not built yet) and
    return the shared library's path. The ``nvcc`` output, ``-Xptxas -v``
    register and shared-memory report included, is kept in ``build.log``
    beside it."""
    sources = sorted(CSRC.glob("*.cu"))
    out_dir = BUILD_ROOT / _source_hash()
    lib = out_dir / "librepro_torch_kernels.so"
    if lib.exists():
        return lib
    out_dir.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    procs = []
    for src in sources:
        obj = out_dir / (src.stem + ".o")
        procs.append((src, subprocess.Popen(
            [nvcc, *FLAGS, "-c", str(src), "-o", str(obj)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    log, failed = [], []
    for src, proc in procs:
        out, _ = proc.communicate()
        log.append(f"== {src.name} (rc {proc.returncode})\n{out}")
        if proc.returncode != 0:
            failed.append(src.name)
    if not failed:
        tmp = out_dir / f".{lib.name}.{os.getpid()}"
        link = subprocess.run(
            [nvcc, *ARCH, "-shared", "-o", str(tmp),
             *(str(out_dir / (s.stem + ".o")) for s in sources)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        log.append(f"== link (rc {link.returncode})\n{link.stdout}")
        if link.returncode != 0:
            failed.append("link")
        else:
            os.replace(tmp, lib)
    (out_dir / "build.log").write_text("\n".join(log))
    if failed:
        raise RuntimeError(f"nvcc failed for {failed}:\n" + "\n".join(log))
    return lib


def library() -> ctypes.CDLL:
    """The loaded kernel library (built at first use)."""
    global _LIB
    if _LIB is None:
        lib = ctypes.CDLL(str(build()))
        for name, argtypes in SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        _LIB = lib
    return _LIB


def stream(device: torch.device) -> int:
    """PyTorch's current CUDA stream on ``device``, as the raw handle the C
    entries take."""
    return torch.cuda.current_stream(device).cuda_stream


def count(wrapper) -> None:
    """Count one launch by ``wrapper`` where it launches its kernel: in
    ``wrapper.launches`` when the kernel runs now, in ``wrapper.recorded``
    when the current stream is capturing a CUDA graph. A recorded launch
    runs at every replay of that graph, which calls no wrapper: its
    holder counts the replays (``core/graphs.py``)."""
    if torch.cuda.is_current_stream_capturing():
        wrapper.recorded += 1
    else:
        wrapper.launches += 1


def check(err: int, name: str) -> None:
    if err != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with error {err}")


def require_cuda(name: str, *tensors: torch.Tensor) -> None:
    """Raise unless every tensor is a contiguous CUDA tensor on one device."""
    dev = tensors[0].device
    for t in tensors:
        if t.device.type != "cuda" or t.device != dev:
            raise ValueError(f"{name}: every tensor must be on one CUDA "
                             f"device (got {t.device} and {dev})")
        if not t.is_contiguous():
            raise ValueError(f"{name}: tensors must be contiguous")

