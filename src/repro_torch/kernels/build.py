"""Build and bind the port's CUDA kernels (``repro_torch/csrc/*.cu``).

Each source is compiled on its own by ``nvcc`` for ``sm_90a`` into a
shared library with a plain C interface, which ``ctypes`` loads.  No
PyTorch header is included, so a source builds in seconds; the build
runs at first use, or for every source at once through :func:`build`
(one ``nvcc`` per source, all started together).  Libraries land in
``build/repro_torch_kernels/`` at the repository root (listed in
``.gitignore``), named by a hash of the source, the headers and the
flags, so an edit never loads a stale library.

Every C entry point launches on the stream it is given, allocates
nothing, and returns ``cudaGetLastError()``; :class:`CudaKernel` raises
when that is not 0 and otherwise counts the launch.  Nothing here falls
back to a plain version: a missing ``nvcc``, a failed build or a refused
launch is an error.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, Iterable, Optional, Sequence

import torch

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch_kernels"
SOURCES = ("avg_pool", "nn_upsample", "fused_serving", "window_attention",
           "flash_attention", "int8_matmul", "decode_attention", "ssd_scan")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

# ctypes argument kinds: pointers and the stream are c_void_p (a plain
# int would be cut to 32 bits), sizes c_int, strides c_longlong.
P, I, L, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float

_LIBS: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels of repro_torch build "
                       "only where the CUDA toolkit is installed")


def lib_path(name: str) -> Path:
    """The library of ``csrc/<name>.cu``, named by a hash of the source,
    every header under ``csrc/`` and the flags."""
    h = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.name.encode() + header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    tag = h.hexdigest()[:12]
    return BUILD_DIR / f"lib{name}-{tag}.so"


def build(names: Iterable[str] = SOURCES) -> Dict[str, str]:
    """Compile the named sources that are not built yet, one ``nvcc``
    process each, all started together; waits for every one of them.
    Returns each new library's compiler log (``-Xptxas -v``: registers,
    shared memory and spills per kernel).  Raises if any build failed."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = None
    procs = {}
    for name in names:
        out = lib_path(name)
        if out.exists():
            continue
        nvcc = nvcc or _nvcc()
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        procs[name] = (subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT), tmp, out)
    logs, failed = {}, []
    for name, (proc, tmp, out) in procs.items():
        log = proc.communicate()[0].decode(errors="replace")
        logs[name] = log
        if proc.returncode:
            failed.append(f"{name} (exit {proc.returncode}):\n{log}")
        else:
            os.replace(tmp, out)
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return logs


def load(name: str) -> ctypes.CDLL:
    lib = _LIBS.get(name)
    if lib is None:
        build([name])
        lib = ctypes.CDLL(str(lib_path(name)))
        lib.repro_error_string.argtypes = [ctypes.c_int]
        lib.repro_error_string.restype = ctypes.c_char_p
        _LIBS[name] = lib
    return lib


def stream_of(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


class CudaKernel:
    """One C entry point of a kernel library, with its launch count.

    Called with the entry point's arguments, tensors standing for their
    device pointers.  ``launches`` grows by one for every launch that the
    CUDA runtime accepted, and nowhere else.  ``last_args`` keeps the
    latest call's arguments (and so its tensors) for :meth:`relaunch`."""

    def __init__(self, source: str, symbol: str, argtypes: Sequence):
        self.source = source
        self.symbol = symbol
        self.argtypes = list(argtypes)
        self.launches = 0
        self.last_args: tuple = ()
        self._fn: Optional[ctypes._CFuncPtr] = None

    def _launch(self, args) -> None:
        if self._fn is None:
            lib = load(self.source)
            fn = getattr(lib, self.symbol)
            fn.argtypes = self.argtypes
            fn.restype = ctypes.c_int
            self._fn = fn
        err = self._fn(*(a.data_ptr() if isinstance(a, torch.Tensor) else a
                         for a in args))
        if err:
            msg = load(self.source).repro_error_string(err).decode()
            raise RuntimeError(f"{self.symbol}: CUDA error {err} ({msg})")

    def __call__(self, *args) -> None:
        self._launch(args)
        self.launches += 1
        self.last_args = args

    def relaunch(self, n: int) -> None:
        """Launch the latest call's arguments ``n`` more times, uncounted:
        times the kernel alone, without its wrapper."""
        for _ in range(n):
            self._launch(self.last_args)


def check_cuda(name: str, *tensors: torch.Tensor) -> None:
    """Raise unless every tensor lies on one CUDA device."""
    dev = tensors[0].device
    for t in tensors:
        if not t.is_cuda or t.device != dev:
            raise ValueError(f"{name}: all tensors must be on one CUDA "
                             f"device, got {t.device} and {dev}")


def head_rows(x: torch.Tensor) -> torch.Tensor:
    """A (B, T, H, Dh) tensor as the attention kernels read it: itself
    when heads and features are dense (strides Dh, 1) — any batch and
    token strides will do — else a contiguous copy."""
    if x.stride(3) == 1 and x.stride(2) == x.shape[3]:
        return x
    return x.contiguous()
