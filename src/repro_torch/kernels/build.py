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
from typing import Dict, Iterable, Sequence

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


# the element types of the kernels' float operands, and the suffix of
# each type's entry point (csrc/common.cuh: REPRO_FLOAT_TYPES)
FLOAT_SUFFIX = {torch.float32: "f32", torch.float16: "f16",
                torch.bfloat16: "bf16"}
FLOAT_TYPES = tuple(FLOAT_SUFFIX)
HALF_TYPES = (torch.float16, torch.bfloat16)


class CudaKernel:
    """The C entry points of one kernel, one per element type
    (``<symbol>_f32``, ``_f16``, ``_bf16``), with their launch counts.

    Called with the entry point's arguments, tensors standing for their
    device pointers, and ``dtype``, the type whose entry point launches.
    ``launches`` grows by one for every launch that the CUDA runtime
    accepted, and nowhere else; ``by_dtype`` splits it by suffix: of
    ``dtype``, or, when a float32 entry point takes a half tensor
    operand (decode's half q over a float32 cache), of that operand.
    ``last_args`` keeps the latest call's arguments (and so its tensors)
    for :meth:`relaunch`.  ``copies`` counts the operands a wrapper copied
    because the kernel's 16-byte loads refuse their view
    (:func:`aligned_rows`)."""

    def __init__(self, source: str, symbol: str, argtypes: Sequence,
                 dtypes: Sequence[torch.dtype] = FLOAT_TYPES):
        self.source = source
        self.symbol = symbol
        self.argtypes = list(argtypes)
        self.dtypes = tuple(dtypes)
        self.launches = 0
        self.by_dtype: Dict[str, int] = {FLOAT_SUFFIX[d]: 0
                                         for d in self.dtypes}
        self.copies = 0
        self.last_args: tuple = ()
        self.last_dtype = torch.float32
        self._fns: Dict[str, ctypes._CFuncPtr] = {}

    def check_dtype(self, name: str, *tensors: torch.Tensor) -> torch.dtype:
        """The one element type of ``tensors``; raises unless they share
        it and the kernel is built for it."""
        dt = tensors[0].dtype
        if dt not in self.dtypes or any(t.dtype != dt for t in tensors):
            raise ValueError(
                f"{name}: operands of one type among "
                f"{[str(d).replace('torch.', '') for d in self.dtypes]}, "
                f"got {[str(t.dtype).replace('torch.', '') for t in tensors]}")
        return dt

    def _launch(self, args, dtype) -> None:
        sym = f"{self.symbol}_{FLOAT_SUFFIX[dtype]}"
        fn = self._fns.get(sym)
        if fn is None:
            fn = getattr(load(self.source), sym)
            fn.argtypes = self.argtypes
            fn.restype = ctypes.c_int
            self._fns[sym] = fn
        err = fn(*(a.data_ptr() if isinstance(a, torch.Tensor) else a
                   for a in args))
        if err:
            msg = load(self.source).repro_error_string(err).decode()
            raise RuntimeError(f"{sym}: CUDA error {err} ({msg})")

    def __call__(self, *args, dtype: torch.dtype = torch.float32) -> None:
        if dtype not in self.dtypes:
            raise ValueError(f"{self.symbol}: no {dtype} entry point")
        self._launch(args, dtype)
        self.launches += 1
        if dtype == torch.float32:
            dtype = next((a.dtype for a in args if isinstance(a, torch.Tensor)
                          and a.dtype in HALF_TYPES), dtype)
        self.by_dtype[FLOAT_SUFFIX[dtype]] += 1
        self.last_args = args
        self.last_dtype = dtype

    def reset(self) -> None:
        self.launches = 0
        self.copies = 0
        for k in self.by_dtype:
            self.by_dtype[k] = 0

    def relaunch(self, n: int) -> None:
        """Launch the latest call's arguments ``n`` more times, uncounted:
        times the kernel alone, without its wrapper."""
        for _ in range(n):
            self._launch(self.last_args, self.last_dtype)


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


def aligned_rows(kernel: CudaKernel, x: torch.Tensor) -> torch.Tensor:
    """A (B, T, heads, Dh) operand of a half attention kernel, which loads
    rows in 16-byte pieces (TMA or ``cp.async``): itself when its base
    and its batch and token strides are multiples of 16 bytes, else a
    contiguous copy, counted in ``kernel.copies``."""
    es = x.element_size()
    if x.data_ptr() % 16 == 0 and all(s * es % 16 == 0
                                      for s in x.stride()[:2]):
        return x
    kernel.copies += 1
    return x.clone(memory_format=torch.contiguous_format)
