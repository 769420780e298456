"""Build and load the hand-written Hopper kernels (``gavit_tpu_torch/csrc``).

The sources export plain C launchers and include no PyTorch header, so one
``nvcc`` call compiles all of them into a shared library in seconds, which is
then bound with ``ctypes``. The library goes to ``build/gavit_tpu_torch/`` at
the repository root, named by a hash of the sources and flags, so an edited
source rebuilds and an unchanged one loads the existing file.

Nothing here runs at import: :func:`library` builds on first use, which only
a wrapper given a CUDA tensor (or ``chip_smoke.py``) reaches. A failed build
raises with ``nvcc``'s stderr; nothing falls back.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "gavit_tpu_torch"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

# dtype codes of csrc/common.cuh
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_SIGNATURES = {
    "gavit_error_string": ((_I,), ctypes.c_char_p),
    "gavit_set_device": ((_I,), _I),
    "gavit_attention_fits": ((_I, _I), _I),
    "gavit_attention_fwd": ((_P, _P, _I, _I, _I, _I, _F, _I, _P), _I),
    "gavit_mlp_infer": ((_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _P), _I),
    "gavit_graph_fits": ((_I,), _I),
    "gavit_graph_fwd": (
        (_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _F, _F, _I, _P), _I),
}

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None
# guards the wrappers' KERNEL_LAUNCHES counts: the HTTP server's threads
# launch concurrently, and `+= 1` is a read-modify-write
count_lock = threading.Lock()
# what the last build in this process printed and took (chip_smoke.py reports
# both); None when the library was already on disk
build_log: str | None = None
build_seconds: float | None = None


def _nvcc() -> str:
    home = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda"))
    if (home / "bin" / "nvcc").exists():
        return str(home / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found: the Hopper kernels build only where the CUDA "
            "toolkit is installed (CUDA_HOME or PATH)")
    return found


def _sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh"))


def library_path() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"libgavit_kernels_{h.hexdigest()[:16]}.so"


def _build(out: Path) -> None:
    global build_log, build_seconds
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-I", str(CSRC), "-o", str(tmp),
           *[str(s) for s in sorted(CSRC.glob("*.cu"))]]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(
            f"nvcc failed with exit code {proc.returncode}:\n"
            f"{' '.join(cmd)}\n{proc.stderr}")
    os.replace(tmp, out)  # atomic: a concurrent loader never sees half a file
    build_seconds = time.perf_counter() - t0
    build_log = proc.stderr


def library() -> ctypes.CDLL:
    """The kernel library, built on first call."""
    global _lib
    with _lock:
        if _lib is None:
            path = library_path()
            if not path.exists():
                _build(path)
            lib = ctypes.CDLL(str(path))
            for name, (args, res) in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes, fn.restype = args, res
            _lib = lib
        return _lib


def check(code: int, what: str) -> None:
    """Raise if a launcher returned a CUDA error."""
    if code != 0:
        msg = library().gavit_error_string(code).decode()
        raise RuntimeError(f"{what} failed: CUDA error {code} ({msg})")


def dtype_code(dtype: torch.dtype) -> int:
    try:
        return _DTYPE_CODES[dtype]
    except KeyError:
        raise TypeError(f"the Hopper kernels take float32 or bfloat16, "
                        f"not {dtype}") from None


def stream(device: torch.device) -> int:
    """PyTorch's current stream on ``device``, with the library's own CUDA
    runtime switched to that device."""
    index = device.index if device.index is not None else torch.cuda.current_device()
    check(library().gavit_set_device(index), "cudaSetDevice")
    return torch.cuda.current_stream(device).cuda_stream


def check_impl(impl: str) -> None:
    """``'auto'``: the kernel for a CUDA tensor, the plain version for a CPU
    tensor. ``'reference'``: always the plain version."""
    if impl not in ("auto", "reference"):
        raise ValueError(f"impl must be 'auto' or 'reference', not {impl!r}")


def require_cuda(*tensors: torch.Tensor) -> None:
    """Device, contiguity and 16-byte alignment every launcher relies on."""
    dev = tensors[0].device
    if dev.type != "cuda":
        raise ValueError(f"the Hopper kernels take CUDA tensors, not {dev}")
    for t in tensors:
        if t.device != dev:
            raise ValueError(f"tensors on {t.device} and {dev}")
        if not t.is_contiguous():
            raise ValueError("the Hopper kernels take contiguous tensors")
        if t.data_ptr() % 16:
            raise ValueError("the Hopper kernels take 16-byte aligned tensors")
