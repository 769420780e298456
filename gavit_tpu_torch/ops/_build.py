"""Build and load the hand-written Hopper kernels (``gavit_tpu_torch/csrc``).

The sources export plain C launchers and include no PyTorch header. Each
``.cu`` file compiles in its own ``nvcc`` process, all started together, and
one more call links the objects into a shared library, which is then bound
with ``ctypes``. The library goes to ``build/gavit_tpu_torch/`` at
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
ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")
NVCC_FLAGS = (
    *ARCH_FLAGS, "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

# dtype codes of csrc/common.cuh
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

_P = ctypes.c_void_p
_I = ctypes.c_int
_U = ctypes.c_uint
_L = ctypes.c_longlong
_F = ctypes.c_float
_LP = ctypes.POINTER(ctypes.c_longlong)
_SIGNATURES = {
    "gavit_error_string": ((_I,), ctypes.c_char_p),
    "gavit_set_device": ((_I,), _I),
    "gavit_attention_fits": ((_I, _I), _I),
    "gavit_attention_fwd": ((_P, _P, _I, _I, _I, _I, _F, _I, _P), _I),
    "gavit_mlp_infer": ((_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _P), _I),
    "gavit_mlp_train_fwd": (
        (_P,) * 8 + (_I, _I, _I, _U, _U, _U, _U, _F, _U, _U, _F, _P), _I),
    "gavit_mlp_bwd_partial_rows": ((_I, _I), _I),
    "gavit_mlp_train_bwd": (
        (_P,) * 10 + (_I, _I, _I, _U, _U, _U, _U, _F, _U, _U, _F, _P), _I),
    "gavit_attention_bwd": (
        (_P, _P, _P, _P, _I, _I, _I, _I, _L, _L, _L, _F, _P), _I),
    "gavit_attention_bwd_f32": (
        (_P, _P, _P, _P, _I, _I, _I, _I, _L, _L, _L, _F, _P), _I),
    "gavit_attention_long_fwd": ((_P, _P, _I, _I, _I, _I, _F, _P), _I),
    "gavit_attention_long_bwd": (
        (_P, _P, _P, _P, _I, _I, _I, _I, _L, _L, _L, _F, _P), _I),
    "gavit_attention_bhnd_fwd": (
        (_P, _P, _P, _P, _LP, _I, _I, _I, _I, _F, _P), _I),
    "gavit_attention_bhnd_bwd": (
        (_P,) * 8 + (_LP, _I, _I, _I, _I, _F, _P), _I),
    "gavit_attention_large_fwd": ((_P, _P, _P, _I, _I, _I, _I, _F, _P), _I),
    "gavit_attention_large_bwd": (
        (_P,) * 6 + (_I,) * 4 + (_L,) * 6 + (_F, _P), _I),
    "gavit_dropout": ((_P, _P, _L, _U, _U, _U, _U, _F, _I, _P), _I),
    "gavit_dropout_add": ((_P, _P, _P, _L, _U, _U, _U, _U, _F, _I, _P), _I),
    "gavit_elementwise_step": ((_I, _I, _L), _L),
    "gavit_keep_masks": ((_P, _L, _P, _L, _U, _U, _U, _U, _U, _U, _P), _I),
    "gavit_gelu_dropout": ((_P, _P, _L, _U, _U, _U, _U, _F, _I, _P), _I),
    "gavit_gelu_dropout_bwd": (
        (_P, _P, _P, _L, _U, _U, _U, _U, _F, _I, _P), _I),
    "gavit_moe_fwd": (
        (_P,) * 9 + (_I,) * 6 + (_U, _U, _U, _U, _F, _U, _U, _F, _P), _I),
    "gavit_moe_bwd_partial_rows": ((_I, _I, _I), _I),
    "gavit_moe_bwd": (
        (_P,) * 13 + (_I,) * 6 + (_U, _U, _U, _U, _F, _U, _U, _F, _P), _I),
    "gavit_moe_tgmm": ((_P, _P, _P, _P, _I, _I, _I, _I, _P), _I),
    "gavit_gmm": ((_P, _P, _P, _P, _I, _I, _I, _I, _I, _P), _I),
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


# the modules whose ``*LAUNCHES`` globals count kernel (and int8 GEMM) calls
_COUNTED = ("attention", "dropout", "gmm", "graph_ops", "mlp", "moe_fused",
            "quant")


def launch_counts() -> dict:
    """Every launch counter of the ops modules, ``{(module, name): count}``:
    what a call launched is the difference of two reads."""
    import importlib

    with count_lock:
        return {(name, attr): val for name in _COUNTED
                for attr, val in vars(importlib.import_module(
                    f"gavit_tpu_torch.ops.{name}")).items()
                if attr.endswith("LAUNCHES")}


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
    """One nvcc process per source, all at once, then one link."""
    global build_log, build_seconds
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tag = f"{out.stem}.{os.getpid()}"
    nvcc = _nvcc()
    t0 = time.perf_counter()
    jobs = []
    for src in sorted(CSRC.glob("*.cu")):
        obj = BUILD_DIR / f"{tag}.{src.stem}.o"
        cmd = [nvcc, *NVCC_FLAGS, "-I", str(CSRC), "-c", "-o", str(obj),
               str(src)]
        jobs.append((cmd, obj, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)))
    logs, failed = [], []
    for cmd, _, proc in jobs:
        _, err = proc.communicate()
        logs.append(err)
        if proc.returncode != 0:
            failed.append(f"{' '.join(cmd)}\n{err}")
    try:
        if failed:
            raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
        tmp = out.with_name(f"{tag}.tmp")
        cmd = [nvcc, *ARCH_FLAGS, "-shared", "-o", str(tmp),
               *[str(obj) for _, obj, _ in jobs]]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc link failed with exit code "
                               f"{proc.returncode}:\n{' '.join(cmd)}\n"
                               f"{proc.stderr}")
        os.replace(tmp, out)  # atomic: a concurrent loader never sees half a file
    finally:
        for _, obj, _ in jobs:
            obj.unlink(missing_ok=True)
    build_seconds = time.perf_counter() - t0
    build_log = "".join(logs)


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


def strides(*tensors: torch.Tensor):
    """The (batch, head, row) strides of ``[B, H, N, d]`` tensors, flattened
    into the ``long long`` array the attention launchers take."""
    vals = [x for t in tensors for x in t.stride()[:3]]
    return (ctypes.c_longlong * len(vals))(*vals)


def aligned(t: torch.Tensor, *, rows: bool = False) -> torch.Tensor:
    """``t`` itself where a launcher can read it where it lies, else a fresh
    contiguous copy. ``rows=False``: contiguous and 16-byte aligned at its
    start (what :func:`require_cuda` asks). ``rows=True``, the attention
    tensor maps: the last dim contiguous, every leading stride a nonzero
    multiple of 16 bytes, the start 16-byte aligned. ``t.contiguous()``
    would not do: it returns a contiguous view at an unaligned offset
    unchanged."""
    if rows:
        lead = t.stride()[:-1]
        fits = t.stride(-1) == 1 and all(
            x and not x * t.element_size() % 16 for x in lead)
    else:
        fits = t.is_contiguous()
    if fits and not t.data_ptr() % 16:
        return t
    return t.clone(memory_format=torch.contiguous_format)


def require_device(*tensors: torch.Tensor) -> None:
    """All on one CUDA device: what a wrapper checks before it calls a
    kernel's custom op. It reads no data pointer, so it holds under
    ``torch.export``'s fake tensors too."""
    dev = tensors[0].device
    if dev.type != "cuda":
        raise ValueError(f"the Hopper kernels take CUDA tensors, not {dev}")
    for t in tensors:
        if t.device != dev:
            raise ValueError(f"tensors on {t.device} and {dev}")


def require_cuda(*tensors: torch.Tensor) -> None:
    """Device, contiguity and 16-byte alignment every launcher relies on."""
    require_device(*tensors)
    for t in tensors:
        if not t.is_contiguous():
            raise ValueError("the Hopper kernels take contiguous tensors")
        if t.data_ptr() % 16:
            raise ValueError("the Hopper kernels take 16-byte aligned tensors")
