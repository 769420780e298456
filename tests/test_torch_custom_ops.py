"""The serving kernels' custom ops (``gavit_tpu_torch::*``) on the CPU: the
seven ops are registered by importing ``gavit_tpu_torch.ops``, each runs on
CUDA tensors only, its fake implementation gives the shape, dtype and
strides of the launch's output (the wrappers' views, such as kernel A's
``[B, H, N, d]`` over ``[B, N, H, d]`` memory, stand on them), and
``torch.export`` traces each wrapper to its op over fake CUDA tensors
(kernels K, L, M and N-gmm over bf16 and over fp32 rows, which their ops
dispatch by dtype inside the launch). The
card holds each fake to its kernel with ``torch.library.opcheck``
(``tests/test_torch_cuda.py``). At most 3 tests a file (see
``tests/test_torch_export.py``)."""

import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode

import gavit_tpu_torch.ops  # noqa: F401  (registers the ops)
from gavit_tpu_torch.ops import attention as A
from gavit_tpu_torch.ops import gmm as G
from gavit_tpu_torch.ops import graph_ops as C
from gavit_tpu_torch.ops import mlp as B
from gavit_tpu_torch.ops import moe_fused as M

@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One torch thread for the module: the test processes share the
    cores, and a pool of threads in each slows every one of them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


OPS = ("attention_fwd", "attention_long_fwd", "attention_large_fwd",
       "mlp_infer", "graph_fwd", "moe_fwd", "gmm")
BF16 = torch.bfloat16
F32 = torch.float32


def calls(b=2, n=17, heads=2, d=64, cap=32, e=4, f=256):
    """Each wrapper on the inputs of one launch, and the ``(shape, dtype,
    stride)`` of what it returns on the card: contiguous outputs, and the
    attention forwards' transposed views of ``[B, N, H, d]`` memory."""
    dim = heads * d
    qkv = torch.empty(b, n, 3 * dim, dtype=BF16, device="cuda")
    o = ((b, heads, n, d), BF16, (n * dim, d, dim, 1))
    qkv32 = torch.empty(b, n, 3 * dim, dtype=torch.float32, device="cuda")
    o32 = ((b, heads, n, d), torch.float32, (n * dim, d, dim, 1))
    x = torch.empty(b * n, dim, dtype=BF16, device="cuda")
    tok = torch.empty(b, n, dim, dtype=BF16, device="cuda")
    xs = torch.empty(cap, dim, dtype=BF16, device="cuda")
    w1 = torch.empty(e, dim, f, dtype=BF16, device="cuda")
    w2 = torch.empty(e, f, dim, dtype=BF16, device="cuda")
    xs32 = torch.empty(cap, dim, device="cuda")
    w1_32 = torch.empty(e, dim, f, device="cuda")
    w2_32 = torch.empty(e, f, dim, device="cuda")
    sizes = torch.empty(e, dtype=torch.int32, device="cuda")
    tiles = torch.empty(cap // 8, dtype=torch.int32, device="cuda")

    def rows(shape, dtype=BF16):
        strides, acc = [], 1
        for s in reversed(shape):
            strides.insert(0, acc)
            acc *= s
        return tuple(shape), dtype, tuple(strides)

    return {
        "attention_fwd": (lambda: A.qkv_attention_kernel(qkv, 0.125, heads),
                          [o]),
        "attention_long_fwd": (
            lambda: A.qkv_attention_long_kernel(qkv, 0.125, heads), [o]),
        "attention_large_fwd": (
            lambda: A.qkv_attention_large_kernel(qkv, 0.125, heads),
            [o, rows((b, heads, n), torch.float32)]),
        "attention_long_fwd fp32": (
            lambda: A.qkv_attention_long_kernel(qkv32, 0.125, heads), [o32]),
        "attention_large_fwd fp32": (
            lambda: A.qkv_attention_large_kernel(qkv32, 0.125, heads),
            [o32, rows((b, heads, n), torch.float32)]),
        "mlp_infer": (lambda: B.mlp_inference_kernel(
            x, torch.empty(f, dim, dtype=BF16, device="cuda"),
            torch.empty(f, dtype=BF16, device="cuda"),
            torch.empty(dim, f, dtype=BF16, device="cuda"),
            torch.empty(dim, dtype=BF16, device="cuda"), True),
            [rows((b * n, dim))]),
        "graph_fwd": (lambda: C.graph_aggregate_kernel(
            tok, tok.clone(), "knn", 4, 0.0, 1.0, return_adjacency=True),
            [rows((b, n, dim)), rows((b, n, n), torch.float32)]),
        "moe_fwd": (lambda: M.moe_fwd_kernel(
            xs, w1, torch.empty(e, f, dtype=BF16, device="cuda"), w2,
            torch.empty(e, dim, dtype=BF16, device="cuda"), tiles, 8, 1 << 63,
            (3, 4), 0.0, 0.0, True, sizes),
            [rows((cap, dim)), rows((cap, f))]),
        "gmm": (lambda: G.gmm_kernel(xs, w1, sizes), [rows((cap, f))]),
        "moe_fwd fp32": (lambda: M.moe_fwd_kernel(
            xs32, w1_32, torch.empty(e, f, device="cuda"), w2_32,
            torch.empty(e, dim, device="cuda"), tiles, 8, 1 << 63, (3, 4),
            0.0, 0.0, False, sizes),
            [rows((cap, dim), F32), rows((cap, f), F32)]),
        "gmm fp32": (lambda: G.gmm_kernel(xs32, w1_32, sizes),
                     [rows((cap, f), F32)]),
    }


def test_ops_are_registered_and_take_cuda_tensors_only():
    for name in OPS:
        op = getattr(torch.ops.gavit_tpu_torch, name)
        assert op.default._schema.name == f"gavit_tpu_torch::{name}"
    qkv = torch.zeros(1, 5, 3 * 64)
    with pytest.raises(NotImplementedError, match="CPU"):
        torch.ops.gavit_tpu_torch.attention_fwd(qkv, 0.125, 1)
    with pytest.raises(ValueError, match="CUDA"):
        A.qkv_attention_kernel(qkv, 0.125, 1)


def test_fakes_give_the_launch_outputs():
    with FakeTensorMode():
        cases = calls()
        for name, (call, want) in cases.items():
            got = call()
            got = list(got) if isinstance(got, tuple) else [got]
            meta = [(tuple(t.shape), t.dtype, t.stride()) for t in got]
            assert meta == want, name
            assert all(t.device.type == "cuda" for t in got), name


def test_export_traces_each_wrapper_to_its_op():
    """One program calling every wrapper: its graph calls each op once a
    case (K's, L's, M's and N-gmm's twice: bf16 and fp32 rows) and no plain version (no
    matmul, softmax or sort of the plain paths)."""
    with FakeTensorMode():
        cases = calls()

    class Every(torch.nn.Module):
        def forward(self, dummy):
            outs = []
            for call, _ in cases.values():
                got = call()
                outs.extend(got if isinstance(got, tuple) else [got])
            return tuple(outs)

    with FakeTensorMode():
        dummy = torch.empty(1, device="cuda")
    with torch.no_grad():
        code = torch.export.export(Every(), (dummy,)).graph_module.code
    for name in OPS:
        want = sum(case.split()[0] == name for case in cases)
        assert code.count(f"torch.ops.gavit_tpu_torch.{name}.default(") \
            == want, name
    for plain in ("aten.matmul", "aten.bmm", "aten.mm", "aten._softmax",
                  "aten.sort"):
        assert plain not in code, plain
