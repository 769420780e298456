"""Host-side pieces of the elementwise kernels (F, G, H, H′, E in
``gavit_tpu_torch/csrc/dropout.cu``) that run without a card:

* the identity behind the GELU's fused step in ``csrc/common.cuh``: the
  plain version's cdf = 0.5 * (1 + s * v) rounds once at the add (the
  product by s = ±1 and the halving are exact), and fma(v, s / 2, 1/2)
  rounded once gives the same fp32 bits, z = -0 taking s = +1;
* ``tools/sass_issue.py``'s count of one loop pass on a SASS listing: on at
  a conditional forward branch, along an unconditional one, up to the back
  edge, and the code before the loop for a kernel whose grid gives a
  thread one pass;
* kernel E's wrapper refusing what the launcher does not take.
"""

import sys
from fractions import Fraction
from pathlib import Path

import numpy as np
import pytest
import torch

from gavit_tpu_torch.ops import mlp as M

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "tools"))
import sass_issue  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One torch thread for the module: the test processes share the
    cores, and a pool of threads in each slows every one of them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _round_f32(value: Fraction) -> np.float32:
    """``value`` rounded to the nearest fp32, ties to even."""
    c = np.float32(float(value))
    cands = [np.nextafter(c, np.float32(-np.inf)), c,
             np.nextafter(c, np.float32(np.inf))]
    best = min(abs(Fraction(float(x)) - value) for x in cands)
    near = [x for x in cands if abs(Fraction(float(x)) - value) == best]
    return min(near, key=lambda x: int(x.view(np.uint32)) & 1)


def test_gelu_cdf_fused_step_keeps_every_bit():
    rng = np.random.default_rng(0)
    # v = 1 - p·e over its whole range: near 0 (z near 0), 1, and between
    v = np.concatenate([
        rng.random(1500, dtype=np.float32),
        np.float32(1) - rng.random(300, dtype=np.float32) * np.float32(1e-3),
        rng.random(300, dtype=np.float32) * np.float32(1e-5),
        np.array([0.0, 1.0, 0.5, 2.0 ** -24, 1 - 2.0 ** -24, 2.0 ** -30,
                  -(2.0 ** -24)], dtype=np.float32)])
    for z in (np.float32(-1.5), np.float32(2.0), np.float32(-0.0),
              np.float32(0.0)):
        s = np.float32(-1.0 if z < 0 else 1.0)
        two_step = np.float32(0.5) * (np.float32(1.0) + s * v)
        half = Fraction(-1, 2) if z < 0 else Fraction(1, 2)
        fused = np.array([_round_f32(Fraction(float(x)) * half
                                     + Fraction(1, 2)) for x in v],
                         dtype=np.float32)
        assert np.array_equal(two_step.view(np.uint32), fused.view(np.uint32))


# a kernel shaped as the walk: a prologue, then a loop whose pass skips a
# guarded store, jumps past a tail, and branches back
_SASS = """
        Function : _Z18elementwise_kernelILi1E13__nv_bfloat16E
        /*0000*/                   S2R R0, SR_TID.X ;
        /*0010*/                   ISETP.GE.AND P0, PT, R0, 0x10, PT ;
        /*0020*/               @P0 EXIT ;
        /*0030*/                   LDG.E.128 R4, desc[UR4][R2.64] ;
        /*0040*/                   FMUL R8, R4, 0.5 ;
        /*0050*/               @P1 BRA 0x80 ;
        /*0060*/                   STG.E.128 desc[UR4][R2.64], R4 ;
        /*0070*/                   BRA 0xb0 ;
        /*0080*/                   MOV R9, R8 ;
        /*0090*/                   NOP ;
        /*00a0*/                   FADD R9, R9, 1 ;
        /*00b0*/                   IADD3 R0, R0, 0x100, RZ ;
        /*00c0*/              @!P2 BRA 0x30 ;
        /*00d0*/                   EXIT ;
        /*00e0*/                   BRA 0xe0;
"""


def test_one_pass_follows_the_whole_unit_path(monkeypatch):
    monkeypatch.setattr(sass_issue.subprocess, "run",
                        lambda *a, **k: type("R", (), {"stdout": _SASS})())
    funcs = sass_issue.functions(Path("lib.so"))
    (code,) = funcs.values()
    assert len(code) == 14  # the NOP is left out
    # loop head 0x30: LDG, FMUL, @P1 BRA (on), STG, BRA 0xb0, IADD3, back
    # edge; the prologue: S2R, ISETP, @P0 EXIT
    assert sass_issue.one_pass(code) == (7, 3)


def test_keep_mask_kernel_refuses_what_the_launcher_does_not_take():
    with pytest.raises(ValueError, match="CUDA device"):
        M.keep_mask_kernel(1, [((2, 4), 1, 0.1)], torch.device("cpu"))
    with pytest.raises(ValueError, match="one or two masks"):
        M.keep_mask_kernel(1, [((2, 4), s, 0.1) for s in range(3)], "cpu")
