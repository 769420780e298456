"""The dropout bits of the port: Philox4x32-10, counter-based.

The TPU kernels seed the core's hardware generator with ``seed +
program_id`` (``gavit_tpu/ops/dropout.py:35``). On the H100 every dropout
kernel (F, and D/D′ for the MLP's two sites) draws from one counter-based
generator instead, so a mask is a pure function of
``(step seed, site, element index)`` and the backward regenerates the
forward's mask exactly, in any launch geometry:

* key = the per-step 64-bit seed, as ``(low 32 bits, high 32 bits)``;
* counter = ``(element index // 4, site, 0, 0)``; the four output words
  serve elements ``4i .. 4i+3`` of the flattened tensor, in order;
* keep = ``bits >= uint32(int(rate * 0xFFFFFFFF))`` — the TPU kernels' rule
  (``gavit_tpu/ops/dropout.py:37-39``, ``gavit_tpu/ops/mlp.py:124-126``).

Site ids number the dropout sites of a model in a fixed order
(``models/vit.py::dropout_sites``); the MLP's hidden and output masks get
different sites, as the JAX fallback's ``site`` argument does.

This module is the plain version: int64 tensor arithmetic masked to 32 bits,
so it gives the CUDA header's (``csrc/philox.cuh``) bits exactly, on any
device. Random123's known-answer vector holds it:
``philox4x32(0, 0, 0, 0, key=(0, 0))`` is ``6627e8d5 e169c58d bc57ac4c
9b00dbd8``.
"""

from __future__ import annotations

import torch

M0, M1 = 0xD2511F53, 0xCD9E8D57  # round multipliers
W0, W1 = 0x9E3779B9, 0xBB67AE85  # key bumps (golden ratio, sqrt(3) - 1)
ROUNDS = 10
_M32 = 0xFFFFFFFF
_M64 = 0xFFFFFFFFFFFFFFFF


def _mulhilo(m: int, x):
    """(high, low) 32-bit words of ``m * x`` for 32-bit ``m`` and int64
    tensors ``x`` < 2^32, without overflowing int64: x is split in 16-bit
    halves, so each partial product stays below 2^48."""
    a = m * (x & 0xFFFF)
    b = m * (x >> 16)
    lo = (((b & 0xFFFF) << 16) + a) & _M32
    hi = (b + (a >> 16)) >> 16
    return hi, lo


def philox4x32(c0, c1, c2, c3, k0: int, k1: int):
    """Philox4x32-10 of the counter words (int64 tensors < 2^32, or ints)
    under the key ``(k0, k1)``; four int64 tensors of 32-bit words."""
    c0, c1, c2, c3 = (torch.as_tensor(c, dtype=torch.int64)
                      for c in (c0, c1, c2, c3))
    for _ in range(ROUNDS):
        hi0, lo0 = _mulhilo(M0, c0)
        hi1, lo1 = _mulhilo(M1, c2)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
        k0, k1 = (k0 + W0) & _M32, (k1 + W1) & _M32
    return c0, c1, c2, c3


def split_seed(seed: int) -> tuple[int, int]:
    """A 64-bit seed as the Philox key ``(low, high)``."""
    seed &= _M64
    return seed & _M32, seed >> 32


def bits(numel: int, seed: int, site: int, device=None):
    """The 32-bit words of elements ``0 .. numel-1`` of a site, as int64."""
    k0, k1 = split_seed(seed)
    groups = torch.arange((numel + 3) // 4, dtype=torch.int64, device=device)
    zero = torch.zeros_like(groups)
    words = philox4x32(groups, zero + (site & _M32), zero, zero, k0, k1)
    return torch.stack(words, dim=-1).reshape(-1)[:numel]


def threshold(rate: float) -> int:
    """The uint32 below which an element is dropped."""
    return int(rate * 0xFFFFFFFF)


def keep_mask(shape, seed: int, site: int, rate: float, device=None):
    """Boolean keep-mask of a tensor of ``shape`` (row-major elements)."""
    numel = 1
    for s in shape:
        numel *= int(s)
    return (bits(numel, seed, site, device) >= threshold(rate)).reshape(shape)


def _splitmix64(x: int) -> int:
    x = (x + 0x9E3779B97F4A7C15) & _M64
    x = ((x ^ (x >> 30)) * 0xBF58476D1CE4E5B9) & _M64
    x = ((x ^ (x >> 27)) * 0x94D049BB133111EB) & _M64
    return x ^ (x >> 31)


def step_seed(seed: int, step: int) -> int:
    """The 64-bit dropout seed of training step ``step`` under the run's
    ``seed`` (two rounds of splitmix64: neighbouring steps get unrelated
    keys)."""
    return _splitmix64(_splitmix64(seed & _M64) ^ (step & _M64))
