"""The port's one dropout keep-mask function, in PyTorch.

The counterpart of ``_keep_mask`` (rocm_apex_tpu/ops/flash_attention.py:85).
The TPU kernels seed the hardware PRNG per (batch, q-block, k-block), so
their bits depend on the tiling and cannot be reproduced. The port keeps
an element of a (rows, cols) matrix iff

    hash32(seed, stream, row, col) >= threshold(rate)

where hash32 folds the coordinates into the seed with murmur3's block mix
and finishes with its fmix32 avalanche. ``csrc/dropout.cuh`` is the same
function in CUDA; the plain versions of the kernels call this one, so a
kernel with dropout on must match its plain version exactly. Coordinates
are per element, so a forward and a backward with different tilings
draw the same bits. ``stream`` is batch*heads + head for attention and 0
for LayerNorm.

Arithmetic is on int64 tensors holding uint32 values; products are split
into 16-bit halves so nothing overflows 64 bits.
"""

from typing import Optional

import torch

__all__ = [
    "threshold",
    "keep_scale",
    "row_key",
    "keep_mask",
    "hash32",
]

_MASK = 0xFFFFFFFF


def threshold(rate: float) -> int:
    """The uint32 cut: an element is kept iff its hash is >= this."""
    if not 0.0 <= rate < 1.0:
        raise ValueError(f"dropout rate must be in [0, 1), got {rate}")
    return min(int(round(rate * 2.0**32)), _MASK)


def keep_scale(rate: float) -> float:
    return 1.0 / (1.0 - rate)


def _mul(a, c: int):
    """(a * c) mod 2^32 for uint32 values a (an int or int64 tensor)."""
    lo = a * (c & 0xFFFF)
    hi = (a * (c >> 16)) & 0xFFFF
    return (lo + (hi << 16)) & _MASK


def _rotl(x, r: int):
    return ((x << r) | (x >> (32 - r))) & _MASK


def _mix(h, k):
    k = _mul(k, 0xCC9E2D51)
    k = _rotl(k, 15)
    k = _mul(k, 0x1B873593)
    h = h ^ k
    h = _rotl(h, 13)
    return (_mul(h, 5) + 0xE6546B64) & _MASK


def _fmix(h):
    h = h ^ (h >> 16)
    h = _mul(h, 0x85EBCA6B)
    h = h ^ (h >> 13)
    h = _mul(h, 0xC2B2AE35)
    return h ^ (h >> 16)


def row_key(seed: int, stream, row):
    """The row part of the hash (an int, or a tensor broadcasting
    ``stream`` against ``row``)."""
    return _mix(_mix(int(seed) & _MASK, stream), row)


def hash32(seed: int, stream, row, col):
    """The full hash of element (row, col) of ``stream`` (ints or int64
    tensors that broadcast)."""
    return _fmix(_mix(row_key(seed, stream, row), col))


def keep_mask(seed: int, rate: float, shape, stream=0,
              device: Optional[torch.device] = None) -> torch.Tensor:
    """The bool keep mask of a ``(..., rows, cols)`` matrix: element
    (s, r, c) of the leading-dims-flattened view uses stream ``stream + s``
    (so for attention's (B*nh, S, S) scores, stream = b*nh + h)."""
    *lead, rows, cols = shape
    n = 1
    for d in lead:
        n *= d
    streams = torch.arange(n, dtype=torch.int64, device=device) + stream
    r = torch.arange(rows, dtype=torch.int64, device=device)
    c = torch.arange(cols, dtype=torch.int64, device=device)
    key = row_key(seed, streams[:, None, None], r[None, :, None])
    keep = _fmix(_mix(key, c[None, None, :])) >= threshold(rate)
    return keep.reshape(shape)
