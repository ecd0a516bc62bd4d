"""Segmented multi-LoRA delta: a per-token gather and two batched
contractions over a packed adapter pool (Punica arXiv 2310.18547 BGMV,
S-LoRA arXiv 2311.03285).

Port of ``rocm_apex_tpu/ops/lora.py``. The JAX function is plain
``jnp`` (a ``take`` and two ``einsum``s, no Pallas kernel), and so is
this one: ``index_select`` plus ``einsum`` in fp32, as JAX computes it.

    delta[t] = (x[t] @ A[ids[t]]) @ B[ids[t]]        # (t, o)

The contraction runs through the rank bottleneck first (``tmp`` is
``(t, r)``), so the only gathered intermediates are the ``(t, h, r)``
and ``(t, r, o)`` per-token factor views: linear in tokens, never a
dense ``(h, o)`` delta and never a ``(P, ...)`` broadcast.

Pool slot 0 is the base model: its factors are zeros, so a base token
riding a mixed batch receives an exact ``+0.0``. JAX's `apply_lora`
skips the gathers under a ``lax.cond`` on a traced flag; the port's
``active`` is a HOST boolean, since the engine knows each tick's ids
before it uploads them: a pure-base tick launches no adapter work and
reads no device value to decide so.
"""

from typing import Tuple

import numpy as np
import torch

__all__ = ["segmented_lora_delta", "apply_lora", "pad_rank"]


def pad_rank(a, b, max_rank: int, alpha: float = None):
    """Pad one adapter's host factors to the pool's uniform rank.

    ``a``: (h, r) down-projection; ``b``: (r, o) up-projection. Returns
    the ``(h, max_rank)`` / ``(max_rank, o)`` fp32 numpy pair, zero-padded
    along the rank axis (exact: padding adds ``x @ 0``). The LoRA scale
    ``alpha / r`` (default ``alpha = r``, scale 1) is folded into ``b``
    here, once at registration."""
    a = np.asarray(a, np.float32)
    b = np.asarray(b, np.float32)
    if a.ndim != 2 or b.ndim != 2 or a.shape[1] != b.shape[0]:
        raise ValueError(
            f"adapter factors must be (h, r)/(r, o) with matching "
            f"rank, got {a.shape} / {b.shape}"
        )
    r = a.shape[1]
    if r > max_rank:
        raise ValueError(
            f"adapter rank {r} exceeds the pool max_rank {max_rank}"
        )
    scale = (float(alpha) if alpha is not None else float(r)) / float(r)
    a_p = np.zeros((a.shape[0], max_rank), np.float32)
    b_p = np.zeros((max_rank, b.shape[1]), np.float32)
    a_p[:, :r] = a
    b_p[:r, :] = b * scale
    return a_p, b_p


def segmented_lora_delta(x: torch.Tensor, A: torch.Tensor, B: torch.Tensor,
                         ids: torch.Tensor) -> torch.Tensor:
    """``(x[t] @ A[ids[t]]) @ B[ids[t]]`` in fp32.

    ``x``: (t, h) packed token activations; ``A``: (P, h, r) / ``B``:
    (P, r, o) rank-padded pool; ``ids``: (t,) integer pool slot per
    token (0 = base, zeros). Returns the (t, o) delta in fp32; the
    caller casts it onto its stream dtype."""
    ids = ids.long()
    xf = x.to(torch.float32)
    Ag = A.index_select(0, ids)                      # (t, h, r)
    tmp = torch.einsum("th,thr->tr", xf, Ag)         # rank bottleneck
    Bg = B.index_select(0, ids)                      # (t, r, o)
    return torch.einsum("tr,tro->to", tmp, Bg)       # (t, o)


def apply_lora(y: torch.Tensor, x: torch.Tensor, pair: Tuple,
               ids: torch.Tensor, active: bool) -> torch.Tensor:
    """Add the segmented delta onto a projection output.

    ``y``: (b, s, o) projection output; ``x``: (b, s, h) the same input
    the projection consumed; ``pair``: (A, B) pool factors of this
    layer; ``ids``: (b*s,) per-token pool slots; ``active``: host bool,
    True iff any id != 0 this call. False returns ``y`` untouched and
    launches nothing."""
    if not active:
        return y
    A, B = pair
    b, s, o = y.shape
    d = segmented_lora_delta(x.reshape(b * s, -1), A, B, ids)
    return y + d.reshape(b, s, o).to(y.dtype)
