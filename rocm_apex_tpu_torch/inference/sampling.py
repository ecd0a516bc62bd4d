"""Token sampling: greedy, temperature, top-k, top-p.

Port of ``rocm_apex_tpu/inference/sampling.py``. Filters compose in the
order temperature -> top-k -> top-p, and masked logits take -1e30
rather than -inf. Randomness comes from an explicit `torch.Generator`
(the JAX version takes a `jax.random` key): a fixed generator seed
replays the same token stream, but not the JAX package's stream.
"""

from typing import Optional

import torch

__all__ = ["greedy", "top_k_logits", "top_p_logits", "sample"]

_MASKED = -1e30


def greedy(logits: torch.Tensor) -> torch.Tensor:
    """Argmax token ids, int32."""
    return torch.argmax(logits, dim=-1).to(torch.int32)


def top_k_logits(logits: torch.Tensor, k: int) -> torch.Tensor:
    """Mask everything below the k-th largest logit per row."""
    if k <= 0:
        raise ValueError(f"top_k must be positive, got {k}")
    kth = torch.topk(logits, k, dim=-1).values[..., -1:]
    return torch.where(logits < kth, _MASKED, logits)


def top_p_logits(logits: torch.Tensor, p: float) -> torch.Tensor:
    """Nucleus filter: keep the smallest prefix of the
    probability-sorted vocabulary whose mass reaches ``p``. A sorted
    token is kept iff the mass strictly before it is < p, so the first
    token is always kept."""
    if not 0.0 < p <= 1.0:
        raise ValueError(f"top_p must be in (0, 1], got {p}")
    sorted_logits = torch.sort(logits, dim=-1, descending=True).values
    probs = torch.softmax(sorted_logits, dim=-1)
    mass_before = torch.cumsum(probs, dim=-1) - probs
    keep = mass_before < p
    thresh = torch.where(keep, sorted_logits, float("inf")).amin(
        dim=-1, keepdim=True
    )
    return torch.where(logits < thresh, _MASKED, logits)


def sample(
    logits: torch.Tensor,
    temperature: float = 1.0,
    top_k: Optional[int] = None,
    top_p: Optional[float] = None,
    generator: Optional[torch.Generator] = None,
) -> torch.Tensor:
    """Draw int32 token ids from ``(..., vocab)`` logits.
    ``temperature == 0`` is exact greedy and draws no random numbers;
    otherwise a Gumbel-max draw from ``generator`` (on the logits'
    device) picks from the filtered distribution."""
    logits = logits.float()
    if temperature == 0.0:
        return greedy(logits)
    logits = logits / float(temperature)
    if top_k is not None:
        logits = top_k_logits(logits, int(top_k))
    if top_p is not None and top_p < 1.0:
        logits = top_p_logits(logits, float(top_p))
    u = torch.rand(
        logits.shape, generator=generator, device=logits.device,
        dtype=torch.float32,
    )
    gumbel = -torch.log(-torch.log(u))
    return torch.argmax(logits + gumbel, dim=-1).to(torch.int32)
