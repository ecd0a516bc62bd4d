"""Model-FLOPs accounting, shared by `MetricsLogger` and callers.

Port of ``rocm_apex_tpu/monitor/flops.py``. The transformer formula,
per train step (fwd + bwd ~ 3x fwd):

    6·N·B·s                      dense param math over the
                                 NON-embedding params N
  + 12·L·B·s²·h                  attention scores + context matmuls
  + 6·B·s·h·V                    the LM-head projection trio on the
                                 tied table (fwd + dW + dx), dense
                                 matmul work credited explicitly

``n_params`` is the non-embedding count: subtract ``V·h`` (the tied
table) from the raw leaf count, which is what `transformer_train_flops`
does when handed ``raw_param_count``.
"""

from typing import Optional

__all__ = [
    "peak_flops_per_chip",
    "transformer_train_flops",
    "model_flops",
    "resnet50_train_flops",
    "mfu",
]

# dense bf16 peak FLOP/s per card, keyed by (a lowercase substring of)
# what `torch.cuda.get_device_name()` returns: NVIDIA's H100 SXM figure,
# the PEAK_OPS[torch.bfloat16] chip_smoke.py bounds its kernels with (the card
# it was measured on reports "NVIDIA H100 80GB HBM3, 700.00 W")
_PEAKS = {
    "nvidia h100 80gb hbm3": 989e12,
}


def peak_flops_per_chip(device_kind: Optional[str] = None) -> float:
    """Best-effort dense bf16 peak for ``device_kind`` (default: the
    current CUDA device's name, "cpu" without one). Unknown kinds, the
    CPU among them, get a nominal 1e12 so MFU-shaped arithmetic stays
    finite without claiming a real roofline."""
    if device_kind is None:
        import torch

        device_kind = (torch.cuda.get_device_name()
                       if torch.cuda.is_available() else "cpu")
    device_kind = device_kind.lower()
    for key, peak in _PEAKS.items():
        if key in device_kind:
            return peak
    return 1e12


def transformer_train_flops(
    *,
    batch: int,
    seq: int,
    hidden_size: int,
    num_layers: int,
    vocab_size: int,
    n_params: Optional[int] = None,
    raw_param_count: Optional[int] = None,
    include_head: bool = True,
) -> float:
    """Megatron-style train-step model FLOPs (see module docstring).

    Pass EITHER ``n_params`` (non-embedding) or ``raw_param_count``
    (every leaf; the tied ``V·h`` table is subtracted here).
    ``include_head=False`` drops the 6·B·s·h·V logit-trio term (the
    "sans-head" crediting).
    """
    if (n_params is None) == (raw_param_count is None):
        raise ValueError(
            "pass exactly one of n_params (non-embedding) or "
            "raw_param_count (all leaves)"
        )
    if n_params is None:
        n_params = raw_param_count - vocab_size * hidden_size
    flops = (
        6.0 * n_params * batch * seq
        + 12.0 * num_layers * batch * seq * seq * hidden_size
    )
    if include_head:
        flops += 6.0 * batch * seq * hidden_size * vocab_size
    return flops


def model_flops(
    config,
    batch: int,
    seq: int,
    *,
    n_params: Optional[int] = None,
    raw_param_count: Optional[int] = None,
    include_head: bool = True,
) -> float:
    """`transformer_train_flops` with the shape fields read off a
    `GPTConfig`/`BertConfig`-style dataclass (anything exposing
    ``hidden_size``/``num_layers``/``vocab_size``)."""
    return transformer_train_flops(
        batch=batch,
        seq=seq,
        hidden_size=config.hidden_size,
        num_layers=config.num_layers,
        vocab_size=config.vocab_size,
        n_params=n_params,
        raw_param_count=raw_param_count,
        include_head=include_head,
    )


def resnet50_train_flops(batch: int) -> float:
    """RN50 train ≈ 3 × 4.1 GFLOPs fwd per image at 224×224."""
    return 12.3e9 * batch


def mfu(
    flops: float,
    step_seconds: float,
    *,
    n_chips: int = 1,
    peak: Optional[float] = None,
) -> float:
    """Model-FLOPs utilization: achieved model FLOP/s over the
    aggregate peak of ``n_chips`` chips."""
    if step_seconds <= 0.0:
        return 0.0
    if peak is None:
        peak = peak_flops_per_chip()
    return (flops / step_seconds) / (peak * n_chips)
