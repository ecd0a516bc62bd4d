"""Fused label-smoothing softmax cross-entropy.

Port of ``rocm_apex_tpu/contrib/xentropy``: the reference's
``SoftmaxCrossEntropyLoss.apply`` API over `softmax_cross_entropy_loss`
(ops/xentropy.py: the forward kernel and the two-pass backward kernel).
"""

from rocm_apex_tpu_torch.ops.xentropy import softmax_cross_entropy_loss

__all__ = ["SoftmaxCrossEntropyLoss", "softmax_cross_entropy_loss"]


class SoftmaxCrossEntropyLoss:
    """Callable mirroring `SoftmaxCrossEntropyLoss.apply`: per-row
    smoothed losses (fp32) on (rows, vocab) logits; labels equal to
    ``padding_idx`` give zero loss and zero gradient. ``half_to_float``
    is accepted and ignored: losses are always fp32."""

    @staticmethod
    def apply(logits, labels, smoothing=0.0, padding_idx=0,
              half_to_float=True):
        del half_to_float
        return softmax_cross_entropy_loss(logits, labels, smoothing,
                                          padding_idx)

    def __call__(self, *args, **kw):
        return self.apply(*args, **kw)
