"""NHWC convolution and BatchNorm with flax's semantics, for the ResNet
family and the contrib bottleneck.

`BatchNorm` is ``flax.linen.BatchNorm`` over the last (channel) axis,
written out: the statistics in fp32 with the fast variance E[x²] - E[x]²
clipped at 0, the normalize ``(x - mean) * (rsqrt(var + eps) * scale) +
bias`` in fp32 cast to ``dtype``, and the running statistics ``ra <-
momentum * ra + (1 - momentum) * batch`` with the BIASED batch variance.
``torch.nn.BatchNorm2d`` stores the unbiased variance and reads momentum
the other way round, so it is not used. The running statistics are
buffers (``mean``, ``var``) updated in place in training, as the JAX
models return them from the ``batch_stats`` collection.

`Conv` is ``flax.linen.Conv`` without bias on NHWC maps: the input and
the kernel cast to ``dtype``, the kernel kept OIHW for ``F.conv2d`` (the
weight bridge transposes flax's HWIO), the NHWC input read through its
(N, C, H, W) ``channels_last`` view, so no copy is made. The JAX package
leaves these convolutions to XLA outside any Pallas kernel, so here they
are library calls.

Parameters start as flax's initializers draw them in distribution (the
JAX models' values come through `convert.resnet_from_jax_variables`):
a normal of variance gain / fan_in (lecun 1, he 2; flax truncates the
normal and rescales it to the same variance), BN scale 1 and bias 0.
"""

import math
from typing import Optional, Sequence, Union

import torch
import torch.nn.functional as F
from torch import nn

__all__ = ["BatchNorm", "Conv", "init_kernel"]


def init_kernel(shape: Sequence[int], fan_in: int, gain: float,
                generator: Optional[torch.Generator],
                device=None) -> torch.Tensor:
    """An fp32 kernel of ``shape`` drawn normal(0, gain / fan_in) on the
    CPU from ``generator`` (seeded by the caller), moved to ``device``."""
    t = torch.randn(tuple(shape), generator=generator, dtype=torch.float32)
    return (t * math.sqrt(gain / fan_in)).to(device)


class BatchNorm(nn.Module):
    """``flax.linen.BatchNorm(momentum, epsilon, dtype)`` on the last
    axis: parameters ``scale``, ``bias``; buffers ``mean``, ``var``."""

    def __init__(self, features: int, momentum: float = 0.99,
                 epsilon: float = 1e-5, dtype: torch.dtype = torch.float32,
                 device=None):
        super().__init__()
        self.momentum = momentum
        self.epsilon = epsilon
        self.dtype = dtype
        self.scale = nn.Parameter(torch.ones(features, device=device))
        self.bias = nn.Parameter(torch.zeros(features, device=device))
        self.register_buffer("mean", torch.zeros(features, device=device))
        self.register_buffer("var", torch.ones(features, device=device))

    def forward(self, x: torch.Tensor, train: bool = True) -> torch.Tensor:
        if train:
            xf = x.float()
            dims = tuple(range(x.dim() - 1))
            mean = xf.mean(dims)
            var = torch.clamp_min((xf * xf).mean(dims) - mean * mean, 0.0)
            with torch.no_grad():
                m = self.momentum
                self.mean.copy_(m * self.mean + (1 - m) * mean)
                self.var.copy_(m * self.var + (1 - m) * var)
        else:
            mean, var = self.mean, self.var
        y = x - mean
        y = y * (torch.rsqrt(var + self.epsilon) * self.scale) + self.bias
        return y.to(self.dtype)


def _pair(v: Union[int, Sequence[int]]):
    return (v, v) if isinstance(v, int) else tuple(v)


class Conv(nn.Module):
    """``flax.linen.Conv(features, kernel_size, strides, padding,
    use_bias=False, dtype)`` on NHWC maps; ``kernel`` (O, I, kh, kw).
    ``padding`` is symmetric per spatial axis (flax's int form; a 1x1
    conv's SAME is 0 at any stride)."""

    def __init__(self, in_features: int, features: int,
                 kernel_size: Union[int, Sequence[int]] = 1,
                 strides: Union[int, Sequence[int]] = 1,
                 padding: Union[int, Sequence[int]] = 0,
                 dtype: torch.dtype = torch.float32, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        kh, kw = _pair(kernel_size)
        self.strides = _pair(strides)
        self.padding = _pair(padding)
        self.dtype = dtype
        w = init_kernel((kh, kw, in_features, features),
                        kh * kw * in_features, 1.0, generator, device)
        self.kernel = nn.Parameter(w.permute(3, 2, 0, 1).contiguous())

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        w = self.kernel.to(dtype=self.dtype,
                           memory_format=torch.channels_last)
        y = F.conv2d(x.to(self.dtype).permute(0, 3, 1, 2), w,
                     stride=self.strides, padding=self.padding)
        return y.permute(0, 2, 3, 1)
