"""ResNet family on NHWC maps, with the fused bottleneck for training.

Port of ``rocm_apex_tpu/models/resnet.py``: `ResNet`, `BasicBlock`,
`Bottleneck`, `FoldedConvBN` and `resnet_tiny`, `resnet18`, `resnet34`,
`resnet50`, `resnet101`. NHWC in, logits out, BatchNorm with flax's
semantics (`models/_layers.py`), the running statistics buffers that
training moves in place.

Parameter and buffer names are the flax tree's paths joined with ``.``
(``conv1.kernel``, ``layer1_0.bn1.scale``, ``layer2_0.downsample_conv.
kernel``, ``fc.kernel``; the batch statistics ``layer1_0.bn1.mean``), so
amp's batch-norm rule reads the same names in both packages. Layouts:
`Conv` kernels are OIHW (flax: HWIO), ``fc.kernel`` is (out, in) (flax:
(in, out)); `FoldedConvBN` and the fused blocks keep flax's layouts.
`convert.resnet_from_jax_variables` carries a flax ResNet's variables
over.

``fused=True`` runs every stride-1 bottleneck of a `Bottleneck` net in
training through `contrib.bottleneck.FusedBottleneck` (the hand-written
conv+BN kernels); the stem, the stride-2 blocks (``layer2_0``,
``layer3_0``, ``layer4_0`` in ResNet-50) and `FoldedConvBN` stay on
``F.conv2d`` and plain ops, as the JAX package leaves them to XLA.
``sync_bn_axis`` names the axis whose ranks share the batch statistics:
every norm is then `parallel.SyncBatchNorm(momentum=0.1,
channel_last=True)` (torch's momentum, the unbiased running variance,
JAX `_norm`), and, as in JAX, ``fused`` and ``fold_downsample`` are off
(the fused kernels and the fold take their statistics from this rank's
batch only).
"""

import functools
from typing import Any, Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from rocm_apex_tpu_torch._device import resolve_device
from rocm_apex_tpu_torch.models._layers import BatchNorm, Conv, init_kernel
from rocm_apex_tpu_torch.parallel import SyncBatchNorm

__all__ = [
    "ResNet",
    "BasicBlock",
    "Bottleneck",
    "FoldedConvBN",
    "resnet_tiny",
    "resnet18",
    "resnet34",
    "resnet50",
    "resnet101",
]

# flax nn.BatchNorm's own defaults, which a FoldedConvBN built alone
# reproduces; the ResNet's norm passes 0.9 and 1e-5 (JAX `_norm`)
FLAX_BN_MOMENTUM, FLAX_BN_EPSILON = 0.99, 1e-5
RESNET_BN_MOMENTUM, RESNET_BN_EPSILON = 0.9, 1e-5
# SyncBatchNorm's momentum is torch's: the weight of the new statistic
SYNC_BN_MOMENTUM = 0.1


def _norm(sync_bn_axis, dtype, device):
    """The blocks' norm (JAX `_norm`): flax BatchNorm, or SyncBatchNorm
    over ``sync_bn_axis``."""
    if sync_bn_axis is not None:
        return functools.partial(SyncBatchNorm, momentum=SYNC_BN_MOMENTUM,
                                 axis_name=sync_bn_axis, channel_last=True,
                                 dtype=dtype, device=device)
    return functools.partial(BatchNorm, momentum=RESNET_BN_MOMENTUM,
                             epsilon=RESNET_BN_EPSILON, dtype=dtype,
                             device=device)


def _is_plain_bn(norm) -> bool:
    """The plain BatchNorm partial: the fold's moment identities would
    need the axis's sums under SyncBatchNorm (JAX `_is_plain_bn`)."""
    return getattr(norm, "func", None) is BatchNorm


class FoldedConvBN(nn.Module):
    """1x1 conv + training-mode BatchNorm on a no-ReLU edge in one pass
    over the input: the statistics of z = xs W come from the input's
    moments (mean_z = mean_x W, var_z = diag(W^T G W) / T - mean_z^2, G =
    xs^T xs), so gamma * rsqrt(var + eps) folds into W and the conv
    output is never materialized. Evaluation folds the running
    statistics. ``conv_kernel`` keeps flax's (1, 1, Cin, F) layout."""

    def __init__(self, in_features: int, features: int, strides: int = 1,
                 dtype: torch.dtype = torch.float32,
                 momentum: float = FLAX_BN_MOMENTUM,
                 epsilon: float = FLAX_BN_EPSILON, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.features, self.strides = features, strides
        self.dtype, self.momentum, self.epsilon = dtype, momentum, epsilon
        self.conv_kernel = nn.Parameter(init_kernel(
            (1, 1, in_features, features), in_features, 1.0, generator,
            device))
        self.bn_scale = nn.Parameter(torch.ones(features, device=device))
        self.bn_bias = nn.Parameter(torch.zeros(features, device=device))
        self.register_buffer("mean", torch.zeros(features, device=device))
        self.register_buffer("var", torch.ones(features, device=device))

    def forward(self, x: torch.Tensor, train: bool = True) -> torch.Tensor:
        s = self.strides
        xs = x[:, ::s, ::s, :] if s > 1 else x
        cin = xs.shape[-1]
        w = self.conv_kernel.reshape(cin, self.features).float()
        if not train:
            mean, var = self.mean, self.var
        else:
            x2 = xs.reshape(-1, cin).float()
            t = x2.shape[0]
            gram = x2.t() @ x2
            mean = x2.mean(0) @ w
            var = torch.clamp_min((w * (gram @ w)).sum(0) / t - mean * mean,
                                  0.0)
            with torch.no_grad():
                m = self.momentum
                self.mean.copy_(m * self.mean + (1.0 - m) * mean)
                self.var.copy_(m * self.var + (1.0 - m) * var)
        mul = self.bn_scale * torch.rsqrt(var + self.epsilon)
        w_fold = (w * mul[None, :]).to(self.dtype)
        b_fold = self.bn_bias - mul * mean
        y = xs.to(self.dtype).float() @ w_fold.float() + b_fold
        return y.to(self.dtype)


def _downsample(block, in_features, features, strides, norm, dtype,
                fold, kw):
    if fold and _is_plain_bn(norm):
        block.downsample_fold = FoldedConvBN(
            in_features, features, strides, dtype=dtype,
            momentum=norm.keywords["momentum"],
            epsilon=norm.keywords["epsilon"], **kw)
    else:
        block.downsample_conv = Conv(in_features, features, 1, strides,
                                     dtype=dtype, **kw)
        block.downsample_bn = norm(features)


def _residual(block, residual, train):
    if hasattr(block, "downsample_fold"):
        return block.downsample_fold(residual, train)
    if hasattr(block, "downsample_conv"):
        return block.downsample_bn(block.downsample_conv(residual), train)
    return residual


class BasicBlock(nn.Module):
    expansion = 1

    def __init__(self, in_features: int, filters: int, strides: int = 1,
                 norm: Any = None, dtype: torch.dtype = torch.float32,
                 fold_downsample: bool = False, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        kw = dict(device=device, generator=generator)
        self.conv1 = Conv(in_features, filters, 3, strides, 1, dtype=dtype,
                          **kw)
        self.bn1 = norm(filters)
        self.conv2 = Conv(filters, filters, 3, 1, 1, dtype=dtype, **kw)
        self.bn2 = norm(filters)
        if strides != 1 or in_features != filters:
            _downsample(self, in_features, filters, strides, norm, dtype,
                        fold_downsample, kw)

    def forward(self, x: torch.Tensor, train: bool = True) -> torch.Tensor:
        y = torch.relu(self.bn1(self.conv1(x), train))
        y = self.bn2(self.conv2(y), train)
        return torch.relu(y + _residual(self, x, train))


class Bottleneck(nn.Module):
    expansion = 4

    def __init__(self, in_features: int, filters: int, strides: int = 1,
                 norm: Any = None, dtype: torch.dtype = torch.float32,
                 fold_downsample: bool = False, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        kw = dict(device=device, generator=generator)
        out = filters * self.expansion
        self.conv1 = Conv(in_features, filters, 1, dtype=dtype, **kw)
        self.bn1 = norm(filters)
        self.conv2 = Conv(filters, filters, 3, strides, 1, dtype=dtype, **kw)
        self.bn2 = norm(filters)
        self.conv3 = Conv(filters, out, 1, dtype=dtype, **kw)
        self.bn3 = norm(out)
        if strides != 1 or in_features != out:
            _downsample(self, in_features, out, strides, norm, dtype,
                        fold_downsample, kw)

    def forward(self, x: torch.Tensor, train: bool = True) -> torch.Tensor:
        y = torch.relu(self.bn1(self.conv1(x), train))
        y = torch.relu(self.bn2(self.conv2(y), train))
        y = self.bn3(self.conv3(y), train)
        return torch.relu(y + _residual(self, x, train))


class _Dense(nn.Module):
    """flax ``nn.Dense(features, dtype=float32)``: ``kernel`` (out, in),
    ``bias``; inputs and parameters promoted to fp32."""

    def __init__(self, in_features: int, features: int, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.kernel = nn.Parameter(init_kernel(
            (features, in_features), in_features, 1.0, generator, device))
        self.bias = nn.Parameter(torch.zeros(features, device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.linear(x.float(), self.kernel.float(), self.bias.float())


class ResNet(nn.Module):
    """NHWC ResNet: a 7x7 stride-2 stem, BN, ReLU and a 3x3 stride-2 max
    pool, ``stage_sizes`` blocks a stage (stride 2 at each later stage's
    first block), a mean pool and an fp32 dense head. ``dtype`` is the
    compute dtype of the convolutions and the BN outputs. ``fused`` sends
    the stride-1 `Bottleneck` blocks through `FusedBottleneck`;
    ``sync_bn_axis`` puts every norm on `SyncBatchNorm` over that axis.
    Parameters are drawn from ``generator`` (a CPU generator; seed 0 when
    None) on ``device`` (CUDA unless the caller names one)."""

    def __init__(self, stage_sizes: Sequence[int], block: Any = Bottleneck,
                 num_classes: int = 1000, num_filters: int = 64,
                 dtype: torch.dtype = torch.float32,
                 sync_bn_axis: Optional[str] = None, fused: bool = False,
                 fold_downsample: bool = False, in_channels: int = 3,
                 device=None, generator: Optional[torch.Generator] = None):
        super().__init__()
        from rocm_apex_tpu_torch.contrib.bottleneck import FusedBottleneck

        dev = resolve_device(device)
        self.device = dev
        self.dtype = dtype
        self.fused = fused and block is Bottleneck and sync_bn_axis is None
        gen = generator if generator is not None else \
            torch.Generator().manual_seed(0)
        kw = dict(device=dev, generator=gen)
        norm = _norm(sync_bn_axis, dtype, dev)
        self.conv1 = Conv(in_channels, num_filters, 7, 2, 3, dtype=dtype,
                          **kw)
        self.bn1 = norm(num_filters)
        self.block_names = []
        ch = num_filters
        for i, n_blocks in enumerate(stage_sizes):
            for j in range(n_blocks):
                strides = 2 if i > 0 and j == 0 else 1
                filters = num_filters * 2 ** i
                name = f"layer{i + 1}_{j}"
                if self.fused and strides == 1:
                    mod = FusedBottleneck(ch, filters, filters * 4,
                                          dtype=dtype, **kw)
                else:
                    mod = block(ch, filters, strides=strides, norm=norm,
                                dtype=dtype, fold_downsample=fold_downsample,
                                **kw)
                self.add_module(name, mod)
                self.block_names.append(name)
                ch = filters * block.expansion
        self.fc = _Dense(ch, num_classes, **kw)

    def forward(self, x: torch.Tensor, train: bool = True) -> torch.Tensor:
        x = torch.relu(self.bn1(self.conv1(x), train))
        x = F.max_pool2d(x.permute(0, 3, 1, 2), 3, 2, 1).permute(0, 2, 3, 1)
        for name in self.block_names:
            x = getattr(self, name)(x, train)
        x = x.float().mean((1, 2)).to(x.dtype)
        return self.fc(x)


# the smallest ResNet that still runs BN, blocks and the projection
# shortcut through the same code (the JAX package's test vehicle)
resnet_tiny = functools.partial(
    ResNet, stage_sizes=(1, 1), block=BasicBlock, num_filters=8
)
resnet18 = functools.partial(ResNet, stage_sizes=(2, 2, 2, 2), block=BasicBlock)
resnet34 = functools.partial(ResNet, stage_sizes=(3, 4, 6, 3), block=BasicBlock)
resnet50 = functools.partial(ResNet, stage_sizes=(3, 4, 6, 3), block=Bottleneck)
resnet101 = functools.partial(ResNet, stage_sizes=(3, 4, 23, 3), block=Bottleneck)
