"""ResNet bottleneck blocks: the plain chain and the fused one.

Port of ``rocm_apex_tpu/contrib/bottleneck/bottleneck.py`` (`Bottleneck`
:52-105, `FusedBottleneck` :167-273). NHWC maps throughout.

`FusedBottleneck` in training runs `ops.fused_bottleneck.bottleneck_fused`
(the four hand-written kernels: BN-apply prologues, the convolutions,
BN-statistics epilogues, the merged backward) and moves its running
statistics ``m * ra + (1 - m) * batch``; in evaluation it runs the plain
chain on the running statistics, as the JAX module does. Its parameters
are flat (``conv1_kernel``, ``bn1_scale``, ..., the downsample branch's
``downsample_kernel``, ``bn4_scale``, ``bn4_bias``), so amp's batch-norm
rule keeps the BN leaves fp32; the block casts x and the kernels to its
``dtype`` itself. The kernels keep the JAX layout: (Cin, Cout) for a 1x1,
(3, 3, Cin, Cout) for the 3x3.

`SpatialBottleneck` and `halo_exchange` need process groups (the JAX
versions exchange halos with ``ppermute``); they wait for the port of the
parallel layer (ROADMAP.md Queue 1 item 10).
"""

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from rocm_apex_tpu_torch._device import resolve_device
from rocm_apex_tpu_torch.models._layers import BatchNorm, Conv, init_kernel
from rocm_apex_tpu_torch.ops.fused_bottleneck import bottleneck_fused

__all__ = ["Bottleneck", "FusedBottleneck"]


def _refuse_sync_bn(sync_bn_axis):
    if sync_bn_axis is not None:
        raise NotImplementedError(
            "sync_bn_axis: parallel.SyncBatchNorm is not ported yet "
            "(ROADMAP.md Queue 1 item 10, part 10d)")


class Bottleneck(nn.Module):
    """1x1 -> 3x3 -> 1x1 conv-bn-relu chain with the residual; ``stride``
    on the 3x3; a projection shortcut when the stride or the width
    changes."""

    def __init__(self, in_channels: int, bottleneck_channels: int,
                 out_channels: int, stride: int = 1,
                 dtype: torch.dtype = torch.float32,
                 sync_bn_axis: Optional[str] = None, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        _refuse_sync_bn(sync_bn_axis)
        dev = resolve_device(device)
        cin, cmid, cout = in_channels, bottleneck_channels, out_channels
        kw = dict(dtype=dtype, device=dev, generator=generator)
        bn = dict(momentum=0.9, dtype=dtype, device=dev)
        self.conv1 = Conv(cin, cmid, 1, **kw)
        self.bn1 = BatchNorm(cmid, **bn)
        self.conv2 = Conv(cmid, cmid, 3, stride, 1, **kw)
        self.bn2 = BatchNorm(cmid, **bn)
        self.conv3 = Conv(cmid, cout, 1, **kw)
        self.bn3 = BatchNorm(cout, **bn)
        if stride != 1 or cin != cout:
            self.downsample_conv = Conv(cin, cout, 1, stride, **kw)
            self.downsample_bn = BatchNorm(cout, **bn)

    def forward(self, x: torch.Tensor, train: bool = True) -> torch.Tensor:
        residual = x
        y = torch.relu(self.bn1(self.conv1(x), train))
        y = torch.relu(self.bn2(self.conv2(y), train))
        y = self.bn3(self.conv3(y), train)
        if hasattr(self, "downsample_conv"):
            residual = self.downsample_bn(self.downsample_conv(residual),
                                          train)
        return torch.relu(y + residual)


class FusedBottleneck(nn.Module):
    """Training-mode bottleneck on the fused kernel chain; stride 1 (the
    stride-2 blocks use `Bottleneck`); evaluation runs the plain chain on
    the running statistics."""

    def __init__(self, in_channels: int, bottleneck_channels: int,
                 out_channels: int, dtype: torch.dtype = torch.bfloat16,
                 momentum: float = 0.9, epsilon: float = 1e-5, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        dev = resolve_device(device)
        cin, cmid, cout = in_channels, bottleneck_channels, out_channels
        self.dtype = dtype
        self.momentum = momentum
        self.epsilon = epsilon
        self.downsample = cin != cout

        def kernel(shape):
            fan_in = 1
            for d in shape[:-1]:
                fan_in *= d
            return nn.Parameter(init_kernel(shape, fan_in, 2.0, generator,
                                            dev))

        self.conv1_kernel = kernel((cin, cmid))
        self.conv2_kernel = kernel((3, 3, cmid, cmid))
        self.conv3_kernel = kernel((cmid, cout))
        names = ["bn1", "bn2", "bn3"] + (["bn4"] if self.downsample else [])
        dims = [cmid, cmid, cout] + ([cout] if self.downsample else [])
        if self.downsample:
            self.downsample_kernel = kernel((cin, cout))
        for nm, d in zip(names, dims):
            self.register_parameter(
                f"{nm}_scale", nn.Parameter(torch.ones(d, device=dev)))
            self.register_parameter(
                f"{nm}_bias", nn.Parameter(torch.zeros(d, device=dev)))
            self.register_buffer(f"{nm}_mean", torch.zeros(d, device=dev))
            self.register_buffer(f"{nm}_var", torch.ones(d, device=dev))
        self._bn_names = names

    def forward(self, x: torch.Tensor, train: bool = True) -> torch.Tensor:
        dt = self.dtype
        ds = self.downsample
        if train:
            z, stats = bottleneck_fused(
                self.epsilon, ds, x.to(dt),
                self.conv1_kernel.to(dt), self.bn1_scale, self.bn1_bias,
                self.conv2_kernel.to(dt), self.bn2_scale, self.bn2_bias,
                self.conv3_kernel.to(dt), self.bn3_scale, self.bn3_bias,
                *((self.downsample_kernel.to(dt), self.bn4_scale,
                   self.bn4_bias) if ds else (None, None, None)))
            m = self.momentum
            with torch.no_grad():
                for nm, st in zip(self._bn_names, stats):
                    mu, var = st
                    ra_mu = getattr(self, f"{nm}_mean")
                    ra_var = getattr(self, f"{nm}_var")
                    ra_mu.copy_(m * ra_mu + (1 - m) * mu)
                    ra_var.copy_(m * ra_var + (1 - m) * var)
            return z
        return self._eval(x)

    def _bn(self, y, i):
        nm = self._bn_names[i]
        rs = torch.rsqrt(getattr(self, f"{nm}_var") + self.epsilon)
        return ((y.float() - getattr(self, f"{nm}_mean")) * rs
                * getattr(self, f"{nm}_scale") + getattr(self, f"{nm}_bias"))

    def _eval(self, x):
        dt = self.dtype
        n, h, w_, cin = x.shape
        xw = x.to(dt)
        y = xw.reshape(-1, cin) @ self.conv1_kernel.to(dt)
        y = torch.clamp_min(self._bn(y, 0), 0.0).to(dt)
        cmid = y.shape[-1]
        y = F.conv2d(y.reshape(n, h, w_, cmid).permute(0, 3, 1, 2),
                     self.conv2_kernel.to(dt).permute(3, 2, 0, 1),
                     padding=1).permute(0, 2, 3, 1).reshape(-1, cmid)
        y = torch.clamp_min(self._bn(y, 1), 0.0).to(dt)
        y = self._bn(y @ self.conv3_kernel.to(dt), 2)
        if self.downsample:
            r = self._bn(xw.reshape(-1, cin) @ self.downsample_kernel.to(dt),
                         3)
        else:
            r = xw.reshape(-1, cin).float()
        z = torch.clamp_min(y + r, 0.0).to(dt)
        return z.reshape(n, h, w_, -1)
