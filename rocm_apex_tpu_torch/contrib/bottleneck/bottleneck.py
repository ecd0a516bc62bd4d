"""ResNet bottleneck blocks: the plain chain, the fused one, and the
spatially partitioned one.

Port of ``rocm_apex_tpu/contrib/bottleneck/bottleneck.py`` (`Bottleneck`
:52-105, `halo_exchange` :29-50, `SpatialBottleneck` :108-165,
`FusedBottleneck` :167-273). NHWC maps throughout. With
``sync_bn_axis`` the plain and the spatial blocks normalize with
`parallel.SyncBatchNorm` over that axis (JAX's ``_norm``: torch's
momentum 0.1, channel-last), else with flax-semantics BatchNorm at
momentum 0.9.

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

`SpatialBottleneck` holds H / n rows of the maps on each of the n ranks
of ``spatial_axis`` (a process group bound in `parallel_state`):
`halo_exchange` brings each rank its neighbours' boundary rows (the
reference's halo send/recv, JAX's two ``ppermute``s; here two
`parallel_state.shift` exchanges in one autograd node, whose backward
sends the halos' cotangents back), zero rows at the edge ranks, and the
3x3 runs
VALID over the extended rows with padding 1 on W, which is the
unsharded block's padded 3x3 on the rank's rows.
"""

from typing import Optional

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn

from rocm_apex_tpu_torch._device import resolve_device
from rocm_apex_tpu_torch.models._layers import BatchNorm, Conv, init_kernel
from rocm_apex_tpu_torch.ops.fused_bottleneck import bottleneck_fused
from rocm_apex_tpu_torch.parallel import SyncBatchNorm
from rocm_apex_tpu_torch.transformer import parallel_state

__all__ = ["Bottleneck", "FusedBottleneck", "SpatialBottleneck",
           "halo_exchange"]


def _norm(sync_bn_axis, dtype, device):
    """The blocks' norm of ``features`` channels (JAX ``_norm``)."""
    if sync_bn_axis is not None:
        return lambda features: SyncBatchNorm(
            features, axis_name=sync_bn_axis, channel_last=True, dtype=dtype,
            device=device)
    return lambda features: BatchNorm(features, momentum=0.9, dtype=dtype,
                                      device=device)


class _Halos(torch.autograd.Function):
    """The previous rank's ``bot`` and the next rank's ``top`` (two
    `parallel_state.shift` exchanges); the backward sends each halo's
    cotangent back to the rank it came from, in the same order on every
    rank (one node: the ranks' exchanges pair up)."""

    @staticmethod
    def forward(ctx, top, bot, group):
        ctx.group = group
        return (parallel_state.shift(bot, group, 1),
                parallel_state.shift(top, group, -1))

    @staticmethod
    def backward(ctx, g_prev, g_next):
        g_bot = parallel_state.shift(g_prev.contiguous(), ctx.group, -1)
        g_top = parallel_state.shift(g_next.contiguous(), ctx.group, 1)
        return g_top, g_bot, None


def halo_exchange(x: torch.Tensor, axis_name: str,
                  halo: int = 1) -> torch.Tensor:
    """``x`` (NHWC, this rank's rows) with ``halo`` rows of the previous
    rank's bottom before it and of the next rank's top after it, along H;
    zero rows at the first and the last rank (JAX :29). Two exchanges
    forward and two backward (none over a group of one rank)."""
    group = parallel_state.resolve_group(axis_name)
    n, idx = dist.get_world_size(group), dist.get_rank(group)
    top = x[:, :halo].contiguous()
    bot = x[:, -halo:].contiguous()
    zeros = torch.zeros_like(top)
    if n == 1:
        return torch.cat([zeros, x, zeros], dim=1)
    from_prev, from_next = _Halos.apply(top, bot, group)
    # a select on every rank: each rank's graph runs the same backward
    from_prev = torch.where(torch.full((), idx == 0, device=x.device),
                            zeros, from_prev)
    from_next = torch.where(torch.full((), idx == n - 1, device=x.device),
                            zeros, from_next)
    return torch.cat([from_prev, x, from_next], dim=1)


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
        dev = resolve_device(device)
        cin, cmid, cout = in_channels, bottleneck_channels, out_channels
        kw = dict(dtype=dtype, device=dev, generator=generator)
        norm = _norm(sync_bn_axis, dtype, dev)
        self.conv1 = Conv(cin, cmid, 1, **kw)
        self.bn1 = norm(cmid)
        self.conv2 = Conv(cmid, cmid, 3, stride, 1, **kw)
        self.bn2 = norm(cmid)
        self.conv3 = Conv(cmid, cout, 1, **kw)
        self.bn3 = norm(cout)
        if stride != 1 or cin != cout:
            self.downsample_conv = Conv(cin, cout, 1, stride, **kw)
            self.downsample_bn = norm(cout)

    def forward(self, x: torch.Tensor, train: bool = True) -> torch.Tensor:
        residual = x
        y = torch.relu(self.bn1(self.conv1(x), train))
        y = torch.relu(self.bn2(self.conv2(y), train))
        y = self.bn3(self.conv3(y), train)
        if hasattr(self, "downsample_conv"):
            residual = self.downsample_bn(self.downsample_conv(residual),
                                          train)
        return torch.relu(y + residual)


class SpatialBottleneck(nn.Module):
    """`Bottleneck` over H-sharded maps (JAX :108): each rank of
    ``spatial_axis`` holds H / n rows, and the 3x3 sees one-row halos
    from its neighbours (`halo_exchange`). No stride (a halo 3x3 does not
    stride, as the reference's spatial path); a projection shortcut when
    the width changes. Its parameter and buffer names are `Bottleneck`'s,
    so one block's weights load into the other."""

    def __init__(self, in_channels: int, bottleneck_channels: int,
                 out_channels: int, spatial_axis: str = "spatial",
                 dtype: torch.dtype = torch.float32,
                 sync_bn_axis: Optional[str] = None, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        dev = resolve_device(device)
        cin, cmid, cout = in_channels, bottleneck_channels, out_channels
        kw = dict(dtype=dtype, device=dev, generator=generator)
        norm = _norm(sync_bn_axis, dtype, dev)
        self.spatial_axis = spatial_axis
        self.conv1 = Conv(cin, cmid, 1, **kw)
        self.bn1 = norm(cmid)
        # VALID on the halo-extended rows, 1 on W
        self.conv2 = Conv(cmid, cmid, 3, 1, (0, 1), **kw)
        self.bn2 = norm(cmid)
        self.conv3 = Conv(cmid, cout, 1, **kw)
        self.bn3 = norm(cout)
        if cin != cout:
            self.downsample_conv = Conv(cin, cout, 1, **kw)
            self.downsample_bn = norm(cout)

    def forward(self, x: torch.Tensor, train: bool = True) -> torch.Tensor:
        residual = x
        y = torch.relu(self.bn1(self.conv1(x), train))
        y = halo_exchange(y, self.spatial_axis, halo=1)
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
