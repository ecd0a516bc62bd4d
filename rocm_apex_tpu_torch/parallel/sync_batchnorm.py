"""SyncBatchNorm: batch norm with statistics over the data axis.

Port of ``rocm_apex_tpu/parallel/sync_batchnorm.py`` (JAX :47-252), the
counterpart of the reference's SyncBatchNorm (apex/parallel/
optimized_sync_batchnorm.py:9-85 and its pure-torch fallback
sync_batchnorm.py:9-95). Each rank takes its local per-channel mean and
variance (the variance around a stop-gradient of the mean, JAX
:127-136), and the ranks merge them as JAX does with three ``psum``s
(the parallel-Welford combine, JAX :137-151): C = sum c, m = sum(c m_i)
/ C, v = sum(c (v_i + m_i^2)) / C - m^2. The three ride one exchange
here, stacked in one buffer (each element's sum the one its psum
gives). The backward of that sum is an autograd function that sums the
cotangents over the same ranks, a psum's transpose, so every gradient
is full-batch BN's.

The running statistics follow torch: ``new = (1 - momentum) * old +
momentum * batch`` with the UNBIASED batch variance (JAX :153-163). Both
layouts (``channel_last`` NHWC, else the channel on axis 1),
``fuse_relu``, ``axis_index_groups`` (subsets of the axis), and local
statistics when no process group is bound to ``axis_name`` (the
reference's single-process fallback). The normalize runs in the output
dtype (``dtype``, else the input's), as JAX's.

`convert_syncbn_model` replaces the port's flax-semantics
`models._layers.BatchNorm` submodules of a module with equivalent
`SyncBatchNorm`s in place (flax's momentum is a decay: the torch-style
momentum is ``1 - momentum``), carrying their parameters and running
statistics.
"""

from typing import Optional, Sequence

import torch
from torch import nn

from rocm_apex_tpu_torch.parallel.distributed import axis_sum
from rocm_apex_tpu_torch.transformer import parallel_state

__all__ = ["SyncBatchNorm", "convert_syncbn_model"]


def _axis_bound(axis_name) -> bool:
    if axis_name is None:
        return False
    try:
        parallel_state.resolve_group(axis_name)
    except KeyError:
        return False
    return True


class _AxisSum(torch.autograd.Function):
    """``axis_sum`` whose backward is the same sum of the cotangents (the
    transpose of a psum, or of a subset sum: its mask is symmetric)."""

    @staticmethod
    def forward(ctx, x, axis_name, groups):
        ctx.axis_name, ctx.groups = axis_name, groups
        return axis_sum(x, axis_name, groups)

    @staticmethod
    def backward(ctx, g):
        return axis_sum(g.contiguous(), ctx.axis_name, ctx.groups), None, None


class SyncBatchNorm(nn.Module):
    """BatchNorm over the batch of every rank on ``axis_name`` (JAX
    :47). ``num_features`` is the channel count C; ``eps``,
    ``momentum``, ``affine`` and ``track_running_stats`` have torch's
    meaning (momentum weighs the new batch statistic). Parameters
    ``scale`` and ``bias`` (``param_dtype``), buffers ``mean`` and
    ``var``, as the flax module's variables. ``forward(x, train)``, as
    the port's BatchNorm: ``train`` None takes ``not
    use_running_average`` when that is set, else True."""

    def __init__(self, num_features: int, eps: float = 1e-5,
                 momentum: float = 0.1, affine: bool = True,
                 track_running_stats: bool = True,
                 axis_name: Optional[str] = parallel_state.DATA_AXIS,
                 axis_index_groups: Optional[Sequence[Sequence[int]]] = None,
                 channel_last: bool = False, fuse_relu: bool = False,
                 dtype: Optional[torch.dtype] = None,
                 param_dtype: torch.dtype = torch.float32,
                 use_running_average: Optional[bool] = None, device=None):
        super().__init__()
        self.num_features = num_features
        self.eps, self.momentum = eps, momentum
        self.affine, self.track_running_stats = affine, track_running_stats
        self.axis_name, self.axis_index_groups = axis_name, axis_index_groups
        self.channel_last, self.fuse_relu = channel_last, fuse_relu
        self.dtype = dtype
        self.use_running_average = use_running_average
        if affine:
            self.scale = nn.Parameter(torch.ones(
                num_features, dtype=param_dtype, device=device))
            self.bias = nn.Parameter(torch.zeros(
                num_features, dtype=param_dtype, device=device))
        else:
            self.scale = self.bias = None
        self.register_buffer("mean", torch.zeros(
            num_features, dtype=torch.float32, device=device))
        self.register_buffer("var", torch.ones(
            num_features, dtype=torch.float32, device=device))

    def _batch_stats(self, x, ch, c):
        """(mean, var, count) of the batch over the axis, fp32."""
        reduce_dims = tuple(i for i in range(x.dim()) if i != ch)
        shape = [c if i == ch else 1 for i in range(x.dim())]
        xf = x.float()
        count = torch.full((1,), x.numel() / c, dtype=torch.float32,
                           device=x.device)
        mean = xf.mean(reduce_dims)
        var = torch.square(xf - mean.detach().view(shape)).mean(reduce_dims)
        if not _axis_bound(self.axis_name):
            return mean, var, count
        # count, count * mean, count * (var + mean^2): one exchange
        summed = _AxisSum.apply(
            torch.cat([count, mean * count, (var + torch.square(mean))
                       * count]), self.axis_name, self.axis_index_groups)
        total = summed[:1]
        mean = summed[1:1 + c] / total
        var = summed[1 + c:] / total - torch.square(mean)
        return mean, var, total

    def forward(self, x: torch.Tensor,
                train: Optional[bool] = None) -> torch.Tensor:
        if train is None:
            train = not self.use_running_average
        # without running statistics, evaluation normalizes by the batch
        train = train or not self.track_running_stats
        out_dtype = self.dtype if self.dtype is not None else x.dtype
        ch = x.dim() - 1 if self.channel_last else min(1, x.dim() - 1)
        c = x.shape[ch]
        if c != self.num_features:
            raise ValueError(f"input channel dim {c} != num_features "
                             f"{self.num_features}")
        if train:
            mean, var, count = self._batch_stats(x, ch, c)
            if self.track_running_stats:
                with torch.no_grad():
                    m = self.momentum
                    unbiased = var * count / torch.clamp_min(count - 1.0, 1.0)
                    self.mean.copy_((1 - m) * self.mean + m * mean)
                    self.var.copy_((1 - m) * self.var + m * unbiased)
        else:
            mean, var = self.mean, self.var
        shape = [c if i == ch else 1 for i in range(x.dim())]
        y = (x.to(out_dtype) - mean.view(shape).to(out_dtype)) * torch.rsqrt(
            var + self.eps).view(shape).to(out_dtype)
        if self.scale is not None:
            y = y * self.scale.view(shape).to(out_dtype)
            y = y + self.bias.view(shape).to(out_dtype)
        if self.fuse_relu:
            y = torch.relu(y)
        return y


def convert_syncbn_model(
    module: nn.Module,
    axis_name: Optional[str] = parallel_state.DATA_AXIS,
    axis_index_groups: Optional[Sequence[Sequence[int]]] = None,
    channel_last: Optional[bool] = None,
) -> nn.Module:
    """Replace every `models._layers.BatchNorm` submodule of ``module``
    (or ``module`` itself) with a `SyncBatchNorm` of the same epsilon,
    momentum ``1 - momentum``, dtype, parameters and running statistics
    (JAX :190, reference apex/parallel/__init__.py:21-95). The port's
    BatchNorm normalizes the last axis: ``channel_last`` defaults to
    True. Returns the converted module."""
    from rocm_apex_tpu_torch.models._layers import BatchNorm

    def conv(bn):
        sbn = SyncBatchNorm(
            bn.scale.shape[0], eps=bn.epsilon, momentum=1.0 - bn.momentum,
            axis_name=axis_name, axis_index_groups=axis_index_groups,
            channel_last=True if channel_last is None else channel_last,
            dtype=bn.dtype, param_dtype=bn.scale.dtype,
            device=bn.scale.device)
        with torch.no_grad():
            for name in ("scale", "bias", "mean", "var"):
                getattr(sbn, name).copy_(getattr(bn, name))
        return sbn

    if isinstance(module, BatchNorm):
        return conv(module)
    for name, child in list(module.named_children()):
        setattr(module, name, convert_syncbn_model(
            child, axis_name, axis_index_groups, channel_last))
    return module
