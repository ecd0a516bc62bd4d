"""Functional dynamic loss scaler.

Port of ``rocm_apex_tpu/amp/scaler.py`` (its `LossScaler`, `ScalerState`
and `all_finite`). The state is three device tensors, so scaling,
the overflow probe and the scale update all stay on the device: a
training step never waits on the host for the skip decision. The update
is a `torch.where` select between the overflow and the clean branch, as
the JAX scaler's `jnp.where` select is.

Constants are the JAX package's (those of the reference apex scaler):
init 2^16, factor 2, window 2000 clean steps, max 2^24, optional min.
"""

from typing import Iterable, Mapping, NamedTuple, Optional, Tuple, Union

import torch

__all__ = ["LossScaler", "ScalerState", "all_finite"]


class ScalerState(NamedTuple):
    """Dynamic scaler state: three scalars on the device."""

    loss_scale: torch.Tensor  # fp32
    unskipped: torch.Tensor  # int32: consecutive non-overflow steps
    overflows: torch.Tensor  # int32: total skipped steps


def all_finite(tensors: Iterable[torch.Tensor]) -> torch.Tensor:
    """True (a device bool) iff every element of every floating tensor is
    finite: per-tensor fp32 sums, where any inf/nan poisons the total (the
    JAX package's probe)."""
    sums = [t.float().sum() for t in tensors if t.is_floating_point()]
    if not sums:
        return torch.tensor(True)
    return torch.isfinite(torch.stack(sums).sum())


class LossScaler:
    """Static scaler config; the methods take and return `ScalerState`.

    ``loss_scale`` is a float for static scaling or "dynamic"."""

    def __init__(
        self,
        loss_scale: Union[str, float] = "dynamic",
        init_scale: float = 2.0**16,
        scale_factor: float = 2.0,
        scale_window: int = 2000,
        min_loss_scale: Optional[float] = None,
        max_loss_scale: float = 2.0**24,
    ):
        self.dynamic = loss_scale == "dynamic"
        self._init_scale = (
            min(max_loss_scale, init_scale) if self.dynamic
            else float(loss_scale)
        )
        self.scale_factor = scale_factor
        self.scale_window = scale_window
        self.min_loss_scale = min_loss_scale
        self.max_loss_scale = max_loss_scale

    def init(self, device=None) -> ScalerState:
        return ScalerState(
            loss_scale=torch.tensor(self._init_scale, dtype=torch.float32,
                                    device=device),
            unskipped=torch.tensor(0, dtype=torch.int32, device=device),
            overflows=torch.tensor(0, dtype=torch.int32, device=device),
        )

    def scale(self, state: ScalerState, loss: torch.Tensor) -> torch.Tensor:
        """``loss.float() * loss_scale``."""
        return loss.float() * state.loss_scale

    def loss_scale(self, state: ScalerState) -> torch.Tensor:
        return state.loss_scale

    def unscale(self, state: ScalerState, grads: Mapping[str, torch.Tensor]):
        """``(grads / loss_scale in fp32, found_inf)`` for a dict of
        gradients; found_inf a device bool (the probe of `all_finite` over
        the unscaled values)."""
        inv = 1.0 / state.loss_scale
        out = {k: g.float() * inv if g.is_floating_point() else g
               for k, g in grads.items()}
        return out, torch.logical_not(all_finite(out.values()))

    def unscale_with_stashed(self, state: ScalerState,
                             stashed: Mapping[str, torch.Tensor],
                             grads: Mapping[str, torch.Tensor]):
        """``stashed + grads / loss_scale`` in fp32 and its found_inf: the
        gradient-accumulation merge."""
        inv = 1.0 / state.loss_scale
        out = {k: stashed[k].float() + g.float() * inv
               for k, g in grads.items()}
        return out, torch.logical_not(all_finite(out.values()))

    def unscale_packed(self, state: ScalerState, packed_grads):
        """Unscale a `PackedTree` of gradient buffers to fp32 and probe it
        for inf/nan in one pass over each dtype buffer (ops/multi_tensor.py
        `scale_packed`: the multiply and the probe ride one read). Returns
        ``(unscaled_packed_f32, found_inf)``, found_inf a device bool."""
        from rocm_apex_tpu_torch.ops.multi_tensor import scale_packed

        return scale_packed(packed_grads, 1.0 / state.loss_scale,
                            torch.float32)

    def update(
        self, state: ScalerState, found_inf: torch.Tensor
    ) -> Tuple[ScalerState, torch.Tensor]:
        """Post-step scale update; returns ``(new_state, should_skip)``:
        on overflow halve (clamped at the min) and reset the window;
        after ``scale_window`` consecutive clean steps double (clamped at
        the max). A static scaler never changes and never skips."""
        if not self.dynamic:
            return state, torch.zeros((), dtype=torch.bool,
                                      device=state.loss_scale.device)
        found_inf = torch.as_tensor(found_inf, device=state.loss_scale.device)
        down = state.loss_scale / self.scale_factor
        if self.min_loss_scale is not None:
            down = torch.clamp(down, min=self.min_loss_scale)
        unskipped = state.unskipped + 1
        grow = unskipped >= self.scale_window
        up = torch.where(
            grow,
            torch.clamp(state.loss_scale * self.scale_factor,
                        max=self.max_loss_scale),
            state.loss_scale,
        )
        zero = torch.zeros_like(state.unskipped)
        new = ScalerState(
            loss_scale=torch.where(found_inf, down, up),
            unskipped=torch.where(found_inf, zero,
                                  torch.where(grow, zero, unskipped)),
            overflows=state.overflows + found_inf.to(torch.int32),
        )
        return new, found_inf
