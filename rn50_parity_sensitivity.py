#!/usr/bin/env python3
"""How much fp32-level noise moves the ResNet-50 parity step, on the CPU.

    python3 rn50_parity_sensitivity.py

`chip_smoke.py`'s `rn50_parity` phase holds the fused ResNet-50 step on
the card against the same step on the CPU. This script measures, on the
CPU alone (the kernels' plain versions), what a 1e-6 relative
perturbation of the input images does to that comparison, so that the
phase's configuration and tolerances can be read against it:

1. the first step's gradients (the worst leaf's max |change| over its
   largest |gradient|) and logits, with the residual branches' last BN
   scales at 1 (random initial weights) and at `RN50_PARITY_BN3_SCALE`;
2. three steps at the phase's configuration (`RN50_PARITY`): each loss's
   relative change, and the masters' and running statistics' changes as
   shares of the phase's tolerances;
3. three steps at bench.py's FusedAdam(1e-3) (eps 1e-8) with unit
   scales: each loss's relative change.

It prints one JSON object. Runs in under a minute on a few CPU cores.
"""

import json

import torch
import torch.nn.functional as F

from chip_smoke import (RN50_PARITY, RN50_PARITY_BN3_SCALE,
                        RN50_PARITY_MASTER_TOL, RN50_PARITY_STATS_RTOL,
                        _rn50, _rn50_batch, _rn50_trainer, _stats_scale,
                        _worst)

NOISE = 1e-6


def _model(bn3_scale):
    model = _rn50("cpu", True, torch.float32)
    with torch.no_grad():
        for name, p in model.named_parameters():
            if name.endswith(("bn3_scale", "bn3.scale")):
                p.fill_(bn3_scale)
    return model


def _inputs(perturb):
    x, y = _rn50_batch(RN50_PARITY["batch"], RN50_PARITY["size"], "cpu")
    if perturb:
        gen = torch.Generator().manual_seed(5)
        x = x * (1 + NOISE * torch.randn(x.shape, generator=gen))
    return x, y


def first_step(bn3_scale, perturb):
    model = _model(bn3_scale)
    x, y = _inputs(perturb)
    logits = model(x).float()
    F.cross_entropy(logits, y).backward()
    return ({k: p.grad for k, p in model.named_parameters()},
            logits.detach())


def three_steps(bn3_scale, lr, eps, perturb):
    model = _model(bn3_scale)
    step, params, opt_state, ss = _rn50_trainer(
        model, "O0", lr=lr, eps=eps, master_weights=True,
        loss_scale="dynamic")
    x, y = _inputs(perturb)
    losses = []
    for _ in range(RN50_PARITY["steps"]):
        params, opt_state, ss, loss = step(params, opt_state, ss, x, y)
        losses.append(float(loss))
    return losses, opt_state.master, dict(model.named_buffers())


def main():
    out = {"noise": NOISE}
    for scale in (1.0, RN50_PARITY_BN3_SCALE):
        (g0, l0), (g1, l1) = first_step(scale, False), first_step(scale, True)
        out[f"bn3_scale_{scale}"] = dict(
            grad_change_over_leaf_max=max(
                float((g1[k] - g0[k]).abs().max() / g0[k].abs().max())
                for k in g0),
            logit_change_over_max=float((l1 - l0).abs().max()
                                        / l0.abs().max()))
    cfg = RN50_PARITY
    a = three_steps(RN50_PARITY_BN3_SCALE, cfg["lr"], cfg["eps"], False)
    b = three_steps(RN50_PARITY_BN3_SCALE, cfg["lr"], cfg["eps"], True)
    mt = RN50_PARITY_MASTER_TOL
    out["parity_config"] = dict(
        loss_rel_change=[abs(p - q) / abs(q) for p, q in zip(b[0], a[0])],
        masters_over_tol=_worst(
            b[1], a[1], {k: v.abs() for k, v in a[1].items()}, mt["rtol"],
            mt["atol"] + mt["lr_share"] * cfg["lr"] * cfg["steps"]),
        stats_over_tol=_worst(b[2], a[2], _stats_scale(a[2]),
                              RN50_PARITY_STATS_RTOL, 1e-30))
    a = three_steps(1.0, 1e-3, 1e-8, False)
    b = three_steps(1.0, 1e-3, 1e-8, True)
    out["bench_optimizer_unit_scales"] = dict(
        loss_rel_change=[abs(p - q) / abs(q) for p, q in zip(b[0], a[0])])
    print(json.dumps(out))


if __name__ == "__main__":
    main()
