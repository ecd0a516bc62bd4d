"""The port's two-pass cross-entropy and ``contrib.xentropy`` against the
JAX package, on the CPU.

`softmax_cross_entropy_loss` (the plain forward, with the logits and lse
saved, and the two-pass backward `_bwd_kernel`) and
`SoftmaxCrossEntropyLoss.apply`, on numpy-drawn fp32 logits. The JAX side
runs its Pallas kernels in interpret mode, the port its kernels' plain
versions. Both compute in fp32 and differ in summation order only: losses
and dlogits agree to 1e-5 relative (plus 1e-6 absolute: a gradient entry
is a difference of numbers of order 1/vocab).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rocm_apex_tpu.contrib.xentropy import (
    SoftmaxCrossEntropyLoss as JSoftmaxCrossEntropyLoss,
)
from rocm_apex_tpu.ops import xentropy as jx
from rocm_apex_tpu_torch.contrib.xentropy import (
    SoftmaxCrossEntropyLoss,
    softmax_cross_entropy_loss,
)
from rocm_apex_tpu_torch.ops import xentropy as tx

TOL = dict(rtol=1e-5, atol=1e-6)


def _inputs(rows, vocab, seed):
    """fp32 logits of a few units' spread; labels that hit column 0,
    column V-1 and the padding ids 0 and -1; a cotangent per row."""
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((rows, vocab)) * 3.0).astype(np.float32)
    labels = rng.integers(0, vocab, (rows,)).astype(np.int32)
    labels[:5] = [0, vocab - 1, 0, -1, -1]
    w = rng.standard_normal((rows,)).astype(np.float32)
    return x, labels, w


def _jax_loss_and_grad(fn, x, labels, w):
    def loss(x):
        losses = fn(x)
        return (losses * w).sum(), losses

    (_, losses), g = jax.value_and_grad(loss, has_aux=True)(jnp.asarray(x))
    return np.asarray(losses), np.asarray(g)


@pytest.mark.parametrize("padding_idx", [0, -1, None],
                         ids=["pad0", "pad-1", "nopad"])
@pytest.mark.parametrize("smoothing", [0.0, 0.1], ids=["eps0", "eps0.1"])
def test_two_pass_loss_and_gradient_match_jax(smoothing, padding_idx):
    """Per-row losses and dlogits of `softmax_cross_entropy_loss` under a
    random per-row cotangent; rows at the padding index give zero loss
    and zero gradient, a label of -1 selects no column."""
    x, labels, w = _inputs(24, 999, seed=1)
    jl, jg = _jax_loss_and_grad(
        lambda a: jx.softmax_cross_entropy_loss(a, jnp.asarray(labels),
                                                smoothing, padding_idx),
        x, labels, w)
    tx_ = torch.tensor(x, requires_grad=True)
    losses = softmax_cross_entropy_loss(tx_, torch.tensor(labels), smoothing,
                                        padding_idx)
    (losses * torch.from_numpy(w)).sum().backward()
    np.testing.assert_allclose(losses.detach().numpy(), jl, **TOL)
    np.testing.assert_allclose(tx_.grad.numpy(), jg, **TOL)
    if padding_idx is not None:
        pad = labels == padding_idx
        assert pad.any()
        assert not losses.detach().numpy()[pad].any()
        assert not tx_.grad.numpy()[pad].any()


@pytest.mark.parametrize("call", ["apply", "instance"])
@pytest.mark.parametrize("smoothing,padding_idx", [(0.0, 0), (0.1, -1)],
                         ids=["eps0-pad0", "eps0.1-pad-1"])
def test_softmax_cross_entropy_loss_class_matches_jax(call, smoothing,
                                                      padding_idx):
    """`SoftmaxCrossEntropyLoss.apply` and a called instance, with
    ``half_to_float`` accepted and ignored, against the JAX class."""
    x, labels, w = _inputs(16, 512, seed=2)
    jl, jg = _jax_loss_and_grad(
        lambda a: JSoftmaxCrossEntropyLoss.apply(
            a, jnp.asarray(labels), smoothing, padding_idx, True),
        x, labels, w)
    fn = (SoftmaxCrossEntropyLoss.apply if call == "apply"
          else SoftmaxCrossEntropyLoss())
    tx_ = torch.tensor(x, requires_grad=True)
    losses = fn(tx_, torch.tensor(labels).long(), smoothing, padding_idx,
                half_to_float=False)
    (losses * torch.from_numpy(w)).sum().backward()
    assert losses.dtype == torch.float32
    np.testing.assert_allclose(losses.detach().numpy(), jl, **TOL)
    np.testing.assert_allclose(tx_.grad.numpy(), jg, **TOL)


def test_backward_kernel_form_matches_jax_bwd_kernel():
    """`xent_bwd` (the kernel's wrapper, its plain version here) against
    the JAX `_vjp_bwd`, which runs `_bwd_kernel`, on the same lse."""
    x, labels, w = _inputs(12, 700, seed=3)
    jlse = jx._fwd_impl(jnp.asarray(x), jnp.asarray(labels), 0.1)[1]
    jdx, _ = jx._vjp_bwd(0.1, None, (jnp.asarray(x), jnp.asarray(labels),
                                     jlse), jnp.asarray(w))
    _, lse = tx.xent_fwd(torch.from_numpy(x), torch.tensor(labels), 0.1)
    np.testing.assert_allclose(lse.numpy(), np.asarray(jlse), **TOL)
    dx = tx.xent_bwd(torch.from_numpy(x), torch.tensor(labels), lse,
                     torch.from_numpy(w), 0.1)
    np.testing.assert_allclose(dx.numpy(), np.asarray(jdx), **TOL)


def test_no_gradient_needs_no_backward():
    """Under ``no_grad`` the loss is the plain forward's, with no graph."""
    x, labels, _ = _inputs(8, 64, seed=4)
    with torch.no_grad():
        losses = softmax_cross_entropy_loss(
            torch.tensor(x, requires_grad=True), torch.tensor(labels), 0.1)
    want, _ = tx.xent_fwd(torch.from_numpy(x), torch.tensor(labels), 0.1)
    assert not losses.requires_grad
    np.testing.assert_allclose(
        losses.numpy(), np.where(labels == 0, 0.0, want.numpy()), **TOL)
