"""The port's label-smoothed cross-entropy against the JAX package, on
the CPU.

The same numpy-seeded logits and labels go through
``rocm_apex_tpu.ops.xentropy`` (its Pallas kernels in interpret mode, as
the JAX package's own tests run them) and through the port, whose
wrappers take the kernel's plain PyTorch version for CPU tensors.

Tolerances: fp32 1e-5 relative (plus 1e-6 absolute: a gradient entry is
a difference of numbers of order 1/vocab): both sides compute in fp32 and
differ in summation order. bf16 ``dg`` one bf16 ulp (2^-7 relative):
both round the same fp32 value up to that noise.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rocm_apex_tpu.ops import xentropy as jx
from rocm_apex_tpu_torch.ops import xentropy as tx

FP32 = dict(rtol=1e-5, atol=1e-6)
BF16 = dict(rtol=2.0 ** -7, atol=1e-6)
JDT = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}


def _inputs(rows, vocab, dtype, seed=0):
    """Logits of a few units' spread, exact in ``dtype``; labels that hit
    column 0, column V-1 and the padding ids 0 and -1."""
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((rows, vocab)) * 3.0).astype(np.float32)
    x = torch.tensor(x).to(dtype)
    labels = rng.integers(0, vocab, (rows,)).astype(np.int32)
    labels[:4] = [0, vocab - 1, 0, -1]
    w = rng.standard_normal((rows,)).astype(np.float32)
    return x, labels, w


def _jax_in(x, labels):
    return (jnp.asarray(x.float().numpy()).astype(JDT[x.dtype]),
            jnp.asarray(labels))


@pytest.mark.parametrize("padding_idx", [0, -1, None],
                         ids=["pad0", "pad-1", "nopad"])
@pytest.mark.parametrize("smoothing", [0.0, 0.1], ids=["eps0", "eps0.1"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
def test_fused_loss_and_dx_match_jax(dtype, smoothing, padding_idx):
    """`softmax_cross_entropy_loss_fused`: the per-row losses and the
    gradient of a weighted sum of them, on 13 rows (no multiple of 8)
    and a vocab that is no multiple of 8."""
    x, labels, w = _inputs(13, 1001, dtype)
    jxx, jl = _jax_in(x, labels)

    def jloss(a):
        return jnp.sum(jx.softmax_cross_entropy_loss_fused(
            a, jl, smoothing, padding_idx) * w)

    jlosses = jx.softmax_cross_entropy_loss_fused(jxx, jl, smoothing,
                                                  padding_idx)
    jdx = jax.grad(jloss)(jxx)

    tx_in = x.clone().requires_grad_(True)
    losses = tx.softmax_cross_entropy_loss_fused(
        tx_in, torch.tensor(labels), smoothing, padding_idx)
    (losses * torch.tensor(w)).sum().backward()
    assert losses.dtype == torch.float32 and losses.shape == (13,)
    np.testing.assert_allclose(losses.detach().numpy(), np.asarray(jlosses),
                               **FP32)
    assert tx_in.grad.dtype == dtype
    np.testing.assert_allclose(
        tx_in.grad.float().numpy(), np.asarray(jdx.astype(jnp.float32)),
        **(FP32 if dtype == torch.float32 else BF16))
    if padding_idx is not None:
        pad = torch.tensor(labels) == padding_idx
        assert bool(pad.any())
        assert torch.all(losses[pad] == 0.0)
        assert torch.all(tx_in.grad[pad] == 0.0)


@pytest.mark.parametrize("smoothing", [0.0, 0.1], ids=["eps0", "eps0.1"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
def test_the_two_kernel_forms_match_the_pallas_kernels(dtype, smoothing):
    """`xent_fwd` against `_fwd_impl` (loss, lse) and `xent_fwd_dg`
    against `_fwd_dg_impl` (loss, dg in the logits dtype)."""
    x, labels, _ = _inputs(24, 520, dtype, seed=1)
    jxx, jl = _jax_in(x, labels)
    jloss, jlse = jx._fwd_impl(jxx, jl, smoothing)
    jloss2, jdg = jx._fwd_dg_impl(jxx, jl, smoothing)
    loss, lse = tx.xent_fwd(x, torch.tensor(labels), smoothing)
    loss2, dg = tx.xent_fwd_dg(x, torch.tensor(labels), smoothing)
    np.testing.assert_allclose(loss.numpy(), np.asarray(jloss), **FP32)
    np.testing.assert_allclose(lse.numpy(), np.asarray(jlse), **FP32)
    np.testing.assert_allclose(loss2.numpy(), np.asarray(jloss2), **FP32)
    assert dg.dtype == dtype and dg.shape == x.shape
    np.testing.assert_allclose(
        dg.float().numpy(), np.asarray(jdg.astype(jnp.float32)),
        **(FP32 if dtype == torch.float32 else BF16))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
def test_without_a_gradient_no_dg_is_written(dtype, monkeypatch):
    """Under ``no_grad`` (and for logits that need no gradient) the fused
    function is the plain forward: the same values as JAX's
    un-differentiated call, through `xent_fwd` and never `xent_fwd_dg`;
    `softmax_cross_entropy_loss` is that forward too."""
    x, labels, _ = _inputs(13, 1001, dtype, seed=2)
    jxx, jl = _jax_in(x, labels)
    want = np.asarray(jx.softmax_cross_entropy_loss_fused(jxx, jl, 0.1, 0))
    want_plain = np.asarray(jx.softmax_cross_entropy_loss(jxx, jl, 0.1, 0))

    def boom(*a, **k):
        raise AssertionError("the dg form ran without a gradient to compute")

    monkeypatch.setattr(tx, "xent_fwd_dg", boom)
    lbl = torch.tensor(labels)
    with torch.no_grad():
        got = tx.softmax_cross_entropy_loss_fused(
            x.clone().requires_grad_(True), lbl, 0.1, 0)
    got2 = tx.softmax_cross_entropy_loss_fused(x, lbl, 0.1, 0)
    got3 = tx.softmax_cross_entropy_loss(x, lbl, 0.1, 0)
    assert not got.requires_grad and not got2.requires_grad
    np.testing.assert_allclose(got.numpy(), want, **FP32)
    np.testing.assert_allclose(got2.numpy(), want, **FP32)
    np.testing.assert_allclose(got3.numpy(), want_plain, **FP32)


def test_labels_may_be_int32_or_int64_and_out_of_range_selects_nothing():
    x, labels, _ = _inputs(8, 64, torch.float32, seed=3)
    labels[5] = 64  # past the vocabulary: no target logit
    a, _ = tx.xent_fwd(x, torch.tensor(labels), 0.0)
    b, _ = tx.xent_fwd(x, torch.tensor(labels).long(), 0.0)
    assert torch.equal(a, b)
    lse = torch.logsumexp(x, dim=1)
    np.testing.assert_allclose(float(a[5]), float(lse[5]), rtol=1e-6)
    jloss, _ = jx._fwd_impl(jnp.asarray(x.numpy()), jnp.asarray(labels), 0.0)
    np.testing.assert_allclose(a.numpy(), np.asarray(jloss), **FP32)


def test_matches_torch_cross_entropy():
    """An independent check of the semantics: F.cross_entropy with
    label smoothing is the same loss."""
    x, labels, _ = _inputs(16, 300, torch.float32, seed=4)
    labels[3] = 7
    lbl = torch.tensor(labels).long()
    for eps in (0.0, 0.1):
        got = tx.softmax_cross_entropy_loss_fused(x, lbl, eps, None)
        want = torch.nn.functional.cross_entropy(
            x, lbl, reduction="none", label_smoothing=eps)
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-5,
                                   atol=1e-6)


def test_the_two_pass_backward_is_refused_by_name():
    """The refusal this test once pinned is lifted: the two-pass backward
    (`_bwd_kernel`'s form) runs, and its dlogits are JAX's
    (tests/test_torch_xentropy_contrib.py holds the rest)."""
    x, labels, w = _inputs(8, 64, torch.float32)
    jxx, jl = _jax_in(x, labels)
    jg = jax.grad(lambda a: jnp.sum(
        jx.softmax_cross_entropy_loss(a, jl, 0.0, 0) * w))(jxx)
    xg = x.clone().requires_grad_(True)
    losses = tx.softmax_cross_entropy_loss(xg, torch.tensor(labels))
    (losses * torch.from_numpy(w)).sum().backward()
    np.testing.assert_allclose(xg.grad.numpy(), np.asarray(jg), **FP32)


@pytest.mark.parametrize("logits,labels,error", [
    (torch.zeros(4, 8, 2), torch.zeros(4, dtype=torch.int64), ValueError),
    (torch.zeros(4, 8), torch.zeros(5, dtype=torch.int64), ValueError),
    (torch.zeros(4, 8), torch.zeros(4), TypeError),
])
def test_wrapper_refuses_bad_shapes_and_label_types(logits, labels, error):
    with pytest.raises(error):
        tx.xent_fwd_dg(logits, labels)
