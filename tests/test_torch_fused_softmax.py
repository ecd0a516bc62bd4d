"""The port's scaled causal / masked softmax (`ops.softmax`) and
`FusedScaleMaskSoftmax` against the JAX package, on the CPU.

The JAX side runs its Pallas kernels (`_causal_fwd_kernel`,
`_masked_fwd_kernel`, `_softmax_bwd_kernel`) in interpret mode and their
custom vjp; the port runs the kernels' plain versions through the same
autograd functions the card runs. Inputs are numpy-drawn fp32. Both sides
compute in fp32 and differ in summation order only: rtol 1e-5, atol 1e-6
on probabilities in [0, 1] and gradients of order 1.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rocm_apex_tpu.ops import softmax as jsm
from rocm_apex_tpu.transformer.enums import AttnMaskType as JaxAttnMaskType
from rocm_apex_tpu.transformer.functional import (
    FusedScaleMaskSoftmax as JaxFusedScaleMaskSoftmax,
)
from rocm_apex_tpu_torch.ops import softmax as sm
from rocm_apex_tpu_torch.transformer.enums import (
    AttnMaskType,
    AttnType,
    LayerType,
)
from rocm_apex_tpu_torch.transformer.functional import (
    FusedScaleMaskSoftmax,
    ScaledMaskedSoftmax,
    ScaledUpperTriangMaskedSoftmax,
)

TOL = dict(rtol=1e-5, atol=1e-6)


def _draw(shape, seed):
    return (2.0 * np.random.default_rng(seed).standard_normal(shape)).astype(
        np.float32)


def _port_fwd_bwd(fn, x, dy):
    xt = torch.from_numpy(x).requires_grad_(True)
    y = fn(xt)
    y.backward(torch.from_numpy(dy))
    return y.detach().numpy(), xt.grad.numpy()


def _jax_fwd_bwd(fn, x, dy):
    y, vjp = jax.vjp(fn, jnp.asarray(x))
    (dx,) = vjp(jnp.asarray(dy))
    return np.asarray(y), np.asarray(dx)


# (b, sq, sk): square, sq < sk, sq > sk, and sk not a multiple of 8
CAUSAL_SHAPES = [(3, 16, 16), (2, 5, 12), (2, 12, 5), (2, 9, 37)]


@pytest.mark.parametrize("shape", CAUSAL_SHAPES)
def test_causal_forward_and_backward_match_jax(shape):
    x, dy = _draw(shape, 1), _draw(shape, 2)
    scale = 0.37
    y, dx = _port_fwd_bwd(
        lambda t: sm.scaled_upper_triang_masked_softmax(t, scale), x, dy)
    jy, jdx = _jax_fwd_bwd(
        lambda t: jsm.scaled_upper_triang_masked_softmax(t, scale), x, dy)
    np.testing.assert_allclose(y, jy, **TOL)
    np.testing.assert_allclose(dx, jdx, **TOL)
    # column > row carries exactly nothing, forward and backward
    upper = np.triu(np.ones(shape[1:], bool), 1)
    assert np.all(y[:, upper] == 0.0) and np.all(dx[:, upper] == 0.0)
    np.testing.assert_allclose(y.sum(-1), 1.0, rtol=1e-6)


B, H, SQ, SK = 2, 3, 7, 13


def _mask(shape, seed):
    return np.random.default_rng(seed).random(shape) < 0.3


# every broadcast of (b|1, 1, sq|1, sk)
MASK_SHAPES = [(B, 1, SQ, SK), (1, 1, SQ, SK), (B, 1, 1, SK), (1, 1, 1, SK)]


@pytest.mark.parametrize("mshape", MASK_SHAPES)
def test_masked_forward_and_backward_match_jax(mshape):
    x, dy = _draw((B, H, SQ, SK), 3), _draw((B, H, SQ, SK), 4)
    mask = _mask(mshape, 5)
    scale = 0.61
    y, dx = _port_fwd_bwd(
        lambda t: sm.scaled_masked_softmax(t, torch.from_numpy(mask), scale),
        x, dy)
    jy, jdx = _jax_fwd_bwd(
        lambda t: jsm.scaled_masked_softmax(t, jnp.asarray(mask), scale),
        x, dy)
    np.testing.assert_allclose(y, jy, **TOL)
    np.testing.assert_allclose(dx, jdx, **TOL)


def test_a_fully_masked_row_is_uniform_as_in_jax():
    """Every key of a query row masked (BERT's padded queries): -10000 for
    all of them, so the row is the uniform 1/sk in both packages."""
    x, dy = _draw((B, H, SQ, SK), 6), _draw((B, H, SQ, SK), 7)
    mask = _mask((B, 1, SQ, SK), 8)
    mask[1, 0, 4] = True
    y, dx = _port_fwd_bwd(
        lambda t: sm.scaled_masked_softmax(t, torch.from_numpy(mask), 1.0),
        x, dy)
    jy, jdx = _jax_fwd_bwd(
        lambda t: jsm.scaled_masked_softmax(t, jnp.asarray(mask), 1.0),
        x, dy)
    np.testing.assert_allclose(y[1, :, 4], 1.0 / SK, rtol=1e-6)
    np.testing.assert_allclose(y, jy, **TOL)
    np.testing.assert_allclose(dx, jdx, **TOL)


def test_no_mask_is_the_all_false_mask():
    x = torch.from_numpy(_draw((B, H, SQ, SK), 9))
    none = sm.scaled_masked_softmax(x, None, 0.5)
    zeros = sm.scaled_masked_softmax(x, torch.zeros(B, 1, SQ, SK,
                                                    dtype=torch.bool), 0.5)
    torch.testing.assert_close(none, zeros, rtol=0, atol=0)


def test_plain_versions_keep_the_input_dtype_with_one_rounding():
    """bf16 and fp16 inputs: fp32 math inside, the output rounded once to
    the input's dtype (JAX's kernel_dtype upcast)."""
    x32 = torch.from_numpy(_draw((2, 8, 8), 10))
    for dt in (torch.bfloat16, torch.float16):
        x = x32.to(dt)
        y = sm.causal_softmax_fwd_plain(x, 0.5)
        assert y.dtype == dt
        torch.testing.assert_close(
            y, sm.causal_softmax_fwd_plain(x.float(), 0.5).to(dt),
            rtol=0, atol=0)
        dx = sm.softmax_bwd_plain(y, x, 0.5)
        assert dx.dtype == dt
        torch.testing.assert_close(
            dx, sm.softmax_bwd_plain(y.float(), x.float(), 0.5).to(dt),
            rtol=0, atol=0)


def test_wrappers_refuse_what_the_kernels_do_not_take():
    with pytest.raises(ValueError, match="sq, sk"):
        sm.softmax_causal_fwd(torch.zeros(2, 3), 1.0)
    with pytest.raises(ValueError, match="mask"):
        sm.softmax_masked_fwd(torch.zeros(1, 1, 2, 3), torch.zeros(2, 3), 1.0)
    with pytest.raises(RuntimeError):
        # a mask with a head axis does not broadcast over heads
        sm.softmax_masked_fwd(torch.zeros(1, 2, 2, 3),
                              torch.zeros(1, 2, 2, 3, dtype=torch.bool), 1.0)
    with pytest.raises(ValueError, match="differ"):
        sm.softmax_bwd(torch.zeros(2, 3), torch.zeros(3, 2), 1.0)


class TestFusedScaleMaskSoftmax:
    """Mirrors tests/L0/test_transformer_aux.py:22-58 (fused vs the
    fallback), and holds each against the JAX module."""

    def test_causal_fused_vs_fallback_and_jax(self):
        x = _draw((2, 4, 32, 32), 11)
        kw = dict(input_in_bf16=False, attn_mask_type=AttnMaskType.causal,
                  scale=0.5)
        fused = FusedScaleMaskSoftmax(**kw)
        fallback = FusedScaleMaskSoftmax(**kw,
                                         scaled_masked_softmax_fusion=False)
        a = fused(torch.from_numpy(x))
        np.testing.assert_allclose(a.numpy(),
                                   fallback(torch.from_numpy(x)).numpy(),
                                   **TOL)
        ref = JaxFusedScaleMaskSoftmax(
            input_in_bf16=False, attn_mask_type=JaxAttnMaskType.causal,
            scale=0.5)(jnp.asarray(x))
        np.testing.assert_allclose(a.numpy(), np.asarray(ref), **TOL)

    @pytest.mark.parametrize("with_mask", [True, False])
    def test_padding_fused_vs_fallback_and_jax(self, with_mask):
        x = _draw((2, 2, 8, 16), 12)
        mask = np.zeros((2, 1, 8, 16), bool)
        mask[:, :, :, 10:] = True
        mask[1, 0, 3] = True  # a fully masked row: uniform on both paths
        m = torch.from_numpy(mask) if with_mask else None
        fused = FusedScaleMaskSoftmax(attn_mask_type=AttnMaskType.padding,
                                      input_in_bf16=False)
        fallback = FusedScaleMaskSoftmax(attn_mask_type=AttnMaskType.padding,
                                         input_in_bf16=False,
                                         scaled_masked_softmax_fusion=False)
        a = fused(torch.from_numpy(x), m)
        np.testing.assert_allclose(
            a.numpy(), fallback(torch.from_numpy(x), m).numpy(), **TOL)
        jm = jnp.asarray(mask) if with_mask else None
        jax_mod = JaxFusedScaleMaskSoftmax(
            attn_mask_type=JaxAttnMaskType.padding, input_in_bf16=False)
        np.testing.assert_allclose(a.numpy(),
                                   np.asarray(jax_mod(jnp.asarray(x), jm)),
                                   **TOL)
        if with_mask:
            assert float(a[0, :, :, 10:].max()) < 1e-4
            assert float(a[1, :, [0, 1, 2, 4, 5, 6, 7], 10:].max()) < 1e-4

    @pytest.mark.parametrize("mask_type", [AttnMaskType.causal,
                                           AttnMaskType.padding])
    def test_bf16_input_fused_vs_fallback(self, mask_type):
        """A bf16 input: the kernel path returns bf16 from fp32 math; the
        fallback upcasts under softmax_in_fp32 and casts back, so the two
        agree to one bf16 rounding."""
        x = torch.from_numpy(_draw((2, 2, 16, 16), 13)).to(torch.bfloat16)
        # the causal kernel ignores a mask, as the reference's does
        mask = (torch.from_numpy(_mask((2, 1, 16, 16), 14))
                if mask_type == AttnMaskType.padding else None)
        fused = FusedScaleMaskSoftmax(attn_mask_type=mask_type, scale=0.3)
        fallback = FusedScaleMaskSoftmax(attn_mask_type=mask_type, scale=0.3,
                                         scaled_masked_softmax_fusion=False)
        a, b = fused(x, mask), fallback(x, mask)
        assert a.dtype == b.dtype == torch.bfloat16
        torch.testing.assert_close(a.float(), b.float(), rtol=2.0 ** -7,
                                   atol=1e-5)

    def test_one_key_takes_the_fallback(self):
        fused = FusedScaleMaskSoftmax(attn_mask_type=AttnMaskType.padding)
        assert not fused.is_kernel_available(None, 2, 2, 4, 1)
        assert fused.is_kernel_available(None, 2, 2, 4, 2)

    def test_constructor_and_call_errors(self):
        with pytest.raises(RuntimeError, match="both"):
            FusedScaleMaskSoftmax(input_in_fp16=True, input_in_bf16=True)
        with pytest.raises(RuntimeError, match="fp32"):
            FusedScaleMaskSoftmax(softmax_in_fp32=False, scale=0.5)
        with pytest.raises(ValueError, match="self attention"):
            FusedScaleMaskSoftmax(input_in_bf16=False)(torch.zeros(1, 1, 3, 4))

    def test_functional_forms_and_enums(self):
        x = torch.from_numpy(_draw((2, 6, 6), 15))
        torch.testing.assert_close(
            ScaledUpperTriangMaskedSoftmax(x, 0.5),
            sm.scaled_upper_triang_masked_softmax(x, 0.5))
        x4 = x[None]
        torch.testing.assert_close(ScaledMaskedSoftmax(x4, None, 0.5),
                                   sm.scaled_masked_softmax(x4, None, 0.5))
        assert LayerType.encoder.value == 1
        assert AttnType.cross_attn.value == 2
        assert AttnMaskType.causal.value == 2
