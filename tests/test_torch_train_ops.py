"""The training slice's kernel modules against the JAX package, on the CPU.

For a CPU tensor each wrapper runs its kernel's plain PyTorch version;
the JAX side runs its Pallas kernels in interpret mode, as the JAX
package's own tests do. Inputs are drawn with numpy from a seed and
handed to both. fp32 throughout, rtol/atol 1e-5 unless a test says
otherwise: both sides accumulate in fp32 and differ only in summation
order (and exp2 against exp in the attention softmax).

Dropout is checked on the port alone: the TPU kernels draw their keep
bits from the hardware PRNG (flash_attention.py:85), so no bits can be
shared; the port's one keep-mask hash is pinned by golden values, its
keep fraction, the kept values and the VJP against the chain composed
from the mask recovered from the forward.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rocm_apex_tpu.ops import flash_attention as jfa
from rocm_apex_tpu.ops import layer_norm as jln
from rocm_apex_tpu.ops import linear_xentropy as jlx
from rocm_apex_tpu_torch.ops import _dropout
from rocm_apex_tpu_torch.ops import flash_attention as tfa
from rocm_apex_tpu_torch.ops import layer_norm as tln
from rocm_apex_tpu_torch.ops import linear_xentropy as tlx

TOL = dict(rtol=1e-5, atol=1e-5)


def _np(*shape, seed, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape) * scale
            ).astype(np.float32)


def _t(a, grad=False):
    return torch.tensor(np.asarray(a), requires_grad=grad)


def _rel(a, b):
    """max |a - b| over max |b|: a whole-tensor relative error."""
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / (np.abs(b).max() + 1e-12))


# ---------------------------------------------------------------------------
# packed-QKV flash attention
# ---------------------------------------------------------------------------


class TestFlashQKV:
    @pytest.mark.parametrize("seq,block", [(64, 1024), (256, 128)],
                             ids=["single_block", "multi_block"])
    def test_bias_fwd_and_grads_match_jax(self, seq, block):
        """`flash_attention_qkv_bias`, causal, head_dim 128: the context
        and the gradients of qkv and bias. Single block (S 64 reaches
        `_fwd_single_kernel` and `_bwd_merged_kernel`) and multi-block
        (S 256 with 128-blocks reaches `_fwd_kernel` and the split
        backward)."""
        B, nh, hd = 2, 2, 128
        qkv = _np(B, seq, nh, 3 * hd, seed=1)
        bias = _np(nh * 3 * hd, seed=2, scale=0.1)
        do = _np(B, seq, nh * hd, seed=3)

        def jloss(q, b):
            o = jfa.flash_attention_qkv_bias(q, b, True, None, block, block)
            return jnp.sum(o * do)

        jo = jfa.flash_attention_qkv_bias(
            jnp.asarray(qkv), jnp.asarray(bias), True, None, block, block)
        jdq, jdb = jax.grad(jloss, argnums=(0, 1))(jnp.asarray(qkv),
                                                  jnp.asarray(bias))
        tq, tb = _t(qkv, True), _t(bias, True)
        to = tfa.flash_attention_qkv_bias(tq, tb, causal=True)
        (to * _t(do)).sum().backward()
        np.testing.assert_allclose(to.detach().numpy(), np.asarray(jo), **TOL)
        np.testing.assert_allclose(tq.grad.numpy(), np.asarray(jdq), **TOL)
        # the bias gradient sums B*S rows of dqkv: 1e-5 of its largest
        # entry (~60 here) covers the fp32 summation-order difference
        assert _rel(tb.grad.numpy(), jdb) < 1e-6

    @pytest.mark.parametrize("causal", [True, False])
    def test_unbiased_matches_jax(self, causal):
        B, S, nh, hd = 1, 48, 2, 128
        qkv = _np(B, S, nh, 3 * hd, seed=4)
        jo = jfa.flash_attention_qkv(jnp.asarray(qkv), causal)
        to = tfa.flash_attention_qkv(_t(qkv), causal=causal)
        np.testing.assert_allclose(to.numpy(), np.asarray(jo), **TOL)

    def test_dropout_keeps_the_hash_mask_and_its_vjp(self):
        """The forward drops the normalized probabilities with
        ops/_dropout's bits of (seed, b*nh + h, query, key), the
        normalizer from the undropped ones; the backward is the VJP of
        that chain."""
        B, S, nh, hd, rate, seed = 2, 40, 2, 128, 0.2, 99
        qkv = _np(B, S, nh, 3 * hd, seed=5)
        bias = _np(nh * 3 * hd, seed=6, scale=0.1)
        do = _np(B, S, nh * hd, seed=7)
        keep = _dropout.keep_mask(seed, rate, (B * nh, S, S))

        def composed(q, b):
            x = (q + b.view(nh, 3 * hd)).permute(0, 2, 1, 3).reshape(
                B * nh, S, 3 * hd)
            qh, kh, vh = x.split(hd, dim=-1)
            s = qh @ kh.transpose(1, 2) / np.sqrt(hd)
            s = s.masked_fill(~torch.ones(S, S, dtype=torch.bool).tril(),
                              float("-inf"))
            p = torch.softmax(s, dim=-1)
            p = torch.where(keep, p / (1 - rate), 0.0)
            o = (p @ vh).reshape(B, nh, S, hd).permute(0, 2, 1, 3)
            return o.reshape(B, S, nh * hd)

        outs, grads = [], []
        for f in (
            lambda q, b: tfa.flash_attention_qkv_bias_dropout(
                q, b, seed, rate, causal=True),
            composed,
        ):
            tq, tb = _t(qkv, True), _t(bias, True)
            o = f(tq, tb)
            (o * _t(do)).sum().backward()
            outs.append(o.detach().numpy())
            grads.append((tq.grad.numpy(), tb.grad.numpy()))
        np.testing.assert_allclose(outs[0], outs[1], **TOL)
        for a, c in zip(grads[0], grads[1]):
            assert _rel(a, c) < 1e-5
        # the unbiased dropout entry draws the same bits
        o2 = tfa.flash_attention_qkv_dropout(
            _t(qkv + np.tile(bias.reshape(nh, 3 * hd), (B, S, 1, 1))), seed,
            rate, causal=True)
        np.testing.assert_allclose(o2.numpy(), outs[0], **TOL)

    def test_entry_points_check_their_operands(self):
        qkv = torch.zeros(1, 4, 2, 3 * 128)
        with pytest.raises(ValueError, match="qkv_bias"):
            tfa.flash_attention_qkv_bias(qkv, torch.zeros(7))
        with pytest.raises(ValueError, match="3\\*hd"):
            tfa.flash_attention_qkv(torch.zeros(1, 4, 2, 100))


# ---------------------------------------------------------------------------
# LayerNorm backward (and the residual forms' VJP)
# ---------------------------------------------------------------------------


def _ln_inputs(rows=10, hidden=48):
    return (_np(rows, hidden, seed=10, scale=2.0) + 0.5,
            _np(rows, hidden, seed=11), _np(hidden, seed=12),
            _np(hidden, seed=13))


class TestLayerNormBackward:
    def test_affine_vjp_matches_jax(self):
        x, _, w, b = _ln_inputs()
        dy = _np(*x.shape, seed=14)

        def jf(x, w, b):
            return jnp.sum(jln.layer_norm_affine(x, w, b, 1e-5) * dy)

        jg = jax.grad(jf, argnums=(0, 1, 2))(*map(jnp.asarray, (x, w, b)))
        ts = [_t(a, True) for a in (x, w, b)]
        y = tln.layer_norm_affine(*ts, 1e-5)
        (y * _t(dy)).sum().backward()
        np.testing.assert_allclose(
            y.detach().numpy(),
            np.asarray(jln.layer_norm_affine(*map(jnp.asarray, (x, w, b)),
                                             1e-5)), **TOL)
        for t, g in zip(ts, jg):
            np.testing.assert_allclose(t.grad.numpy(), np.asarray(g), **TOL)

    def test_residual_vjp_matches_jax(self):
        """The stream cotangent folds into dx; dx == ddelta."""
        x, d, w, b = _ln_inputs(rows=7, hidden=64)
        dy, ds = _np(7, 64, seed=15), _np(7, 64, seed=16)

        def jf(x, d, w, b):
            y, s = jln.layer_norm_residual_affine(x, d, w, b, 1e-5)
            return jnp.sum(y * dy) + jnp.sum(s * ds)

        jg = jax.grad(jf, argnums=(0, 1, 2, 3))(*map(jnp.asarray,
                                                      (x, d, w, b)))
        ts = [_t(a, True) for a in (x, d, w, b)]
        y, s = tln.layer_norm_residual_affine(*ts, 1e-5)
        ((y * _t(dy)).sum() + (s * _t(ds)).sum()).backward()
        for t, g in zip(ts, jg):
            np.testing.assert_allclose(t.grad.numpy(), np.asarray(g), **TOL)

    def test_plain_backward_returns_the_jax_partial_sums(self):
        """`_layer_norm_bwd` (the kernel's entry) against the JAX
        `_layer_norm_bwd` on saved statistics, with ds."""
        x, _, w, _ = _ln_inputs(rows=12, hidden=32)
        dy, ds = _np(12, 32, seed=17), _np(12, 32, seed=18)
        _, mu, rs = jln.layer_norm_fwd(jnp.asarray(x), jnp.asarray(w),
                                       jnp.asarray(w), 1e-5)
        jdx, jdg, jdb = jln._layer_norm_bwd(
            True, 1e-5, (jnp.asarray(x), jnp.asarray(w), mu, rs),
            jnp.asarray(dy), ds=jnp.asarray(ds))
        dx, dd, dg, db = tln._layer_norm_bwd(
            _t(x), _t(dy), _t(ds), _t(np.asarray(mu)), _t(np.asarray(rs)),
            _t(w))
        assert dd is None
        for a, c in ((dx, jdx), (dg, jdg), (db, jdb)):
            np.testing.assert_allclose(a.numpy(), np.asarray(c), **TOL)


class TestLayerNormDropout:
    """The residual form with dropout on the delta (the port's own bits;
    the checks of tests/L0/test_fused_layers.py
    TestLayerNormResidualDropoutTPU)."""

    rate = 0.25

    def _setup(self):
        rows, hidden = 300, 96
        x = _np(rows, hidden, seed=20)
        d = _np(rows, hidden, seed=21)
        # bounded away from 0 so s - x recovers the mask unambiguously
        delta = (np.sign(d) * (0.1 + np.abs(d))).astype(np.float32)
        return x, delta, _np(hidden, seed=22), _np(hidden, seed=23)

    def test_keep_fraction_and_kept_values(self):
        x, delta, w, b = self._setup()
        _, s = tln.layer_norm_residual_dropout_affine(
            _t(x), _t(delta), _t(w), _t(b), 77, self.rate, 1e-5)
        applied = s.numpy() - x
        keep = np.abs(applied) > 0
        assert abs(keep.mean() - (1 - self.rate)) < 0.02
        # atol: the recovery s - x re-rounds the fp32 sum
        np.testing.assert_allclose(applied[keep],
                                   (delta / (1 - self.rate))[keep],
                                   rtol=1e-5, atol=1e-6)
        np.testing.assert_array_equal(
            keep, _dropout.keep_mask(77, self.rate, x.shape).numpy())
        _, s2 = tln.layer_norm_residual_dropout_affine(
            _t(x), _t(delta), _t(w), _t(b), 77, self.rate, 1e-5)
        np.testing.assert_array_equal(s.numpy(), s2.numpy())

    def test_vjp_matches_the_composed_chain(self):
        x, delta, w, b = self._setup()
        seed = 12345
        _, s = tln.layer_norm_residual_dropout_affine(
            _t(x), _t(delta), _t(w), _t(b), seed, self.rate, 1e-5)
        keep = torch.from_numpy(np.abs(s.numpy() - x) > 0)
        cy, cs = _t(_np(*x.shape, seed=24)), _t(_np(*x.shape, seed=25))

        def fused(x, d, w, b):
            return tln.layer_norm_residual_dropout_affine(
                x, d, w, b, seed, self.rate, 1e-5)

        def composed(x, d, w, b):
            d = torch.where(keep, d / (1 - self.rate), 0.0)
            return tln.layer_norm_residual_affine(x, d, w, b, 1e-5)

        grads = []
        for f in (fused, composed):
            ts = [_t(a, True) for a in (x, delta, w, b)]
            y, s2 = f(*ts)
            ((y * cy).sum() + (s2 * cs).sum()).backward()
            grads.append([t.grad.numpy() for t in ts])
        for name, a, c in zip(("dx", "ddelta", "dw", "db"), *grads):
            assert _rel(a, c) < 2e-5, name


class TestDropoutHash:
    def test_golden_values(self):
        """hash32(seed, stream, row, col): murmur3's block mix of the
        three coordinates into the seed, then fmix32. csrc/dropout.cuh
        computes the same; these values pin both."""
        got = [int(_dropout.hash32(s, st, r, c)) for s, st, r, c in
               ((0, 0, 0, 0), (1, 0, 0, 0), (0, 1, 0, 0), (0, 0, 1, 0),
                (0, 0, 0, 1), (2**31 - 2, 127, 1023, 1023))]
        assert got == GOLDEN

    def test_tensor_form_matches_the_scalar_form(self):
        mask = _dropout.keep_mask(5, 0.5, (3, 4, 6))
        for st in range(3):
            for r in range(4):
                for c in range(6):
                    h = int(_dropout.hash32(5, st, r, c))
                    assert bool(mask[st, r, c]) == (
                        h >= _dropout.threshold(0.5))

    def test_keep_fraction_and_threshold(self):
        assert _dropout.threshold(0.0) == 0
        assert _dropout.threshold(0.1) == round(0.1 * 2**32)
        frac = _dropout.keep_mask(3, 0.1, (4, 256, 256)).float().mean()
        assert abs(float(frac) - 0.9) < 0.005
        with pytest.raises(ValueError):
            _dropout.threshold(1.0)

    def test_streams_rows_and_seeds_draw_different_bits(self):
        m = _dropout.keep_mask(1, 0.5, (2, 64, 64))
        assert not torch.equal(m[0], m[1])
        assert not torch.equal(m[0, 0], m[0, 1])
        assert not torch.equal(m, _dropout.keep_mask(2, 0.5, (2, 64, 64)))


# The values of hash32 for the cases of test_golden_values.
GOLDEN = [4235135213, 307707628, 668953513, 3093014679, 3117377966,
          4097976544]


# ---------------------------------------------------------------------------
# the fused linear + cross-entropy head
# ---------------------------------------------------------------------------


class TestLinearCrossEntropy:
    rows, hidden, vocab = 37, 16, 50  # 37 rows in chunks of 16: remainder

    def _inputs(self, pad=None):
        x = _np(self.rows, self.hidden, seed=30)
        w = _np(self.vocab, self.hidden, seed=31, scale=0.3)
        lbl = np.random.default_rng(32).integers(0, self.vocab, self.rows)
        if pad is not None:
            lbl[::5] = pad
        return x, w, lbl.astype(np.int32)

    @pytest.mark.parametrize("masked", [False, True])
    def test_mean_and_grads_match_jax(self, masked):
        """Smoothing 0.1, ``ignore_index`` rows, chunks of 16 rows over 37
        (a remainder chunk), with and without a loss mask."""
        x, w, lbl = self._inputs(pad=3)
        mask = (np.random.default_rng(33).random(self.rows) > 0.3
                ).astype(np.float32) if masked else None
        args = (0.1, 3, 16)

        def jf(x, w):
            return jlx.linear_cross_entropy_mean(
                x, w, jnp.asarray(lbl),
                None if mask is None else jnp.asarray(mask), *args)

        jl, (jdx, jdw) = jax.value_and_grad(jf, argnums=(0, 1))(
            jnp.asarray(x), jnp.asarray(w))
        tx, tw = _t(x, True), _t(w, True)
        tl = tlx.linear_cross_entropy_mean(
            tx, tw, _t(lbl).long(), None if mask is None else _t(mask),
            *args)
        (tl * 3.0).backward()  # a scaled loss, as under a loss scaler
        np.testing.assert_allclose(float(tl.detach()), float(jl), **TOL)
        np.testing.assert_allclose(tx.grad.numpy(), 3.0 * np.asarray(jdx),
                                   **TOL)
        np.testing.assert_allclose(tw.grad.numpy(), 3.0 * np.asarray(jdw),
                                   **TOL)

    def test_per_row_losses_and_vjp_match_jax(self):
        x, w, lbl = self._inputs(pad=7)
        dl = _np(self.rows, seed=34)

        def jf(x, w):
            return jnp.sum(jlx.linear_cross_entropy_loss(
                x, w, jnp.asarray(lbl), 0.05, 7, 16) * dl)

        jlosses = jlx.linear_cross_entropy_loss(
            jnp.asarray(x), jnp.asarray(w), jnp.asarray(lbl), 0.05, 7, 16)
        jdx, jdw = jax.grad(jf, argnums=(0, 1))(jnp.asarray(x),
                                                jnp.asarray(w))
        tx, tw = _t(x, True), _t(w, True)
        losses = tlx.linear_cross_entropy_loss(tx, tw, _t(lbl).long(), 0.05,
                                               7, 16)
        (losses * _t(dl)).sum().backward()
        np.testing.assert_allclose(losses.detach().numpy(),
                                   np.asarray(jlosses), **TOL)
        assert np.all(losses.detach().numpy()[lbl == 7] == 0.0)
        np.testing.assert_allclose(tx.grad.numpy(), np.asarray(jdx), **TOL)
        np.testing.assert_allclose(tw.grad.numpy(), np.asarray(jdw), **TOL)
