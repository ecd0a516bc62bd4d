"""The port's kernel modules against the JAX package, on the CPU.

For a CPU tensor each wrapper in ``rocm_apex_tpu_torch.ops`` runs its
kernel's plain PyTorch version; the JAX side runs its Pallas kernel in
interpret mode, as the JAX package's own tests do. Inputs are drawn with
numpy from a seed and handed to both. fp32 throughout, rtol/atol 1e-5:
both sides accumulate in fp32 and differ only in summation order.

The CUDA kernels themselves cannot run here; ``chip_smoke.py`` holds each
of them against these same plain versions on the card.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rocm_apex_tpu.normalization.fused_layer_norm import (
    mixed_dtype_fused_layer_norm_affine,
    mixed_dtype_fused_layer_norm_residual_affine,
)
from rocm_apex_tpu.ops import flash_attention as jfa
from rocm_apex_tpu.ops import flash_attention_segments as jfs
from rocm_apex_tpu.ops import layer_norm as jln
from rocm_apex_tpu_torch.normalization import MixedFusedLayerNorm
from rocm_apex_tpu_torch.ops import flash_attention as tfa
from rocm_apex_tpu_torch.ops import flash_attention_segments as tfs
from rocm_apex_tpu_torch.ops import layer_norm as tln

TOL = dict(rtol=1e-5, atol=1e-5)


def _np(*shape, seed, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape) * scale
            ).astype(np.float32)


def _t(a):
    return torch.from_numpy(np.asarray(a))


# ---------------------------------------------------------------------------
# LayerNorm forward
# ---------------------------------------------------------------------------


class TestLayerNorm:
    @pytest.mark.parametrize("affine", [True, False])
    def test_fwd_matches_jax(self, affine):
        x = _np(10, 48, seed=0, scale=3.0) + 1.5
        w = _np(48, seed=1) if affine else None
        b = _np(48, seed=2) if affine else None
        jy, jmu, jrs = jln.layer_norm_fwd(
            jnp.asarray(x), None if w is None else jnp.asarray(w),
            None if b is None else jnp.asarray(b), 1e-5,
        )
        ty, tmu, trs = tln.layer_norm_fwd(
            _t(x), None if w is None else _t(w),
            None if b is None else _t(b), 1e-5,
        )
        np.testing.assert_allclose(ty.numpy(), np.asarray(jy), **TOL)
        np.testing.assert_allclose(tmu.numpy(), np.asarray(jmu), **TOL)
        np.testing.assert_allclose(trs.numpy(), np.asarray(jrs), **TOL)
        if affine:
            np.testing.assert_allclose(
                tln.layer_norm_affine(_t(x), _t(w), _t(b), 1e-5).numpy(),
                np.asarray(jln.layer_norm_affine(*map(jnp.asarray, (x, w, b)),
                                                 1e-5)),
                **TOL,
            )

    def test_residual_matches_jax(self):
        x, d = _np(7, 64, seed=3), _np(7, 64, seed=4, scale=0.5)
        w, b = _np(64, seed=5), _np(64, seed=6)
        jy, js = jln.layer_norm_residual_affine(
            *map(jnp.asarray, (x, d, w, b)), 1e-5
        )
        ty, ts = tln.layer_norm_residual_affine(*map(_t, (x, d, w, b)), 1e-5)
        np.testing.assert_allclose(ty.numpy(), np.asarray(jy), **TOL)
        np.testing.assert_allclose(ts.numpy(), np.asarray(js), **TOL)

    def test_mixed_module_matches_jax(self):
        """`MixedFusedLayerNorm` on a bf16 stream: fp32 LN out (the
        weight dtype), the residual form's stream in bf16."""
        x = _np(2, 5, 32, seed=7)
        d = _np(2, 5, 32, seed=8)
        w, b = _np(32, seed=9), _np(32, seed=10)
        mod = MixedFusedLayerNorm(32, eps=1e-5, device="cpu")
        mod.weight.data.copy_(_t(w))
        mod.bias.data.copy_(_t(b))
        xb = _t(x).to(torch.bfloat16)
        db = _t(d).to(torch.bfloat16)
        jxb = jnp.asarray(x).astype(jnp.bfloat16)
        jdb = jnp.asarray(d).astype(jnp.bfloat16)

        # the module's parameters are trainable: read its outputs
        # without building a graph
        with torch.no_grad():
            y = mod(xb)
            y2, s2 = mod(db, residual=xb)
        jy = mixed_dtype_fused_layer_norm_affine(
            jxb, jnp.asarray(w), jnp.asarray(b), (32,), 1e-5
        )
        assert y.dtype == torch.float32
        np.testing.assert_allclose(y.numpy(), np.asarray(jy), **TOL)

        jy2, js2 = mixed_dtype_fused_layer_norm_residual_affine(
            jxb, jdb, jnp.asarray(w), jnp.asarray(b), (32,), 1e-5
        )
        assert y2.dtype == torch.float32 and s2.dtype == torch.bfloat16
        np.testing.assert_allclose(y2.numpy(), np.asarray(jy2), **TOL)
        np.testing.assert_array_equal(
            s2.float().numpy(), np.asarray(js2.astype(jnp.float32))
        )


# ---------------------------------------------------------------------------
# segment-masked packed attention
# ---------------------------------------------------------------------------


class TestSegments:
    @pytest.mark.parametrize("causal", [True, False])
    def test_unsorted_ids_with_pads_match_jax(self, causal):
        """Slot pieces in scheduler order (ids not sorted) and pads
        carrying the id num_slots, as the engine packs them."""
        seg = np.array([2] * 5 + [0] * 6 + [1] * 3 + [3] * 4, np.int32)
        h, total, d = 2, seg.size, 16
        q, k, v = (_np(h, total, d, seed=s) for s in (11, 12, 13))
        jo, jl = jfs.flash_attention_segments_with_lse(
            *map(jnp.asarray, (q, k, v, seg)), causal=causal
        )
        to, tl = tfs.flash_attention_segments_with_lse(
            *map(_t, (q, k, v, seg)), causal=causal
        )
        np.testing.assert_allclose(to.numpy(), np.asarray(jo), **TOL)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)


# ---------------------------------------------------------------------------
# cache decode read
# ---------------------------------------------------------------------------


def _cache(num_slots, capacity, heads, d, seed):
    return (_np(num_slots, capacity, heads, d, seed=seed),
            _np(num_slots, capacity, heads, d, seed=seed + 1))


def _jax_layout(c):
    """The transposed copy gpt.py feeds the JAX decode kernel:
    (slots, capacity, heads, d) -> (slots*heads, capacity, d)."""
    s, cap, h, d = c.shape
    return jnp.asarray(c).transpose(0, 2, 1, 3).reshape(s * h, cap, d)


class TestDecode:
    def test_decode_grid_matches_jax(self):
        """One query row per slot, bounds min(lengths + 1, capacity),
        with an empty slot (bound 0: zeros and lse -1e30)."""
        S, cap, h, d = 4, 24, 2, 16
        kc, vc = _cache(S, cap, h, d, seed=20)
        q = _np(S, h, d, seed=22)
        bound = np.array([5, 0, 24, 1], np.int32)
        jo, jl = jfa.flash_attention_decode(
            jnp.asarray(q).reshape(S * h, 1, d), _jax_layout(kc),
            _jax_layout(vc), jnp.repeat(jnp.asarray(bound), h),
            return_lse=True,
        )
        to, tl = tfa.flash_attention_decode(
            _t(q), _t(kc), _t(vc), _t(bound), return_lse=True
        )
        np.testing.assert_allclose(
            to.numpy(), np.asarray(jo).reshape(S, h, d), **TOL
        )
        np.testing.assert_allclose(
            tl.numpy(), np.asarray(jl).reshape(S, h), **TOL
        )
        assert np.all(to.numpy()[1] == 0.0) and np.all(tl.numpy()[1] == -1e30)

    def test_chunk_rows_read_their_own_slot(self):
        """Chunk piece B: each token against its OWN slot's pre-chunk
        prefix. The JAX model broadcasts the chunk against every slot
        and keeps slot_ids[t]'s answer; the port reads one slot per row.
        Pads (id num_slots) read nothing."""
        S, cap, h, d = 3, 24, 2, 16
        kc, vc = _cache(S, cap, h, d, seed=30)
        lengths = np.array([6, 0, 11], np.int32)
        slots = np.array([2, 2, 2, 0, 0, 1, 1, 3, 3], np.int32)
        t = slots.size
        q = _np(t, h, d, seed=32)
        qB = jnp.broadcast_to(
            jnp.asarray(q).transpose(1, 0, 2)[None], (S, h, t, d)
        ).reshape(S * h, t, d)
        jo, jl = jfa.flash_attention_decode(
            qB, _jax_layout(kc), _jax_layout(vc),
            jnp.repeat(jnp.asarray(lengths), h), return_lse=True,
        )
        jo = np.asarray(jo).reshape(S, h, t, d)
        jl = np.asarray(jl).reshape(S, h, t)
        to, tl = tfa.flash_attention_decode(
            _t(q), _t(kc), _t(vc), _t(lengths), return_lse=True,
            slot_ids=_t(slots),
        )
        live = slots < S
        tok = np.flatnonzero(live)
        np.testing.assert_allclose(
            to.numpy()[live], jo[slots[live], :, tok], **TOL
        )
        np.testing.assert_allclose(
            tl.numpy()[live], jl[slots[live], :, tok], **TOL
        )
        assert np.all(to.numpy()[~live] == 0.0)
        assert np.all(tl.numpy()[~live] == -1e30)

    def test_rejects_mismatched_cache(self):
        q = torch.zeros(2, 2, 16)
        kc = torch.zeros(2, 8, 2, 16)
        with pytest.raises(ValueError, match="heads/dim"):
            tfa.flash_attention_decode(
                q, torch.zeros(2, 8, 4, 16), torch.zeros(2, 8, 4, 16),
                torch.zeros(2, dtype=torch.int32),
            )
        with pytest.raises(ValueError, match="one query row per slot"):
            tfa.flash_attention_decode(
                torch.zeros(3, 2, 16), kc, kc,
                torch.zeros(2, dtype=torch.int32),
            )
