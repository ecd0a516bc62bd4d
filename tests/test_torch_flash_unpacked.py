"""The port's unpacked flash attention against the JAX package, on the CPU.

`flash_attention`, `flash_attention_varlen`, `flash_attention_with_lse`
and `flash_attention_dropout` on (batch*heads, seq, head_dim) operands
drawn with numpy. The JAX side runs its Pallas kernels (`_fwd_kernel`,
`_bwd_dkv_kernel`, `_bwd_dq_kernel`, `_bwd_dbias_kernel`) in interpret
mode, the port its kernels' plain versions. Both compute in fp32 and
differ in summation order only: outputs and gradients agree to 1e-5
relative with an absolute floor of 1e-5 (values are of order 1 to 10).

Dropout cannot be bit-matched against the TPU's PRNG, which has no
interpret-mode lowering; it is tested the three ways of ROADMAP.md's
parity rules (the keep fraction, kept probabilities scaled by 1/(1-p),
and a backward equal to autograd through the composed chain with the
recovered mask), and the keep bits are shown to be the packed path's.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rocm_apex_tpu.ops import flash_attention as jfa
from rocm_apex_tpu_torch.ops import flash_attention as fa

TOL = dict(rtol=1e-5, atol=1e-5)
NEG = -1e30


def _draw(bh, sq, sk, d, nb, seed):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((bh, sq, d)).astype(np.float32)
    k = rng.standard_normal((bh, sk, d)).astype(np.float32)
    v = rng.standard_normal((bh, sk, d)).astype(np.float32)
    do = rng.standard_normal((bh, sq, d)).astype(np.float32)
    dlse = rng.standard_normal((bh, sq)).astype(np.float32)
    bias = None
    if nb:
        bias = rng.standard_normal((nb, sq, sk)).astype(np.float32)
        bias[:, :, sk - 3:] = NEG  # padded keys
    return q, k, v, do, dlse, bias


def _torch(*arrays):
    return [None if a is None else torch.tensor(a, requires_grad=True)
            for a in arrays]


# (bh, sq, sk, head_dim, bias rows, causal): nb in {none, 1, batch,
# batch*heads} over batch 2 x 2 heads, square and ragged (no tile
# multiples), head_dim 64 and 128
CONFIGS = [
    (4, 20, 33, 64, 0, False),
    (4, 33, 20, 128, 1, True),
    (4, 20, 33, 64, 2, False),
    (4, 37, 37, 128, 4, True),
    (4, 70, 45, 64, 2, True),
    (4, 45, 70, 128, 4, False),
]


@pytest.mark.parametrize("bh,sq,sk,d,nb,causal", CONFIGS)
def test_forward_lse_and_gradients_match_jax(bh, sq, sk, d, nb, causal):
    """o, lse, dq, dk, dv and (compute_dbias=True) dbias of
    `flash_attention_with_lse` with a cotangent on both outputs."""
    q, k, v, do, dlse, bias = _draw(bh, sq, sk, d, nb, seed=sq * 7 + d)
    if causal and bias is not None:
        # a row whose every live score carries -1e30 is tiling-dependent
        # in the JAX kernel under causal masking (pinned below)
        bias[:, :, 0] = 0.0

    def jloss(q, k, v, b):
        o, lse = jfa.flash_attention_with_lse(
            q, k, v, b, causal, None, compute_dbias=b is not None)
        return (o * do).sum() + (lse * dlse).sum(), (o, lse)

    args = (0, 1, 2, 3) if nb else (0, 1, 2)
    (_, (jo, jl)), jg = jax.value_and_grad(jloss, argnums=args,
                                           has_aux=True)(
        *(None if a is None else jnp.asarray(a) for a in (q, k, v, bias)))
    tq, tk, tv, tb = _torch(q, k, v, bias)
    o, lse = fa.flash_attention_with_lse(tq, tk, tv, tb, causal,
                                         compute_dbias=nb > 0)
    ((o * torch.from_numpy(do)).sum()
     + (lse * torch.from_numpy(dlse)).sum()).backward()
    np.testing.assert_allclose(o.detach().numpy(), np.asarray(jo), **TOL)
    np.testing.assert_allclose(lse.detach().numpy(), np.asarray(jl), **TOL)
    for name, t, g in zip("qkvb", (tq, tk, tv, tb), jg):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(g), **TOL,
                                   err_msg=f"d{name}")


def test_flash_attention_matches_jax_and_defaults_to_no_dbias():
    """`flash_attention` (compute_dbias=False): o and dq/dk/dv as JAX; the
    bias gradient is exact zeros, as JAX returns it."""
    q, k, v, do, _, bias = _draw(4, 24, 40, 64, 2, seed=3)
    jb = jnp.asarray(bias)

    def jloss(q, k, v):
        return (jfa.flash_attention(q, k, v, jb, False) * do).sum()

    jg = jax.grad(jloss, argnums=(0, 1, 2))(
        *(jnp.asarray(a) for a in (q, k, v)))
    jo = jfa.flash_attention(*(jnp.asarray(a) for a in (q, k, v)), jb)
    tq, tk, tv, tb = _torch(q, k, v, bias)
    o = fa.flash_attention(tq, tk, tv, tb)
    (o * torch.from_numpy(do)).sum().backward()
    np.testing.assert_allclose(o.detach().numpy(), np.asarray(jo), **TOL)
    for t, g in zip((tq, tk, tv), jg):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(g), **TOL)
    assert torch.equal(tb.grad, torch.zeros_like(tb))


@pytest.mark.parametrize("causal", [False, True])
def test_varlen_matches_jax(causal):
    """Per-row key lengths, one shorter than a 64-key tile and one the
    full length; gradients in q/k/v."""
    bh, sq, sk, d = 4, 30, 90, 64
    q, k, v, do, _, _ = _draw(bh, sq, sk, d, 0, seed=11)
    lens = np.array([17, sk, 64, 5], np.int32)

    def jloss(q, k, v):
        o = jfa.flash_attention_varlen(q, k, v, jnp.asarray(lens), causal)
        return (o * do).sum(), o

    (_, jo), jg = jax.value_and_grad(jloss, argnums=(0, 1, 2),
                                     has_aux=True)(
        *(jnp.asarray(a) for a in (q, k, v)))
    tq, tk, tv = _torch(q, k, v)
    o = fa.flash_attention_varlen(tq, tk, tv, torch.from_numpy(lens), causal)
    (o * torch.from_numpy(do)).sum().backward()
    np.testing.assert_allclose(o.detach().numpy(), np.asarray(jo), **TOL)
    for t, g in zip((tq, tk, tv), jg):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(g), **TOL)


def test_a_fully_masked_row_is_zero_as_in_jax():
    """A query row whose every score carries the -1e30 padding bias (a
    padded position of masked BERT): o is 0 and lse is -1e30 * ln 2, as
    the JAX kernel gives (its running max starts at -1e30, so the row
    sums nothing), never NaN; its gradients are 0."""
    q, k, v, do, _, bias = _draw(4, 16, 16, 64, 2, seed=5)
    bias[0, 3, :] = NEG
    bias[1, :, 9:] = NEG  # keys 9.. padded for the second batch row
    bias[1, 9:, :] = NEG  # and its queries 9..
    jo, jl = jfa.flash_attention_with_lse(
        *(jnp.asarray(a) for a in (q, k, v, bias)))
    tq, tk, tv, tb = _torch(q, k, v, bias)
    o, lse = fa.flash_attention_with_lse(tq, tk, tv, tb)
    (o * torch.from_numpy(do)).sum().backward()
    np.testing.assert_allclose(o.detach().numpy(), np.asarray(jo), **TOL)
    np.testing.assert_allclose(lse.detach().numpy(), np.asarray(jl),
                               rtol=1e-6)
    dead = [(0, 3), (1, 3), (2, 9), (3, 15)]  # (bh, query); hp = 2
    for b, r in dead:
        assert torch.equal(o[b, r], torch.zeros_like(o[b, r]))
        assert float(lse.detach()[b, r]) == pytest.approx(NEG * fa.LN2,
                                                          rel=1e-6)
        assert torch.equal(tq.grad[b, r], torch.zeros_like(tq.grad[b, r]))
    assert bool(torch.isfinite(tq.grad).all())
    assert bool(torch.isfinite(tk.grad).all() & torch.isfinite(tv.grad).all())


def test_a_fully_biased_causal_row_is_zero_where_jax_depends_on_tiling():
    """Causal attention with a query row whose every live key carries the
    -1e30 bias. The JAX kernel has no single value there: its causally
    masked scores are -1e30 too, equal to the running max it starts from,
    so each counts exp2(0) = 1 and the row comes out as the mean of v over
    the keys past it in the key blocks it visits; the value changes with
    block_k. Its lse does not: -1e30 * ln 2. The port gives that lse and
    o = 0, as for a fully masked row without causal masking, whatever its
    tiling (its masked scores are -inf)."""
    q, k, v, _, _, _ = _draw(2, 256, 256, 64, 0, seed=8)
    bias = np.random.default_rng(9).standard_normal((1, 256, 256)).astype(
        np.float32)
    r = 5
    bias[0, r, :] = NEG
    args = [jnp.asarray(a) for a in (q, k, v, bias)]
    by_block = {}
    for block in (128, 256):
        jo, jl = jfa.flash_attention_with_lse(*args, causal=True,
                                              block_q=block, block_k=block)
        by_block[block] = (np.asarray(jo)[:, r], np.asarray(jl)[:, r])
        # the mean of v over keys r+1 .. the end of the visited blocks
        np.testing.assert_allclose(by_block[block][0],
                                   v[:, r + 1:block].mean(axis=1), **TOL)
    assert not np.allclose(by_block[128][0], by_block[256][0], **TOL)
    o, lse = fa.flash_attention_with_lse(
        *(torch.from_numpy(a) for a in (q, k, v, bias)), causal=True)
    assert torch.equal(o[:, r], torch.zeros_like(o[:, r]))
    for block in (128, 256):
        np.testing.assert_allclose(lse[:, r].numpy(), by_block[block][1],
                                   rtol=1e-6)
    # every other row is JAX's at its default block
    jo, jl = jfa.flash_attention_with_lse(*args, causal=True)
    live = np.arange(256) != r
    np.testing.assert_allclose(o.numpy()[:, live], np.asarray(jo)[:, live],
                               **TOL)
    np.testing.assert_allclose(lse.numpy()[:, live], np.asarray(jl)[:, live],
                               **TOL)


def test_bias_batch_must_divide_batch_heads():
    q, k, v, _, _, bias = _draw(4, 8, 8, 64, 3, seed=1)
    with pytest.raises(ValueError, match="must divide"):
        fa.flash_attention(*(torch.from_numpy(a) for a in (q, k, v, bias)))


def test_a_cuda_tensor_never_takes_the_plain_path():
    """The wrappers pick the plain version for CPU tensors only; any
    other device launches the kernel or raises."""
    q = torch.zeros(2, 8, 64, device="meta")
    with pytest.raises(RuntimeError, match="no kernel for device"):
        fa._unpacked_fwd(q[None], q[None], q[None], None, False, 0.125,
                         None, 0.0, 0)


class TestDropout:
    """`flash_attention_dropout`, tested the three ways of the parity
    rules, at head_dim 64 with sk == head_dim so that v = identity makes
    o the dropped probability matrix itself."""

    BH, S, D, RATE, SEED = 4, 64, 64, 0.1, 1234

    def _inputs(self):
        q, k, _, do, _, bias = _draw(self.BH, self.S, self.S, self.D, 2,
                                     seed=21)
        eye = np.broadcast_to(np.eye(self.S, dtype=np.float32),
                              (self.BH, self.S, self.S)).copy()
        return q, k, eye, do, bias

    def test_keep_fraction_and_kept_values(self):
        q, k, v, _, bias = self._inputs()
        tq, tk, tv, tb = (torch.from_numpy(a) for a in (q, k, v, bias))
        p = fa.flash_attention(tq, tk, tv, tb)  # the undropped softmax
        pd = fa.flash_attention_dropout(tq, tk, tv, tb, self.SEED,
                                        self.RATE)
        live = p > 0
        keep = pd != 0
        frac = float(keep[live].float().mean())
        assert abs(frac - (1 - self.RATE)) < 0.01, frac
        torch.testing.assert_close(pd[keep], p[keep] / (1 - self.RATE),
                                   rtol=1e-6, atol=0.0)
        # the normalizer sums the undropped probabilities
        torch.testing.assert_close(p.sum(-1)[live.any(-1)],
                                   torch.ones(int(live.any(-1).sum())))
        # the same seed draws the same bits, another seed others
        assert torch.equal(pd, fa.flash_attention_dropout(
            tq, tk, tv, tb, self.SEED, self.RATE))
        other = fa.flash_attention_dropout(tq, tk, tv, tb, self.SEED + 1,
                                           self.RATE)
        assert not torch.equal(other != 0, keep)

    def test_backward_regenerates_the_forward_mask(self):
        """The VJP equals autograd through softmax -> where(keep, p /
        (1 - rate), 0) -> @ v with the mask recovered from the forward."""
        q, k, v, do, bias = self._inputs()
        tq, tk, tv, tb = (torch.from_numpy(a) for a in (q, k, v, bias))
        keep = fa.flash_attention_dropout(tq, tk, tv, tb, self.SEED,
                                          self.RATE) != 0
        rng = np.random.default_rng(4)
        v2 = torch.from_numpy(
            rng.standard_normal((self.BH, self.S, self.D)).astype(np.float32))
        a = [t.clone().requires_grad_(True) for t in (tq, tk, v2)]
        fa.flash_attention_dropout(a[0], a[1], a[2], tb, self.SEED,
                                   self.RATE).mul(torch.from_numpy(do)).sum(
        ).backward()
        b = [t.clone().requires_grad_(True) for t in (tq, tk, v2)]
        s = torch.einsum("bqd,bkd->bqk", b[0], b[1]) / np.sqrt(self.D)
        s = (s.view(2, 2, self.S, self.S) + tb[:, None]).view_as(s)
        p = torch.softmax(s, dim=-1)
        o = torch.einsum("bqk,bkd->bqd",
                         torch.where(keep, p / (1 - self.RATE), 0.0), b[2])
        (o * torch.from_numpy(do)).sum().backward()
        for x, y in zip(a, b):
            torch.testing.assert_close(x.grad, y.grad, rtol=1e-4, atol=1e-5)

    @pytest.mark.parametrize("causal", [False, True])
    def test_the_keep_bits_are_the_packed_kernels(self, causal):
        """With no bias, the unpacked form on the per-head views of a
        fused projection equals the packed form on the projection (zero
        projection bias): the same hash of (seed, b*nh + h, query, key)."""
        B, S, nh, hd = 2, 40, 2, 64
        qkv = torch.from_numpy(np.random.default_rng(8).standard_normal(
            (B, S, nh, 3 * hd)).astype(np.float32))
        packed = fa.flash_attention_qkv_dropout(qkv, self.SEED, self.RATE,
                                                causal)
        q, k, v = (t.permute(0, 2, 1, 3).reshape(B * nh, S, hd)
                   for t in qkv.split(hd, dim=-1))
        o = fa.flash_attention_dropout(q, k, v, None, self.SEED, self.RATE,
                                       causal)
        got = o.view(B, nh, S, hd).permute(0, 2, 1, 3).reshape(B, S, -1)
        torch.testing.assert_close(got, packed, rtol=1e-5, atol=1e-6)
        heads = fa.flash_attention_heads(
            *(t.permute(0, 2, 1, 3) for t in qkv.split(hd, dim=-1)),
            causal=causal, dropout_seed=self.SEED, dropout_rate=self.RATE)
        torch.testing.assert_close(heads, packed, rtol=1e-5, atol=1e-6)
