"""The port's normalization API against the JAX package, on the CPU.

`fused_layer_norm`, `fused_layer_norm_affine`,
`mixed_dtype_fused_layer_norm_affine`, `FusedLayerNorm` (affine and not,
one- and multi-dim ``normalized_shape``) and `MixedFusedLayerNorm`, each
against its JAX function or flax module on numpy-drawn inputs, output
and gradients; and the non-affine backward's plain version (row 2's
``affine=False`` form) against JAX `_layer_norm_bwd`. The JAX side runs
its Pallas kernels (`_ln_fwd_kernel`, `_ln_bwd_kernel`) in interpret
mode, the port its kernels' plain versions. Both compute in fp32 and
differ in summation order only: 1e-5 on outputs of order 1, gradients
to 1e-5 relative with a 1e-4 floor (parameter gradients sum over rows).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rocm_apex_tpu import normalization as jnorm
from rocm_apex_tpu.ops import layer_norm as jln
from rocm_apex_tpu_torch import normalization as tnorm
from rocm_apex_tpu_torch.ops import layer_norm as ln

TOL = dict(rtol=1e-5, atol=1e-5)
GRAD_TOL = dict(rtol=1e-5, atol=1e-4)


def _draw(shape, hidden_shape, seed, dtype=np.float32):
    rng = np.random.default_rng(seed)
    x = (2.0 * rng.standard_normal(shape) + 0.5).astype(dtype)
    w = (1.0 + 0.2 * rng.standard_normal(hidden_shape)).astype(np.float32)
    b = (0.2 * rng.standard_normal(hidden_shape)).astype(np.float32)
    dy = rng.standard_normal(shape).astype(np.float32)
    return x, w, b, dy


def _grads_jax(fn, args, dy):
    def loss(*a):
        out = fn(*a)
        return (out.astype(jnp.float32) * dy).sum(), out

    n = len(args)
    (_, out), g = jax.value_and_grad(loss, argnums=tuple(range(n)),
                                     has_aux=True)(*args)
    return np.asarray(out), [np.asarray(t) for t in g]


def _grads_torch(fn, args, dy):
    ts = [torch.tensor(a, requires_grad=True) for a in args]
    out = fn(*ts)
    (out.float() * torch.tensor(dy)).sum().backward()
    return out.detach().numpy(), [t.grad.numpy() for t in ts]


SHAPES = [((4, 6, 32), 32), ((3, 5, 4, 8), (4, 8)), ((7, 64), (64,))]


@pytest.mark.parametrize("shape,norm", SHAPES)
def test_fused_layer_norm_matches_jax(shape, norm):
    """Non-affine: output and dx (the non-affine backward)."""
    x, _, _, dy = _draw(shape, norm, seed=len(shape))
    jo, jg = _grads_jax(lambda x: jnorm.fused_layer_norm(x, norm),
                        [jnp.asarray(x)], dy)
    to, tg = _grads_torch(lambda x: tnorm.fused_layer_norm(x, norm), [x],
                          dy)
    np.testing.assert_allclose(to, jo, **TOL)
    np.testing.assert_allclose(tg[0], jg[0], **GRAD_TOL)


@pytest.mark.parametrize("shape,norm", SHAPES)
def test_fused_layer_norm_affine_matches_jax(shape, norm):
    x, w, b, dy = _draw(shape, norm, seed=10 + len(shape))
    args = [x, w, b]
    jo, jg = _grads_jax(
        lambda x, w, b: jnorm.fused_layer_norm_affine(x, w, b, norm),
        [jnp.asarray(a) for a in args], dy)
    to, tg = _grads_torch(
        lambda x, w, b: tnorm.fused_layer_norm_affine(x, w, b, norm), args,
        dy)
    np.testing.assert_allclose(to, jo, **TOL)
    for a, b_ in zip(tg, jg):
        np.testing.assert_allclose(a, b_, **GRAD_TOL)


def test_mixed_dtype_affine_matches_jax_and_defaults_to_eps_1e_6():
    """x in bf16 is widened to the fp32 weight's dtype; the output is
    fp32; eps defaults to 1e-6 (visible on a row of tiny variance)."""
    x, w, b, dy = _draw((6, 48), 48, seed=3)
    x[0] = 1e-3 * x[0]
    xb = torch.tensor(x).to(torch.bfloat16)
    jx = jnp.asarray(xb.float().numpy()).astype(jnp.bfloat16)
    jo = jnorm.mixed_dtype_fused_layer_norm_affine(jx, jnp.asarray(w),
                                                   jnp.asarray(b), 48)
    to = tnorm.mixed_dtype_fused_layer_norm_affine(
        xb, torch.tensor(w), torch.tensor(b), 48)
    assert to.dtype == torch.float32 and jo.dtype == jnp.float32
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), **TOL)
    at_5 = tnorm.mixed_dtype_fused_layer_norm_affine(
        xb, torch.tensor(w), torch.tensor(b), 48, eps=1e-5)
    assert not np.allclose(at_5[0].numpy(), to[0].numpy(), rtol=1e-3)
    # its gradient in x (cast back to bf16) and in the parameters
    jo, jg = _grads_jax(
        lambda x, w, b: jnorm.mixed_dtype_fused_layer_norm_affine(x, w, b,
                                                                  48),
        [jnp.asarray(x), jnp.asarray(w), jnp.asarray(b)], dy)
    to, tg = _grads_torch(
        lambda x, w, b: tnorm.mixed_dtype_fused_layer_norm_affine(x, w, b,
                                                                  48),
        [x, w, b], dy)
    np.testing.assert_allclose(to, jo, **TOL)
    for a, b_ in zip(tg, jg):
        np.testing.assert_allclose(a, b_, **GRAD_TOL)


def test_affine_output_follows_the_input_dtype():
    x, w, b, _ = _draw((4, 32), 32, seed=4)
    xb = torch.tensor(x).to(torch.bfloat16)
    y = tnorm.fused_layer_norm_affine(xb, torch.tensor(w), torch.tensor(b),
                                      32)
    assert y.dtype == torch.bfloat16
    jy = jnorm.fused_layer_norm_affine(
        jnp.asarray(xb.float().numpy()).astype(jnp.bfloat16),
        jnp.asarray(w), jnp.asarray(b), 32)
    np.testing.assert_allclose(y.float().numpy(),
                               np.asarray(jy, np.float32), rtol=2.0 ** -7,
                               atol=1e-5)


@pytest.mark.parametrize("affine", [True, False])
@pytest.mark.parametrize("shape,norm", SHAPES[:2])
def test_fused_layer_norm_module_matches_flax(shape, norm, affine):
    x, w, b, dy = _draw(shape, norm, seed=20 + affine)
    jmod = jnorm.FusedLayerNorm(norm, elementwise_affine=affine)
    params = jmod.init(jax.random.PRNGKey(0), jnp.asarray(x))
    tmod = tnorm.FusedLayerNorm(norm, elementwise_affine=affine,
                                device="cpu")
    if affine:
        params = {"params": {"weight": jnp.asarray(w),
                             "bias": jnp.asarray(b)}}
        with torch.no_grad():
            tmod.weight.copy_(torch.tensor(w))
            tmod.bias.copy_(torch.tensor(b))
    else:
        assert not params and tmod.weight is None and tmod.bias is None
        assert not list(tmod.parameters())

    def jf(p, x):
        return jmod.apply(p, x)

    (_, jo), (jgp, jgx) = jax.value_and_grad(
        lambda p, x: ((jf(p, x) * dy).sum(), jf(p, x)), argnums=(0, 1),
        has_aux=True)(params, jnp.asarray(x))
    tx = torch.tensor(x, requires_grad=True)
    to = tmod(tx)
    (to * torch.tensor(dy)).sum().backward()
    np.testing.assert_allclose(to.detach().numpy(), np.asarray(jo), **TOL)
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(jgx), **GRAD_TOL)
    if affine:
        assert tuple(tmod.weight.shape) == tuple(np.shape(w))
        np.testing.assert_allclose(tmod.weight.grad.numpy(),
                                   np.asarray(jgp["params"]["weight"]),
                                   **GRAD_TOL)
        np.testing.assert_allclose(tmod.bias.grad.numpy(),
                                   np.asarray(jgp["params"]["bias"]),
                                   **GRAD_TOL)


def test_mixed_fused_layer_norm_module_matches_flax():
    x, w, b, dy = _draw((5, 64), 64, seed=30)
    xb = torch.tensor(x).to(torch.bfloat16)
    jmod = jnorm.MixedFusedLayerNorm(64)
    jp = {"params": {"weight": jnp.asarray(w), "bias": jnp.asarray(b)}}
    jo = jmod.apply(jp, jnp.asarray(xb.float().numpy()).astype(jnp.bfloat16))
    tmod = tnorm.MixedFusedLayerNorm(64, device="cpu")
    with torch.no_grad():
        tmod.weight.copy_(torch.tensor(w))
        tmod.bias.copy_(torch.tensor(b))
    to = tmod(xb)
    assert to.dtype == torch.float32
    np.testing.assert_allclose(to.detach().numpy(), np.asarray(jo), **TOL)


def test_exports_match_the_jax_package():
    assert sorted(tnorm.__all__) == sorted(jnorm.__all__)
    for name in jnorm.__all__:
        assert hasattr(tnorm, name)


def test_shape_mismatch_raises():
    with pytest.raises(ValueError, match="normalized_shape"):
        tnorm.fused_layer_norm(torch.zeros(2, 3, 5), (4, 5))


@pytest.mark.parametrize("rows", [8, 70])
@pytest.mark.parametrize("with_ds", [False, True])
def test_plain_non_affine_backward_matches_jax(rows, with_ds):
    """`layer_norm_bwd_plain` with no weight (the kernel's plain version)
    against JAX `_layer_norm_bwd(affine=False)`: dx, no dgamma/dbeta."""
    rng = np.random.default_rng(rows + with_ds)
    hidden = 96
    x = rng.standard_normal((rows, hidden)).astype(np.float32)
    dy = rng.standard_normal((rows, hidden)).astype(np.float32)
    ds = (rng.standard_normal((rows, hidden)).astype(np.float32)
          if with_ds else None)
    _, mu, rs = jln.layer_norm_fwd(jnp.asarray(x), None, None, 1e-5)
    (jdx,) = jln._layer_norm_bwd(
        False, 1e-5, (jnp.asarray(x), None, mu, rs), jnp.asarray(dy),
        ds=None if ds is None else jnp.asarray(ds))
    dx, dd, dg, db = ln.layer_norm_bwd_plain(
        torch.tensor(x), torch.tensor(dy),
        None if ds is None else torch.tensor(ds),
        torch.tensor(np.asarray(mu).reshape(-1)),
        torch.tensor(np.asarray(rs).reshape(-1)), None)
    assert dd is None and dg is None and db is None
    np.testing.assert_allclose(dx.numpy(), np.asarray(jdx), **TOL)
    # the CPU wrapper takes the same plain version
    got = ln._layer_norm_bwd(
        torch.tensor(x), torch.tensor(dy),
        None if ds is None else torch.tensor(ds),
        torch.tensor(np.asarray(mu).reshape(-1)),
        torch.tensor(np.asarray(rs).reshape(-1)), None)
    assert torch.equal(got[0], dx) and got[2] is None


def test_layer_norm_autograd_matches_jax():
    """`ops.layer_norm` (the non-affine autograd function) against JAX
    `ops.layer_norm`."""
    x, _, _, dy = _draw((33, 40), 40, seed=40)
    jo, jg = _grads_jax(lambda x: jln.layer_norm(x, 1e-5), [jnp.asarray(x)],
                        dy)
    to, tg = _grads_torch(lambda x: ln.layer_norm(x, 1e-5), [x], dy)
    np.testing.assert_allclose(to, jo, **TOL)
    np.testing.assert_allclose(tg[0], jg[0], **GRAD_TOL)
