"""The port's fused-bottleneck ops (`ops.fused_bottleneck`) and
`contrib.bottleneck.FusedBottleneck` against the JAX package, on the CPU.

The JAX side runs its Pallas kernels (`_mm_fwd_kernel`,
`_conv3_fwd_kernel`, `_mm_bwd_kernel`, `_conv3_bwd_kernel`) in interpret
mode, at its default block sizes (a grid of one on these shapes) and with
the shrunk VMEM targets of tests/L0/test_fused_bottleneck.py, which force
a grid > 1 through the 3x3 halo windows; and `bottleneck_fused`'s custom
VJP. The port runs the kernels' plain versions through the same wrappers
and autograd function the card runs. Inputs are numpy-drawn fp32 on a
(2, 12, 10) image stream. Both sides compute in fp32 and differ in
summation order only: outputs rtol 1e-5 (atol 1e-5 on values of order
1); sums over the pixels (statistics, dw, the reductions) and gradients
within 1e-4 of their scale (the max |value| of the reference); the BN
coefficients rtol 1e-5 (XLA may fuse ``beta - mean * scale`` into one
multiply-add, which the port rounds twice: one fp32 ulp apart).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import rocm_apex_tpu.ops.fused_bottleneck as jfb
from rocm_apex_tpu.contrib.bottleneck import FusedBottleneck as JaxFused
from rocm_apex_tpu_torch.contrib.bottleneck import FusedBottleneck
from rocm_apex_tpu_torch.ops import fused_bottleneck as fb

SHAPE = (2, 12, 10)  # (n, H, W): M = 240 pixels
FWD = dict(rtol=1e-5, atol=1e-5)
EPS = 1e-5


def _draw(shape, seed, scale=1.0, shift=0.0):
    rng = np.random.default_rng(seed)
    return (shift + scale * rng.standard_normal(shape)).astype(np.float32)


def _t(a):
    return None if a is None else torch.from_numpy(np.asarray(a))


def _j(a):
    return None if a is None else jnp.asarray(a)


def _close(got, ref, what, rtol=1e-5, atol=1e-5):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    np.testing.assert_allclose(got, np.asarray(ref), rtol=rtol, atol=atol,
                               err_msg=what)


def _close_scaled(got, ref, what, share=1e-4):
    """Within ``share`` of the reference's largest |value| (a sum over
    many pixels, or a gradient)."""
    ref = np.asarray(ref)
    scale = max(float(np.abs(ref).max()), 1e-6)
    _close(got, ref, what, rtol=0.0, atol=share * scale)


@pytest.fixture(params=["default", "grid"])
def jax_blocks(request, monkeypatch):
    """JAX's default blocks, or the shrunk targets that cut the (2, 12,
    10) stream into several chunks (the halo path)."""
    if request.param == "grid":
        monkeypatch.setitem(jfb.config, "c3_fwd_target", 3 * 1024)
        monkeypatch.setitem(jfb.config, "c3_bwd_target", 2 * 1024)
        monkeypatch.setitem(jfb.config, "mm_target", 3 * 1024)
        assert jfb._pix_block(240, 16, 8, 16,
                              jfb.config["c3_fwd_target"]) < 240
    return request.param


@pytest.mark.parametrize("prologue", [False, True])
@pytest.mark.parametrize("stats", [False, True])
def test_conv1x1_fwd(jax_blocks, prologue, stats):
    m, k, n = int(np.prod(SHAPE)), 16, 32
    x = _draw((m, k), 0)
    w = _draw((k, n), 1, 0.3)
    a = _draw((k,), 2, 0.2, 1.0) if prologue else None
    b = _draw((k,), 3, 0.2) if prologue else None
    jy, js = jfb.conv1x1_bn_act(_j(x), _j(w), _j(a), _j(b), stats=stats)
    ty, ts = fb.conv1x1_bn_act(_t(x), _t(w), _t(a), _t(b), stats=stats)
    _close(ty, jy, "y", **FWD)
    assert (ts is None) == (js is None)
    if stats:
        _close_scaled(ts[0], js[0], "sum")
        _close_scaled(ts[1], js[1], "sum of squares")


@pytest.mark.parametrize("prologue", [False, True])
@pytest.mark.parametrize("stats", [False, True])
def test_conv3x3_fwd(jax_blocks, prologue, stats):
    cin, cout = 8, 16
    x = _draw(SHAPE + (cin,), 4)
    w = _draw((3, 3, cin, cout), 5, 0.3)
    a = _draw((cin,), 6, 0.2, 1.0) if prologue else None
    b = _draw((cin,), 7, 0.2) if prologue else None
    jy, js = jfb.conv3x3_bn_act(_j(x), _j(w), _j(a), _j(b), stats=stats)
    ty, ts = fb.conv3x3_bn_act(_t(x), _t(w), _t(a), _t(b), stats=stats)
    assert ty.shape == jy.shape
    _close(ty, jy, "y", **FWD)
    if stats:
        _close_scaled(ts[0], js[0], "sum")
        _close_scaled(ts[1], js[1], "sum of squares")


# (premask, finalize, prologue, reduce, wgrad, dgrad): the block's three
# calls (conv3: all but none; conv1: finalize; downsample: premask +
# finalize), the bare products and the single halves
MM_BWD_FLAGS = [
    (True, True, True, True, True, True),
    (False, True, False, False, True, True),
    (True, True, False, False, True, True),
    (False, False, False, False, True, True),
    (False, False, True, True, True, True),
    (True, False, False, False, False, True),
    (False, True, True, False, True, False),
    (False, True, True, True, False, True),
]


@pytest.mark.parametrize("flags", MM_BWD_FLAGS,
                         ids=lambda f: "".join("PFXRWD"[i] if v else "-"
                                               for i, v in enumerate(f)))
def test_conv1x1_bwd(jax_blocks, flags):
    premask, finalize, prologue, reduce, wgrad, dgrad = flags
    m, k, n = int(np.prod(SHAPE)), 16, 32
    e = _draw((m, n), 10)
    w = _draw((k, n), 11, 0.3)
    x = _draw((m, k), 12)
    z = _draw((m, n), 13) if premask else None
    y_fin = ((_draw((m, n), 14), _draw((n,), 15, 0.3, 1.0),
              _draw((n,), 16, 0.1), _draw((n,), 17, 0.1))
             if finalize else None)
    pro = (_draw((k,), 18, 0.2, 1.0), _draw((k,), 19, 0.2)) if prologue \
        else None
    red = (_draw((k,), 20, 0.1), np.abs(_draw((k,), 21, 0.2, 1.0))) \
        if reduce else None
    jouts = jfb.conv1x1_bn_act_bwd(
        _j(e), _j(w), _j(x), z=_j(z),
        y_fin=None if y_fin is None else tuple(map(_j, y_fin)),
        prologue=None if pro is None else tuple(map(_j, pro)),
        reduce_stats=None if red is None else tuple(map(_j, red)),
        wgrad=wgrad, dgrad=dgrad)
    touts = fb.conv1x1_bn_act_bwd(
        _t(e), _t(w), _t(x), z=_t(z),
        y_fin=None if y_fin is None else tuple(map(_t, y_fin)),
        prologue=None if pro is None else tuple(map(_t, pro)),
        reduce_stats=None if red is None else tuple(map(_t, red)),
        wgrad=wgrad, dgrad=dgrad)
    for name, tv, jv in zip(("g", "dw", "r1", "r2"), touts, jouts):
        assert (tv is None) == (jv is None), name
        if tv is None:
            continue
        if name == "g":
            _close(tv, jv, name, **FWD)
        else:
            _close_scaled(tv, jv, name)


@pytest.mark.parametrize("finalize", [False, True])
def test_conv3x3_bwd(jax_blocks, finalize):
    cin, cout = 8, 16
    e = _draw(SHAPE + (cout,), 30)
    w = _draw((3, 3, cin, cout), 31, 0.3)
    x = _draw(SHAPE + (cin,), 32)
    y_fin = ((_draw(SHAPE + (cout,), 33), _draw((cout,), 34, 0.3, 1.0),
              _draw((cout,), 35, 0.1), _draw((cout,), 36, 0.1))
             if finalize else None)
    pro = (_draw((cin,), 37, 0.2, 1.0), _draw((cin,), 38, 0.2))
    red = (_draw((cin,), 39, 0.1), np.abs(_draw((cin,), 40, 0.2, 1.0)))
    jouts = jfb.conv3x3_bn_act_bwd(
        _j(e), _j(w), _j(x),
        None if y_fin is None else tuple(map(_j, y_fin)),
        tuple(map(_j, pro)), tuple(map(_j, red)))
    touts = fb.conv3x3_bn_act_bwd(
        _t(e), _t(w), _t(x),
        None if y_fin is None else tuple(map(_t, y_fin)),
        tuple(map(_t, pro)), tuple(map(_t, red)))
    _close(touts[0], jouts[0], "g", **FWD)
    assert touts[1].shape == jouts[1].shape
    for name, tv, jv in zip(("dw", "r1", "r2"), touts[1:], jouts[1:]):
        _close_scaled(tv, jv, name)


def test_bn_coeffs():
    s1, s2 = _draw((16,), 50, 3.0), np.abs(_draw((16,), 51, 5.0, 20.0))
    g, b = _draw((16,), 52, 0.2, 1.0), _draw((16,), 53, 0.2)
    # one channel whose single-pass variance rounds below 0: clamped
    s2[0] = s1[0] ** 2 / 240.0 * 0.999
    jv = jfb.bn_coeffs((_j(s1), _j(s2)), 240, _j(g), _j(b), EPS)
    tv = fb.bn_coeffs((_t(s1), _t(s2)), 240, _t(g), _t(b), EPS)
    for name, t, j in zip(("mean", "rs", "scale", "bias"), tv, jv):
        _close(t, j, name, rtol=1e-5, atol=1e-7)
    r1, r2 = _draw((16,), 54, 2.0), _draw((16,), 55, 2.0)
    jk = jfb.bn_finalize_coeffs(_j(r1), _j(r2), jv[0], jv[1], _j(g), 240)
    tk = fb.bn_finalize_coeffs(_t(r1), _t(r2), tv[0], tv[1], _t(g), 240)
    for name, t, j in zip(("k1", "k2", "k0"), tk, jk):
        _close(t, j, name, rtol=1e-5, atol=1e-9)


def _block_params(cin, cmid, cout, downsample, seed):
    p = [_draw((cin, cmid), seed, 0.3), _draw((cmid,), seed + 1, 0.1, 1.0),
         _draw((cmid,), seed + 2, 0.1),
         _draw((3, 3, cmid, cmid), seed + 3, 0.2),
         _draw((cmid,), seed + 4, 0.1, 1.0), _draw((cmid,), seed + 5, 0.1),
         _draw((cmid, cout), seed + 6, 0.3),
         _draw((cout,), seed + 7, 0.1, 1.0), _draw((cout,), seed + 8, 0.1)]
    if downsample:
        p += [_draw((cin, cout), seed + 9, 0.3),
              _draw((cout,), seed + 10, 0.1, 1.0),
              _draw((cout,), seed + 11, 0.1)]
    else:
        p += [None, None, None]
    return p


@pytest.mark.parametrize("downsample", [False, True])
def test_bottleneck_fused(downsample):
    cin, cmid, cout = (8, 8, 16) if downsample else (16, 8, 16)
    x = _draw(SHAPE + (cin,), 60)
    params = _block_params(cin, cmid, cout, downsample, 61)
    dz = _draw(SHAPE + (cout,), 80)
    n_in = 10 if downsample else 7

    def jfun(x, *ps):
        full = list(ps) + [None] * (12 - len(ps))
        return jfb.bottleneck_fused(EPS, downsample, x, *full)

    jargs = [_j(x)] + [_j(p) for p in params[:n_in + 2]]
    (jz, jstats), vjp = jax.vjp(jfun, *jargs)
    jgrads = vjp((_j(dz), jax.tree_util.tree_map(jnp.zeros_like, jstats)))

    targs = [_t(a).requires_grad_(True) if a is not None else None
             for a in [x] + params]
    tz, tstats = fb.bottleneck_fused(EPS, downsample, *targs)
    _close(tz, jz, "z", **FWD)
    for i, (tst, jst) in enumerate(zip(tstats, jstats)):
        assert (tst is None) == (jst is None)
        if tst is not None:
            _close(tst[0], jst[0], f"bn{i + 1} mean", rtol=1e-5, atol=1e-6)
            _close(tst[1], jst[1], f"bn{i + 1} var", rtol=1e-5, atol=1e-6)
            assert not tst[0].requires_grad
    tz.backward(_t(dz))
    names = ["x", "w1", "g1", "b1", "w2", "g2", "b2", "w3", "g3", "b3",
             "wd", "gd", "bd"]
    for name, ta, jg in zip(names, targs, jgrads):
        if ta is None:
            continue
        _close_scaled(ta.grad, jg, f"d{name}")


def _module_case(cin, cmid, cout, seed):
    jm = JaxFused(in_channels=cin, bottleneck_channels=cmid,
                  out_channels=cout, dtype=jnp.float32)
    x = _draw(SHAPE + (cin,), seed)
    vs = jm.init(jax.random.PRNGKey(seed), _j(x))
    params = jax.tree_util.tree_map(
        lambda a: np.asarray(a) * (1.0 + 0.1 * _draw(a.shape, seed + 1)),
        vs["params"])
    stats = jax.tree_util.tree_map(np.asarray, vs["batch_stats"])
    stats = {k: (v + 0.1 * np.abs(_draw(v.shape, seed + 2))) for k, v in
             stats.items()}
    tm = FusedBottleneck(cin, cmid, cout, dtype=torch.float32, device="cpu")
    with torch.no_grad():
        for k, v in params.items():
            getattr(tm, k).copy_(_t(v))
        for k, v in stats.items():
            getattr(tm, k).copy_(_t(v))
    return jm, tm, x, params, stats


@pytest.mark.parametrize("cin", [8, 16])
def test_fused_bottleneck_module(cin):
    jm, tm, x, params, stats = _module_case(cin, 8, 16, 90 + cin)
    z, mut = jm.apply({"params": params, "batch_stats": stats}, _j(x),
                      mutable=["batch_stats"])
    tz = tm(_t(x), train=True)
    _close(tz, z, "z", **FWD)
    for k, v in mut["batch_stats"].items():
        _close(getattr(tm, k), v, k, rtol=1e-5, atol=1e-6)
    # eval: the plain chain on the running statistics just updated
    ze = jm.apply({"params": params, "batch_stats": mut["batch_stats"]},
                  _j(x), train=False)
    with torch.no_grad():
        tze = tm(_t(x), train=False)
    _close(tze, ze, "eval z", **FWD)


# ---------------------------------------------------------------------------
# channel counts that are no multiple of 16: the kernels take multiples of
# 8 natively (their tiles zero-fill the channel tail at that grain) and any
# other count through a zero-padded copy (`channel_plan`), on either
# device; JAX takes every count
# ---------------------------------------------------------------------------

WIDTHS = [8, 12, 20, 40, 13]


@pytest.mark.parametrize("c", WIDTHS)
def test_channel_plan_names_each_count(c):
    """No refusal; the route is "native" at a multiple of 8, else
    "padded" to the next one, its copies' bytes counted; the product
    plans send such a count to the staged core (the pipe takes multiples
    of 64)."""
    for dt in (torch.float32, torch.bfloat16, torch.float16):
        fb._check_channels(dt, c, c, c)
        plan = fb.channel_plan((c, c), 240, dt)
        padded = -(-c // 8) * 8
        assert plan["route"] == ("native" if c % 8 == 0 else "padded")
        assert plan["kernel_counts"] == (padded, padded)
        assert plan["pad_bytes"] == 240 * 2 * (padded - c) * (
            torch.empty((), dtype=dt).element_size())
        assert fb.mm_fwd_plan(240, c, c, dt, 132)["route"] == "staged"
        assert fb.conv3_fwd_plan(240, c, c, dt, 132)["route"] == "staged"
        assert fb.mm_bwd_plan(240, c, c, dt, 132)["route"] == "staged"


@pytest.mark.parametrize("c", WIDTHS)
def test_widths_match_jax(c):
    """The four ops at c channels in and out against JAX's kernels: the
    1x1 and 3x3 forwards with the prologue and statistics, the 1x1
    backward with every part on, the 3x3 backward with the finalize."""
    m = int(np.prod(SHAPE))
    x = _draw((m, c), 50 + c)
    w = _draw((c, c), 51 + c, 0.3)
    a, b = _draw((c,), 52 + c, 0.2, 1.0), _draw((c,), 53 + c, 0.2)
    jy, js = jfb.conv1x1_bn_act(_j(x), _j(w), _j(a), _j(b), stats=True)
    ty, ts = fb.conv1x1_bn_act(_t(x), _t(w), _t(a), _t(b), stats=True)
    _close(ty, jy, "1x1 y", **FWD)
    _close_scaled(ts[0], js[0], "1x1 sum")
    _close_scaled(ts[1], js[1], "1x1 sum of squares")
    x4, w3 = x.reshape(SHAPE + (c,)), _draw((3, 3, c, c), 54 + c, 0.3)
    jy, js = jfb.conv3x3_bn_act(_j(x4), _j(w3), _j(a), _j(b), stats=True)
    ty, ts = fb.conv3x3_bn_act(_t(x4), _t(w3), _t(a), _t(b), stats=True)
    _close(ty, jy, "3x3 y", **FWD)
    _close_scaled(ts[1], js[1], "3x3 sum of squares")
    e, z = _draw((m, c), 55 + c), _draw((m, c), 56 + c)
    y_fin = (_draw((m, c), 57 + c), _draw((c,), 58 + c, 0.3, 1.0),
             _draw((c,), 59 + c, 0.1), _draw((c,), 60 + c, 0.1))
    red = (_draw((c,), 61 + c, 0.1), np.abs(_draw((c,), 62 + c, 0.2, 1.0)))
    jouts = jfb.conv1x1_bn_act_bwd(
        _j(e), _j(w), _j(x), z=_j(z), y_fin=tuple(map(_j, y_fin)),
        prologue=(_j(a), _j(b)), reduce_stats=tuple(map(_j, red)))
    touts = fb.conv1x1_bn_act_bwd(
        _t(e), _t(w), _t(x), z=_t(z), y_fin=tuple(map(_t, y_fin)),
        prologue=(_t(a), _t(b)), reduce_stats=tuple(map(_t, red)))
    _close(touts[0], jouts[0], "1x1 g", **FWD)
    for name, tv, jv in zip(("dw", "r1", "r2"), touts[1:], jouts[1:]):
        assert tuple(tv.shape) == tuple(jv.shape), name
        _close_scaled(tv, jv, "1x1 " + name)
    e4, y4 = e.reshape(SHAPE + (c,)), y_fin[0].reshape(SHAPE + (c,))
    jouts = jfb.conv3x3_bn_act_bwd(
        _j(e4), _j(w3), _j(x4), (_j(y4), *map(_j, y_fin[1:])),
        (_j(a), _j(b)), tuple(map(_j, red)))
    touts = fb.conv3x3_bn_act_bwd(
        _t(e4), _t(w3), _t(x4), (_t(y4), *map(_t, y_fin[1:])),
        (_t(a), _t(b)), tuple(map(_t, red)))
    _close(touts[0], jouts[0], "3x3 g", **FWD)
    for name, tv, jv in zip(("dw", "r1", "r2"), touts[1:], jouts[1:]):
        assert tuple(tv.shape) == tuple(jv.shape), name
        _close_scaled(tv, jv, "3x3 " + name)


@pytest.mark.parametrize("c", [12, 13])
def test_padded_copy_is_the_plain_version_exactly(c):
    """The padded route adds channels of exact zeros: its outputs equal
    the plain version at the count itself bit for bit (the products gain
    only exact-zero terms; the sums only zeros)."""
    m = int(np.prod(SHAPE))
    x, w = _t(_draw((m, c), 70 + c)), _t(_draw((c, c), 71 + c, 0.3))
    a, b = _t(_draw((c,), 72 + c, 0.2, 1.0)), _t(_draw((c,), 73 + c, 0.2))
    y, s = fb.conv1x1_bn_act(x, w, a, b)
    ry, rs = fb.conv1x1_bn_act_plain(x, w, a, b)
    assert torch.equal(y, ry)
    assert torch.equal(s[0], rs[0]) and torch.equal(s[1], rs[1])
    e = _t(_draw((m, c), 74 + c))
    got = fb.conv1x1_bn_act_bwd(e, w, x, prologue=(a, b))
    ref = fb.conv1x1_bn_act_bwd_plain(e, w, x, prologue=(a, b))
    assert torch.equal(got[0], ref[0]) and torch.equal(got[1], ref[1])
