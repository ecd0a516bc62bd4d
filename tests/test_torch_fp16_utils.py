"""The port's fp16_utils (`fp16util`, the legacy loss scalers,
`FP16_Optimizer`) against the JAX package's, on the CPU.

The same numpy-drawn params go through both: the conversion helpers'
dtypes and values leaf by leaf (batch-norm leaves by amp's name rule);
`FP16_Optimizer` over a FusedAdam with a static scale of 128, and with
dynamic scaling from the default 2^32 (clamped to 2^24 on both sides),
whose first steps overflow fp16 until the scale has backed off, then
with an inf injected into one gradient; the state converted from JAX
mid-run (`convert.optimizer_state_from_jax`) and stepped on. The
gradients given to both sides are the same fp16 arrays (the scaled
fp32 gradients rounded once, in numpy). fp32 masters and moments 1e-5
relative plus 1e-6; fp16 model params within one fp16 step (2^-10
relative) of JAX's; scaler states exactly (powers of two).
"""

import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rocm_apex_tpu import fp16_utils as jfp
from rocm_apex_tpu.optimizers import FusedAdam as JFusedAdam
from rocm_apex_tpu_torch import fp16_utils as tfp
from rocm_apex_tpu_torch.convert import (flatten_params,
                                         optimizer_state_from_jax)
from rocm_apex_tpu_torch.optimizers import FusedAdam

TOL = dict(rtol=1e-5, atol=1e-6)
HALF_TOL = dict(rtol=2.0 ** -10, atol=1e-6)
TREE = {"conv1": {"kernel": (3, 3, 2, 4)},
        "bn1": {"scale": (4,), "bias": (4,)},
        "block": {"bn2_mean": (4,), "dense": {"kernel": (4, 6)}},
        "fc": {"kernel": (6, 10), "bias": (10,)}}


def _draw(seed, scale=1.0):
    rng = np.random.default_rng(seed)

    def walk(t):
        return {k: walk(v) if isinstance(v, dict) else
                (scale * rng.standard_normal(v)).astype(np.float32)
                for k, v in t.items()}

    return walk(TREE)


def _jtree(tree):
    return jax.tree_util.tree_map(jnp.asarray, tree)


def _ttree(tree):
    return {k: torch.from_numpy(np.array(v)) for k, v in
            flatten_params(tree).items()}


def _flat_np(jtree):
    return flatten_params(jax.tree_util.tree_map(np.asarray, jtree))


def _np(x):
    return x.float().numpy() if torch.is_tensor(x) \
        else np.asarray(x).astype(np.float32)


def _same(got, jtree, tol=TOL, dtypes=True):
    want = _flat_np(jtree)
    assert set(got) == set(want)
    for k, w in want.items():
        if dtypes:
            assert str(got[k].dtype).replace("torch.", "") == \
                str(w.dtype), k
        np.testing.assert_allclose(_np(got[k]), w.astype(np.float32),
                                   err_msg=k, **tol)


def _with_int(tree):
    return {**tree, "steps": np.arange(3, dtype=np.int32)}


@pytest.mark.parametrize("fn", ["network_to_half", "convert_network"])
@pytest.mark.parametrize("dtype", ["float16", "bfloat16"])
def test_conversions_match_jax(fn, dtype):
    tree = _with_int(_draw(0))
    got = getattr(tfp, fn)(_ttree(tree), getattr(torch, dtype))
    want = getattr(jfp, fn)(_jtree(tree), getattr(jnp, dtype))
    _same(got, want, HALF_TOL)
    assert got["steps"].dtype == torch.int32
    kept = {k for k, v in got.items() if v.dtype == torch.float32}
    assert kept == (set() if fn == "network_to_half"
                    else {"bn1.scale", "bn1.bias", "block.bn2_mean"})


def test_bn_convert_float_and_copies_match_jax():
    tree = _draw(0)
    half_t = tfp.network_to_half(_ttree(tree))
    half_j = jfp.network_to_half(_jtree(tree))
    _same(tfp.BN_convert_float(half_t), jfp.BN_convert_float(half_j),
          HALF_TOL)
    model_t, master_t = tfp.prep_param_lists(half_t)
    model_j, master_j = jfp.prep_param_lists(half_j)
    _same(model_t, model_j, HALF_TOL)
    _same(master_t, master_j)
    assert all(master_t[k] is not half_t[k] for k in half_t)
    _same(tfp.model_grads_to_master_grads(half_t),
          jfp.model_grads_to_master_grads(half_j))
    new_master = _draw(1)
    _same(tfp.master_params_to_model_params(half_t, _ttree(new_master)),
          jfp.master_params_to_model_params(half_j, _jtree(new_master)),
          HALF_TOL)


def test_legacy_scalers_match_jax():
    for t, j in ((tfp.LossScaler(128.0), jfp.LossScaler(128.0)),
                 (tfp.DynamicLossScaler(), jfp.DynamicLossScaler()),
                 (tfp.DynamicLossScaler(2.0 ** 8, 4.0, 3),
                  jfp.DynamicLossScaler(2.0 ** 8, 4.0, 3))):
        ts, js = t.init(), j.init()
        assert float(ts.loss_scale) == float(js.loss_scale)
        for over in (False, True, False, False, False, True):
            ts = t.update_scale_legacy(ts, torch.tensor(over)) \
                if hasattr(t, "update_scale_legacy") \
                else t.update(ts, torch.tensor(over))[0]
            js = j.update_scale_legacy(js, jnp.asarray(over)) \
                if hasattr(j, "update_scale_legacy") \
                else j.update(js, jnp.asarray(over))[0]
            assert tuple(float(x) for x in ts) == \
                tuple(float(x) for x in js)
    assert float(tfp.DynamicLossScaler().init().loss_scale) == 2.0 ** 24
    grads = _draw(2)
    assert not bool(tfp.LossScaler.has_overflow(_ttree(grads)))
    grads["fc"]["bias"][0] = np.inf
    assert bool(tfp.DynamicLossScaler.has_overflow(_ttree(grads))) == \
        bool(jfp.DynamicLossScaler.has_overflow(_jtree(grads))) is True


def _half_grads(step, scale, inf=False):
    """The fp16 gradients of a loss scaled by ``scale``: fp32 gradients
    times the scale, rounded to fp16 once (inf where they overflow)."""
    g = _draw(100 + step, 0.1)
    if inf:
        g["fc"]["kernel"][1, 2] = np.inf
    with np.errstate(over="ignore"):
        return jax.tree_util.tree_map(
            lambda x: (x * np.float32(scale)).astype(np.float16), g)


OPT_CASES = {
    "static": (dict(static_loss_scale=128.0), 4, ()),
    "dynamic_default": (dict(dynamic_loss_scale=True), 10, ()),
    "dynamic_inf": (dict(dynamic_loss_scale=True, dynamic_loss_args=dict(
        init_scale=2.0 ** 10, scale_window=2)), 6, (2,)),
}


def _fp16_run(case, steps=None, resume_at=None):
    kw, n, infs = OPT_CASES[case]
    n = n if steps is None else steps
    params = jfp.network_to_half(_jtree(_draw(0)))
    jo = jfp.FP16_Optimizer(JFusedAdam(1e-2, weight_decay=0.01), **kw)
    to = tfp.FP16_Optimizer(FusedAdam(1e-2, weight_decay=0.01), **kw)
    js = jo.init(params)
    ts = to.init(tfp.network_to_half(_ttree(_draw(0))))
    skips = []
    for i in range(n):
        if i == resume_at:
            ts = optimizer_state_from_jax(js)
        scale = float(js.scaler_state.loss_scale)
        assert float(ts.scaler_state.loss_scale) == scale
        g = _half_grads(i, scale, inf=i in infs)
        over = int(js.scaler_state.overflows)
        js = jo.step(js, _jtree(g))
        ts = to.step(ts, _ttree(g))
        skips.append(int(js.scaler_state.overflows) - over)
    return js, ts, skips


def _same_state(ts, js):
    assert tuple(float(x) for x in ts.scaler_state) == \
        tuple(float(x) for x in js.scaler_state)
    _same(ts.model_params, js.model_params, HALF_TOL)
    _same(ts.master_params, js.master_params)
    assert int(ts.inner_state.count) == int(js.inner_state.count)
    _same(ts.inner_state.m, js.inner_state.m, dtypes=False)
    _same(ts.inner_state.v, js.inner_state.v,
          dict(rtol=1e-5, atol=1e-9), dtypes=False)


@pytest.mark.parametrize("case", list(OPT_CASES))
def test_fp16_optimizer_matches_jax(case):
    js, ts, skips = _fp16_run(case)
    _same_state(ts, js)
    if case == "static":
        assert skips == [0] * 4
    elif case == "dynamic_default":
        # 2^24 down to 2^17 before the scaled gradients fit in fp16
        assert skips == [1] * 7 + [0] * 3
        assert float(ts.scaler_state.loss_scale) == 2.0 ** 17
    else:
        assert skips == [0, 0, 1, 0, 0, 0]
        assert int(ts.inner_state.count) == 5


def test_fp16_optimizer_skip_is_bit_exact():
    """The overflowed step leaves masters and moments bit for bit."""
    to = tfp.FP16_Optimizer(FusedAdam(1e-2), dynamic_loss_scale=True,
                            dynamic_loss_args=dict(init_scale=2.0 ** 10))
    ts = to.init(tfp.network_to_half(_ttree(_draw(0))))
    ts = to.step(ts, _ttree(_half_grads(0, 2.0 ** 10)))
    after = to.step(ts, _ttree(_half_grads(1, 2.0 ** 10, inf=True)))
    for k in ts.master_params:
        assert torch.equal(after.master_params[k], ts.master_params[k])
        assert torch.equal(after.model_params[k], ts.model_params[k])
        assert torch.equal(after.inner_state.m[k], ts.inner_state.m[k])
    assert int(after.inner_state.count) == 1
    assert float(after.scaler_state.loss_scale) == 2.0 ** 9


@pytest.mark.parametrize("case", ["dynamic_default", "dynamic_inf"])
def test_fp16_optimizer_resumes_from_jax_state(case):
    """The port takes over from JAX's FP16OptimizerState mid-run (inside
    the overflow run-down for the default scale)."""
    js, ts, _ = _fp16_run(case, resume_at=3)
    _same_state(ts, js)


def test_fp16_optimizer_scale_loss_and_overflow_probe():
    to = tfp.FP16_Optimizer(FusedAdam(1e-2), static_loss_scale=64.0)
    jo = jfp.FP16_Optimizer(JFusedAdam(1e-2), static_loss_scale=64.0)
    ts = to.init(_ttree(_draw(0)))
    js = jo.init(_jtree(_draw(0)))
    loss = torch.tensor(1.5, dtype=torch.float16)
    assert float(to.scale_loss(loss, ts)) == \
        float(jo.scale_loss(jnp.float16(1.5), js)) == 96.0
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        g = _half_grads(0, 2.0 ** 24)
    assert bool(to.has_overflow(_ttree(g))) == \
        bool(jo.has_overflow(_jtree(g))) is True
