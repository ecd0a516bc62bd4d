"""The port's tree-form optimizers against the JAX package, on the CPU.

`FusedSGD`, `FusedAdagrad`, `FusedNovoGrad`, `FusedLAMB` (tree and
packed), `FusedMixedPrecisionLamb` and the contrib `FusedAdam`: three
steps of each option set on the same numpy-drawn params and gradients,
params and every state leaf compared; the packed LAMB against the tree
one; a step resumed from `convert.optimizer_state_from_jax` at step 0
(the first-step branches of SGD's momentum and NovoGrad's norm) and at
step 3. Both sides compute in fp32 and differ in summation order (the
norms) and in XLA's regrouping of a quotient: fp32 values 1e-5 relative
plus 1e-6 absolute (the NovoGrad norms and LAMB's trust ratios carry
~1e-7 of reduction noise into every step); a bf16 param within one bf16
step (2^-7 relative) of JAX's; a skipped step bit for bit.
"""

import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rocm_apex_tpu import optimizers as jopt
from rocm_apex_tpu.contrib.optimizers.fused_adam import FusedAdam as JContribAdam
from rocm_apex_tpu.optimizers._common import FusedOptimizer as JFusedOptimizer
from rocm_apex_tpu_torch import optimizers as topt
from rocm_apex_tpu_torch.contrib.optimizers import FusedAdam as TContribAdam
from rocm_apex_tpu_torch.convert import optimizer_state_from_jax
from rocm_apex_tpu_torch.ops.packing import (PackedTree, build_pack_spec,
                                             respec, unpack_tree)

TOL = dict(rtol=1e-5, atol=1e-6)
BF16_TOL = dict(rtol=2.0 ** -7, atol=1e-6)
SHAPES = {"dense.kernel": (16, 24), "dense.bias": (24,),
          "layernorm.scale": (24,), "conv.kernel": (3, 3, 2, 4),
          "embed": (40, 8)}
MASK = {k: not (k.endswith("bias") or "layernorm" in k) for k in SHAPES}


def _draw(seed, scale=1.0):
    rng = np.random.default_rng(seed)
    return {k: (scale * rng.standard_normal(s)).astype(np.float32)
            for k, s in SHAPES.items()}


def _grads(step):
    g = _draw(100 + step, 0.1)
    g["dense.bias"][3] = 0.0  # an exact zero among the gradients
    return g


def _np(x):
    return x.float().numpy() if torch.is_tensor(x) \
        else np.asarray(x).astype(np.float32)


def _j(tree, dtype=None):
    return {k: jnp.asarray(v, dtype=(dtype or {}).get(k)) for k, v in
            tree.items()}


def _t(tree, dtype=None):
    return {k: torch.from_numpy(v.copy()).to((dtype or {}).get(k,
                                                               torch.float32))
            for k, v in tree.items()}


def _close(got, want, what, tol=TOL):
    if isinstance(want, dict):
        assert set(got) == set(want), what
        for k in want:
            _close(got[k], want[k], f"{what}[{k}]", tol)
        return
    np.testing.assert_allclose(_np(got), _np(want), err_msg=what, **tol)


def _close_state(ts, js, tol=TOL):
    assert type(ts).__name__ == type(js).__name__
    for f in js._fields:
        if f == "count":
            assert int(getattr(ts, f)) == int(getattr(js, f))
        else:
            _close(getattr(ts, f), getattr(js, f), f, tol)


def _steps(jo, to, n=3, p0=None, jstep=None, tstep=None):
    """``n`` steps of the JAX and the port optimizer from the same params;
    returns both (params, state)."""
    p0 = _draw(0) if p0 is None else p0
    jp, tp = _j(p0), _t(p0)
    js, ts = jo.init(jp), to.init(tp)
    for i in range(n):
        g = _grads(i)
        jp, js = (jstep or jo.step)(jp, _j(g), js)
        tp, ts = (tstep or to.step)(tp, _t(g), ts)
    return (jp, js), (tp, ts)


def _check(jo, to, **kw):
    (jp, js), (tp, ts) = _steps(jo, to, **kw)
    _close(tp, jp, "params")
    _close_state(ts, js)


SGD_CASES = {
    "plain": dict(),
    "momentum_dampening": dict(momentum=0.9, dampening=0.1),
    "nesterov": dict(momentum=0.9, nesterov=True),
    "wd": dict(momentum=0.9, weight_decay=0.1),
    "wd_after_momentum": dict(momentum=0.9, weight_decay=0.1,
                              wd_after_momentum=True),
    "wd_no_momentum": dict(weight_decay=0.1),
    "masked": dict(momentum=0.9, weight_decay=0.1, weight_decay_mask=MASK),
}


@pytest.mark.parametrize("case", list(SGD_CASES))
def test_fused_sgd(case):
    kw = SGD_CASES[case]
    _check(jopt.FusedSGD(0.1, **kw), topt.FusedSGD(0.1, **kw))


def test_fused_sgd_refuses_nesterov_without_momentum():
    with pytest.raises(ValueError, match="Nesterov"):
        topt.FusedSGD(0.1, nesterov=True)
    with pytest.raises(ValueError, match="Nesterov"):
        topt.FusedSGD(0.1, momentum=0.9, dampening=0.1, nesterov=True)


def test_fused_sgd_grad_scale_and_schedule():
    """``grad_scale`` (a device scalar) and a schedule of the count."""
    def sched(count):
        return 0.1 / count

    kw = dict(momentum=0.9, weight_decay=0.01)
    jt = jopt.fused_sgd(sched, grad_scale=jnp.float32(0.5), **kw)
    tt = topt.fused_sgd(sched, grad_scale=torch.tensor(0.5), **kw)
    _check(JFusedOptimizer(jt), topt.FusedOptimizer(tt))


ADAGRAD_CASES = {
    "l2": dict(weight_decay=0.1),
    "w_mode": dict(weight_decay=0.1, adagrad_w_mode=True),
    "masked": dict(weight_decay=0.1, weight_decay_mask=MASK),
    "no_decay": dict(eps=1e-6),
}


@pytest.mark.parametrize("case", list(ADAGRAD_CASES))
def test_fused_adagrad(case):
    kw = ADAGRAD_CASES[case]
    _check(jopt.FusedAdagrad(0.05, **kw), topt.FusedAdagrad(0.05, **kw))


NOVOGRAD_CASES = {
    f"norm{n}_{'inside' if r else 'decoupled'}": dict(
        norm_type=n, reg_inside_moment=r, weight_decay=0.1)
    for n in (2, 0) for r in (True, False)
}
NOVOGRAD_CASES.update(
    init_zero=dict(init_zero=True, weight_decay=0.1),
    no_bias_correction=dict(bias_correction=False),
    no_grad_averaging=dict(grad_averaging=False, weight_decay=0.1),
    masked=dict(weight_decay=0.1, weight_decay_mask=MASK),
)


@pytest.mark.parametrize("case", list(NOVOGRAD_CASES))
def test_fused_novograd(case):
    kw = NOVOGRAD_CASES[case]
    _check(jopt.FusedNovoGrad(0.01, **kw), topt.FusedNovoGrad(0.01, **kw))


def test_fused_novograd_refusals():
    with pytest.raises(RuntimeError, match="norm"):
        topt.FusedNovoGrad(norm_type=1)
    with pytest.raises(RuntimeError, match="AMSGrad"):
        topt.FusedNovoGrad(amsgrad=True)


LAMB_CASES = {
    "adamw": dict(weight_decay=0.01),
    "l2": dict(weight_decay=0.01, adam_w_mode=False),
    "masked": dict(weight_decay=0.01, weight_decay_mask=MASK),
    "nvlamb_masked": dict(weight_decay=0.01, weight_decay_mask=MASK,
                          use_nvlamb=True),
    "no_clip": dict(max_grad_norm=0.0),
    "clip_tight": dict(max_grad_norm=0.1, grad_averaging=False),
    "no_decay": dict(weight_decay=0.0, bias_correction=False),
}


@pytest.mark.parametrize("case", list(LAMB_CASES))
def test_fused_lamb(case):
    kw = LAMB_CASES[case]
    _check(jopt.FusedLAMB(0.01, **kw), topt.FusedLAMB(0.01, **kw))


@pytest.mark.parametrize("case", ["adamw", "masked", "l2", "clip_tight"])
def test_fused_lamb_packed_matches_tree(case):
    """`FusedLAMB(packed=True)` (the packed buffers and the LAMB stage
    pair) against the tree form and against JAX's packed form: params,
    and the packed moments unpacked by name."""
    kw = LAMB_CASES[case]
    (_, _), (tp, ts) = _steps(jopt.FusedLAMB(0.01, **kw),
                              topt.FusedLAMB(0.01, **kw))
    jo = JFusedOptimizer(jopt.fused_lamb(0.01, packed=True, **kw))
    (jp, js), (pp, ps) = _steps(jo, topt.FusedLAMB(0.01, packed=True, **kw))
    _close(pp, tp, "packed vs tree params")
    _close(pp, jp, "packed vs JAX packed params")
    assert isinstance(ps, topt.PackedLAMBState) and int(ps.count) == 3
    f32 = respec(build_pack_spec(_t(_draw(0))), torch.float32)
    for name in ("m", "v"):
        _close(unpack_tree(PackedTree(getattr(ps, name), f32)),
               getattr(ts, name), f"packed vs tree {name}")


def test_fused_lamb_refuses_amsgrad():
    with pytest.raises(RuntimeError, match="AMSGrad"):
        topt.FusedLAMB(amsgrad=True)


MP_DTYPES = {"dense.kernel": torch.bfloat16, "conv.kernel": torch.bfloat16,
             "embed": torch.bfloat16}


def test_mixed_precision_lamb_inv_scale_and_found_inf():
    """Mixed fp32/bf16 params, gradients carrying a loss scale of 1024
    and ``inv_scale``; step 2 with ``found_inf``: params, moments and
    count bit for bit as they were, on both sides."""
    jdt = {k: jnp.bfloat16 for k in MP_DTYPES}
    kw = dict(weight_decay=0.01, weight_decay_mask=MASK)
    jo, to = jopt.FusedMixedPrecisionLamb(0.01, **kw), \
        topt.FusedMixedPrecisionLamb(0.01, **kw)
    p0 = _draw(0)
    jp, tp = _j(p0, jdt), _t(p0, MP_DTYPES)
    js, ts = jo.init(jp), to.init(tp)
    for i in range(4):
        g = {k: v * 1024.0 for k, v in _grads(i).items()}
        skip = i == 2
        before = (tp, ts)
        jp, js = jo.step(jp, _j(g, jdt), js, inv_scale=1.0 / 1024,
                         found_inf=jnp.asarray(skip))
        tp, ts = to.step(tp, _t(g, MP_DTYPES), ts, inv_scale=1.0 / 1024,
                         found_inf=torch.tensor(skip))
        if skip:
            for k in SHAPES:
                assert torch.equal(tp[k], before[0][k])
                assert torch.equal(ts.m[k], before[1].m[k])
                assert torch.equal(ts.v[k], before[1].v[k])
            assert int(ts.count) == int(before[1].count) == 2
    assert int(ts.count) == int(js.count) == 3
    for k in SHAPES:
        assert tp[k].dtype == MP_DTYPES.get(k, torch.float32)
        _close(tp[k], jp[k], k,
               BF16_TOL if k in MP_DTYPES else TOL)
    _close_state(ts, js)


def test_contrib_fused_adam_warns_and_scales():
    with pytest.warns(DeprecationWarning, match="deprecated"):
        to = TContribAdam(1e-2, weight_decay=0.01)
    with pytest.raises(NotImplementedError):
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            TContribAdam(eps_inside_sqrt=True)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        jo = JContribAdam(1e-2, weight_decay=0.01)

    def jstep(p, g, s):
        return jo.step_with_scale(p, {k: v * 128.0 for k, v in g.items()},
                                  s, scale=128.0)

    def tstep(p, g, s):
        return to.step_with_scale(p, {k: v * 128.0 for k, v in g.items()},
                                  s, scale=128.0)

    (jp, js), (tp, ts) = _steps(jo, to, jstep=jstep, tstep=tstep)
    _close(tp, jp, "params")
    _close_state(ts, js)
    # an explicit skip leaves params and state as they were
    tp2, ts2 = to.step_with_scale(tp, _t(_grads(5)), ts, scale=2.0,
                                  skip=torch.tensor(True))
    assert all(torch.equal(tp2[k], tp[k]) for k in SHAPES)
    assert int(ts2.count) == int(ts.count)


def test_cpu_norm_holds_to_fp64():
    """`_common.foreach_norm_f32` on the CPU over the 3.1e7 values of
    BERT's word embedding: within 1e-6 of the fp64 norm (torch's CPU
    vector norm is ~2e-3 off there, which is why the CPU branch exists)."""
    from rocm_apex_tpu_torch.optimizers._common import foreach_norm_f32

    x = 1e-2 * np.random.default_rng(0).standard_normal((30592, 1024),
                                                         dtype=np.float32)
    want = np.sqrt(np.sum(np.square(x.astype(np.float64))))
    (got,) = foreach_norm_f32([torch.from_numpy(x)])
    assert got.dtype == torch.float32
    assert abs(float(got) - want) <= 1e-6 * want


def test_exports_match_jax():
    import rocm_apex_tpu.optimizers as j

    assert set(j.__all__) <= set(topt.__all__)


RESUME = {
    "sgd_momentum": (jopt.FusedSGD, dict(lr=0.1, momentum=0.9,
                                         dampening=0.1, weight_decay=0.01)),
    "sgd_nesterov": (jopt.FusedSGD, dict(lr=0.1, momentum=0.9,
                                         nesterov=True)),
    "adagrad": (jopt.FusedAdagrad, dict(lr=0.05, weight_decay=0.01)),
    "novograd": (jopt.FusedNovoGrad, dict(lr=0.01, weight_decay=0.01)),
    "novograd_inf": (jopt.FusedNovoGrad, dict(lr=0.01, norm_type=0,
                                              reg_inside_moment=True)),
    "lamb": (jopt.FusedLAMB, dict(lr=0.01, weight_decay_mask=MASK)),
    "adam": (jopt.FusedAdam, dict(lr=0.01, weight_decay=0.01)),
}


@pytest.mark.parametrize("start", [0, 3])
@pytest.mark.parametrize("case", list(RESUME))
def test_resume_from_jax_state(case, start):
    """JAX runs ``start`` steps; its state goes through
    `optimizer_state_from_jax`; both then take two more steps. Start 0
    resumes from the JAX init state, so the port's first step (SGD's
    buf = d, NovoGrad's v = ||g||) runs on a converted count."""
    jcls, kw = RESUME[case]
    tcls = getattr(topt, jcls.__name__)
    jo, to = jcls(**kw), tcls(**kw)
    jp = _j(_draw(0))
    js = jo.init(jp)
    for i in range(start):
        jp, js = jo.step(jp, _j(_grads(i)), js)
    ts = optimizer_state_from_jax(js)
    _close_state(ts, js)
    tp = {k: torch.from_numpy(np.array(v)) for k, v in jp.items()}
    for i in range(start, start + 2):
        jp, js = jo.step(jp, _j(_grads(i)), js)
        tp, ts = to.step(tp, _t(_grads(i)), ts)
    _close(tp, jp, "params")
    _close_state(ts, js)


def test_resume_refuses_an_unknown_state():
    from collections import namedtuple

    with pytest.raises(TypeError, match="no port state"):
        optimizer_state_from_jax(namedtuple("OtherState", "count")(0))
