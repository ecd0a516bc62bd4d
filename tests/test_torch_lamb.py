"""The port's `MixedPrecisionLamb` and its per-leaf kernel pair against
the JAX package, on the CPU.

Both sides start from one carried-over state (masters, moments and a
step count drawn with numpy) on a small tree with two leaves that take
the kernel route on BOTH sides — a (128, 512) matrix and a (2, 256, 128)
stack, 65536 elements each with a last dim that is a multiple of 128 —
and three that take plain tensor math (a bias, a LayerNorm weight, a
matrix whose last dim is not lane-aligned). The JAX side runs its Pallas
pair in interpret mode, as its own tests do; the port runs the kernels'
plain PyTorch versions, which a wrapper takes for CPU tensors.

Tolerances: fp32 masters and moments 1e-5 relative (plus 1e-7 absolute
near zero): both sides compute in fp32 and differ in summation order of
the norms and in one reciprocal. bf16 moments one bf16 ulp (2^-7
relative): a value on a rounding boundary may round either way. Stage 2
recomputes ``u`` from the stored moments, so such a flip moves that
element's master by up to 2^-8 of its step (lr * ratio * u, ~1e-3 here):
with bf16 moments the masters get 1e-5 absolute on top (2.4e-6 seen).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch import nn

from rocm_apex_tpu.ops import optim_kernels as jok
from rocm_apex_tpu.optimizers.mixed import MixedPrecisionLamb as JaxLamb
from rocm_apex_tpu.optimizers.mixed import MixedPrecisionState as JaxState
from rocm_apex_tpu_torch.ops import optim_kernels as tok
from rocm_apex_tpu_torch.optimizers import MixedPrecisionLamb
from rocm_apex_tpu_torch.optimizers.mixed import takes_leaf_kernels

SHAPES = {
    "dense.kernel": (128, 512),
    "stack.kernel": (2, 256, 128),
    "dense.bias": (512,),
    "layernorm.weight": (128,),
    "odd.kernel": (300, 100),
}
MASK = {k: not (k.endswith("bias") or "layernorm" in k) for k in SHAPES}
FP32 = dict(rtol=1e-5, atol=1e-7)
# atol: a moment that cancels to near zero keeps the fp32 noise of its
# terms (~1e-3 * 2^-23), far above an ulp of the result
BF16 = dict(rtol=2.0 ** -7, atol=1e-9)
MASTER_TOL = {torch.float32: FP32, torch.bfloat16: dict(rtol=1e-5, atol=1e-5)}
JDT = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}
STEPS = 3


def _draw(seed, scale=1.0, positive=False):
    rng = np.random.default_rng(seed)
    out = {}
    for k, shape in SHAPES.items():
        x = rng.standard_normal(shape).astype(np.float32) * scale
        out[k] = np.abs(x) if positive else x
    return out


def _bf16_exact(a):
    """``a`` rounded to bf16, as float32 (so both sides store it exactly)."""
    return torch.tensor(a).to(torch.bfloat16).float().numpy()


def _states(moment_dtype, store_model, count=2, **kw):
    """The two optimizers and one carried-over state on each side."""
    params = _draw(1, 0.05)
    m0, v0 = _draw(2, 1e-3), _draw(3, 1e-6, positive=True)
    if moment_dtype == torch.bfloat16:
        m0 = {k: _bf16_exact(x) for k, x in m0.items()}
        v0 = {k: _bf16_exact(x) for k, x in v0.items()}
    kw = dict(weight_decay=0.01, weight_decay_mask=MASK, **kw)
    jopt = JaxLamb(1e-2, compute_dtype=jnp.float32,
                   moment_dtype=JDT[moment_dtype], store_model=store_model,
                   **kw)
    jstate = JaxState(
        count=jnp.asarray(count, jnp.int32),
        model=({k: jnp.asarray(x) for k, x in params.items()}
               if store_model else None),
        master={k: jnp.asarray(x) for k, x in params.items()},
        m={k: jnp.asarray(x, JDT[moment_dtype]) for k, x in m0.items()},
        v={k: jnp.asarray(x, JDT[moment_dtype]) for k, x in v0.items()},
    )
    opt = MixedPrecisionLamb(1e-2, compute_dtype=torch.float32,
                             moment_dtype=moment_dtype,
                             store_model=store_model, **kw)
    state = opt.init({k: torch.tensor(x) for k, x in params.items()})
    state = state._replace(
        count=torch.tensor(count, dtype=torch.int32),
        m={k: torch.tensor(x).to(moment_dtype) for k, x in m0.items()},
        v={k: torch.tensor(x).to(moment_dtype) for k, x in v0.items()},
    )
    return jopt, jstate, opt, state


def _assert_state_close(state, jstate, moment_dtype):
    mtol = FP32 if moment_dtype == torch.float32 else BF16
    assert int(state.count) == int(jstate.count)
    for k in SHAPES:
        np.testing.assert_allclose(state.master[k].numpy(),
                                   np.asarray(jstate.master[k]),
                                   **MASTER_TOL[moment_dtype],
                                   err_msg=f"master {k}")
        for name, mine, theirs in (("m", state.m, jstate.m),
                                   ("v", state.v, jstate.v)):
            assert mine[k].dtype == moment_dtype
            np.testing.assert_allclose(
                mine[k].float().numpy(),
                np.asarray(theirs[k].astype(jnp.float32)), **mtol,
                err_msg=f"{name} {k}")
        if jstate.model is None:
            assert state.model is None
        else:
            np.testing.assert_allclose(state.model[k].numpy(),
                                       np.asarray(jstate.model[k]),
                                       **MASTER_TOL[moment_dtype],
                                       err_msg=f"model {k}")


def _run(jopt, jstate, opt, state, steps=STEPS, grad_seed=10, grad_scale=None,
         grad_scale_np=1.0):
    for i in range(steps):
        g = _draw(grad_seed + i, grad_scale_np)
        jstate, jfound = jopt.step_and_probe(
            jstate, {k: jnp.asarray(x) for k, x in g.items()},
            grad_scale=grad_scale)
        state, found = opt.step_and_probe(
            state, {k: torch.tensor(x) for k, x in g.items()},
            grad_scale=grad_scale)
        assert bool(found) == bool(jfound)
    return jstate, state


def test_the_tree_has_both_routes():
    """The port routes leaves as the JAX class does (`_leaf_view`)."""
    took = {k: takes_leaf_kernels(torch.empty(s)) for k, s in SHAPES.items()}
    assert took == {"dense.kernel": True, "stack.kernel": True,
                    "dense.bias": False, "layernorm.weight": False,
                    "odd.kernel": False}
    assert not takes_leaf_kernels(torch.empty(()))
    assert not takes_leaf_kernels(torch.empty(1 << 10, 63))


@pytest.mark.parametrize("store_model", [True, False],
                         ids=["store_model", "no_model"])
@pytest.mark.parametrize("moment_dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32_moments", "bf16_moments"])
def test_three_steps_match_jax(moment_dtype, store_model, monkeypatch):
    """Masters, moments, count, found_inf and the compute copy after 3
    steps; the kernel route really took the two large leaves."""
    calls = {"stage1": [], "stage2": []}
    s1, s2 = tok.lamb_leaves_stage1, tok.lamb_leaves_stage2
    monkeypatch.setattr(tok, "lamb_leaves_stage1", lambda ps, *a, **k: (
        calls["stage1"].append(len(ps)), s1(ps, *a, **k))[1])
    monkeypatch.setattr(tok, "lamb_leaves_stage2", lambda ps, *a, **k: (
        calls["stage2"].append(len(ps)), s2(ps, *a, **k))[1])
    jopt, jstate, opt, state = _states(moment_dtype, store_model)
    jstate, state = _run(jopt, jstate, opt, state)
    # one call a stage and step, over both large leaves
    assert calls == {"stage1": [2] * STEPS, "stage2": [2] * STEPS}
    assert int(state.count) == 2 + STEPS
    _assert_state_close(state, jstate, moment_dtype)
    if not store_model:
        got = opt.model_params(state)
        for k, x in jopt.model_params(jstate).items():
            np.testing.assert_allclose(got[k].numpy(), np.asarray(x),
                                       **MASTER_TOL[moment_dtype])


@pytest.mark.parametrize("kw,run_kw", [
    (dict(use_nvlamb=True), {}),
    (dict(max_grad_norm=0.0), {}),
    (dict(max_grad_norm=1.0), dict(grad_scale_np=50.0)),  # the clip is active
    (dict(max_grad_norm=1e9), {}),  # the clip is not
    (dict(), dict(grad_scale=2.0 ** -7, grad_scale_np=128.0)),
    (dict(adam_w_mode=False), {}),
    (dict(grad_averaging=False), {}),
    (dict(bias_correction=False), {}),
    (dict(betas=(0.8, 0.95), eps=1e-5), {}),
], ids=["nvlamb", "no_clip", "clip_active", "clip_idle", "grad_scale",
        "l2_mode", "no_grad_averaging", "no_bias_correction", "betas_eps"])
def test_options_match_jax(kw, run_kw):
    jopt, jstate, opt, state = _states(torch.float32, True, **kw)
    jstate, state = _run(jopt, jstate, opt, state, steps=2, **run_kw)
    _assert_state_close(state, jstate, torch.float32)


@pytest.mark.parametrize("where", ["dense.kernel", "dense.bias"],
                         ids=["inf_in_a_kernel_leaf", "inf_in_a_tree_leaf"])
@pytest.mark.parametrize("moment_dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32_moments", "bf16_moments"])
def test_an_injected_inf_freezes_the_state_bit_for_bit(moment_dtype, where):
    """One gradient element inf: found_inf, and masters, moments, the
    compute copy and the count stay bit-identical, on both sides."""
    jopt, jstate, opt, state = _states(moment_dtype, True)
    before = {name: {k: x.clone() for k, x in d.items()}
              for name, d in (("master", state.master), ("m", state.m),
                              ("v", state.v), ("model", state.model))}
    g = _draw(10)
    g[where].reshape(-1)[5] = np.inf
    state, found = opt.step_and_probe(
        state, {k: torch.tensor(x) for k, x in g.items()})
    jstate2, jfound = jopt.step_and_probe(
        jstate, {k: jnp.asarray(x) for k, x in g.items()})
    assert bool(found) and bool(jfound)
    assert int(state.count) == 2 == int(jstate2.count)
    for name, d in before.items():
        for k, x in d.items():
            assert torch.equal(getattr(state, name)[k], x), (name, k)
    for k in SHAPES:
        np.testing.assert_array_equal(np.asarray(jstate2.master[k]),
                                      np.asarray(jstate.master[k]))
    # and the next clean step moves on from the frozen state as JAX does
    jstate2, state = _run(jopt, jstate2, opt, state, steps=1)
    _assert_state_close(state, jstate2, moment_dtype)


def test_a_missing_gradient_is_a_zero_gradient():
    jopt, jstate, opt, state = _states(torch.float32, True)
    g = _draw(10)
    jg = {k: jnp.asarray(x) for k, x in g.items()}
    jg["dense.kernel"] = jnp.zeros_like(jg["dense.kernel"])
    jg["dense.bias"] = jnp.zeros_like(jg["dense.bias"])
    tg = {k: torch.tensor(x) for k, x in g.items()}
    tg["dense.kernel"] = None
    del tg["dense.bias"]
    jstate, _ = jopt.step_and_probe(jstate, jg)
    state, _ = opt.step_and_probe(state, tg)
    _assert_state_close(state, jstate, torch.float32)


class _Tree(nn.Module):
    def __init__(self):
        super().__init__()
        for k, s in SHAPES.items():
            self.register_parameter(k.replace(".", "_"),
                                    nn.Parameter(torch.zeros(s)))


@pytest.mark.parametrize("store_model", [True, False])
def test_the_module_is_the_compute_copy(store_model):
    """With a module, its parameters hold the masters in the compute
    dtype: written by stage 2 when the copy is stored, by `model_params`
    when it is not."""
    model = _Tree()
    params = {k.replace(".", "_"): torch.tensor(x)
              for k, x in _draw(1, 0.05).items()}
    opt = MixedPrecisionLamb(1e-2, compute_dtype=torch.bfloat16,
                             store_model=store_model)
    state = opt.init(params, model)
    named = dict(model.named_parameters())
    assert (state.model is None) == (not store_model)
    for k, p in params.items():
        assert named[k].dtype == torch.bfloat16
        assert torch.equal(named[k].detach(), p.to(torch.bfloat16))
    grads = {k: torch.tensor(x).to(torch.bfloat16)
             for k, x in zip(params, _draw(10).values())}
    state, _ = opt.step_and_probe(state, grads)
    got = opt.model_params(state, model)
    for k in params:
        assert got[k] is named[k]
        assert torch.equal(named[k].detach(),
                           state.master[k].to(torch.bfloat16)), k
        assert not torch.equal(state.master[k], params[k])


# ---------------------------------------------------------------------------
# the kernel pair's plain versions against the Pallas pair
# ---------------------------------------------------------------------------


def _leaf(moment_dtype, seed=4):
    rng = np.random.default_rng(seed)
    p = rng.standard_normal((128, 512)).astype(np.float32) * 0.05
    g = rng.standard_normal((128, 512)).astype(np.float32)
    m = rng.standard_normal((128, 512)).astype(np.float32) * 1e-3
    v = np.abs(rng.standard_normal((128, 512))).astype(np.float32) * 1e-6
    if moment_dtype == torch.bfloat16:
        m, v = _bf16_exact(m), _bf16_exact(v)
    return p, g, m, v


SCALARS = [0.9, 0.999, 0.1, 1e-6, 0.271, 0.003, 0.7, 1.0]


@pytest.mark.parametrize("wd,adam_w_mode", [(0.01, True), (0.01, False),
                                            (0.0, True)],
                         ids=["adamw", "l2", "no_decay"])
@pytest.mark.parametrize("moment_dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32_moments", "bf16_moments"])
def test_stage_pair_matches_the_pallas_pair(moment_dtype, wd, adam_w_mode):
    """Stage 1: m2, v2 in the moment dtype and the two sums (``sum u^2``
    from the moments BEFORE rounding); stage 2 from the stored moments:
    the master and the compute copy."""
    p, g, m, v = _leaf(moment_dtype)
    jdt = JDT[moment_dtype]
    jm, jv, jpsq, jusq = jok.lamb_leaf_stage1(
        jnp.asarray(p), jnp.asarray(g), jnp.asarray(m, jdt),
        jnp.asarray(v, jdt), SCALARS, wd, adam_w_mode)
    tp = torch.tensor(p)
    tm, tv = torch.tensor(m).to(moment_dtype), torch.tensor(v).to(moment_dtype)
    psq, usq = tok.lamb_leaf_stage1(tp, torch.tensor(g), tm, tv,
                                    torch.tensor(SCALARS), wd, adam_w_mode)
    mtol = FP32 if moment_dtype == torch.float32 else BF16
    np.testing.assert_allclose(tm.float().numpy(),
                               np.asarray(jm.astype(jnp.float32)), **mtol)
    np.testing.assert_allclose(tv.float().numpy(),
                               np.asarray(jv.astype(jnp.float32)), **mtol)
    np.testing.assert_allclose(float(psq), float(jpsq), rtol=1e-5)
    np.testing.assert_allclose(float(usq), float(jusq), rtol=1e-5)
    # stage 2 from the JAX side's stored moments, so only stage 2 differs
    sb = [SCALARS[3], SCALARS[4], SCALARS[5], 3e-3, 1.0]
    jp2, jc2 = jok.lamb_leaf_stage2(jnp.asarray(p), jm, jv, sb, wd,
                                    adam_w_mode, jnp.bfloat16)
    sm = torch.tensor(np.asarray(jm.astype(jnp.float32))).to(moment_dtype)
    sv = torch.tensor(np.asarray(jv.astype(jnp.float32))).to(moment_dtype)
    c = torch.empty(p.shape, dtype=torch.bfloat16)
    tok.lamb_leaf_stage2(tp, sm, sv, torch.tensor(sb[:3] + sb[4:]),
                         torch.tensor([sb[3]]), wd, adam_w_mode, model_out=c)
    np.testing.assert_allclose(tp.numpy(), np.asarray(jp2), **FP32)
    np.testing.assert_allclose(c.float().numpy(),
                               np.asarray(jc2.astype(jnp.float32)), **BF16)
    assert torch.equal(c, tp.to(torch.bfloat16))


def test_usq_comes_from_the_moments_before_rounding():
    """bf16 moments that all round the same way (m = v = 1, g = 0: m2 =
    0.9 stores as 0.8984, v2 = 0.999 as 1.0): ``sum u^2`` is the JAX
    kernel's, from the fp32 m2/v2, and not what the stored moments give;
    stage 2 then applies the direction of the STORED ones."""
    shape = (128, 512)
    p = torch.full(shape, 0.05)
    tm = torch.ones(shape, dtype=torch.bfloat16)
    tv = torch.ones(shape, dtype=torch.bfloat16)
    jm, jv, _, jusq = jok.lamb_leaf_stage1(
        jnp.full(shape, 0.05, jnp.float32), jnp.zeros(shape, jnp.float32),
        jnp.ones(shape, jnp.bfloat16), jnp.ones(shape, jnp.bfloat16),
        SCALARS, 0.0, True)
    s = torch.tensor(SCALARS)
    _, usq = tok.lamb_leaf_stage1(p, torch.zeros(shape), tm, tv, s, 0.0, True)
    np.testing.assert_allclose(float(usq), float(jusq), rtol=1e-5)
    assert torch.equal(tm.float(), torch.tensor(
        np.asarray(jm.astype(jnp.float32))))
    assert float(tm[0, 0]) == 0.8984375 and float(tv[0, 0]) == 1.0
    stored = tok._u(tm.float(), tv.float(), p, s[3], s[4], s[5], 0.0, True)
    assert abs(float((stored * stored).sum()) / float(usq) - 1.0) > 1e-3
    p0 = p.clone()
    tok.lamb_leaf_stage2(p, tm, tv, s[[3, 4, 5, 7]], torch.tensor([1e-3]),
                         0.0, True)
    np.testing.assert_allclose((p0 - p).numpy(), (1e-3 * stored).numpy(),
                               rtol=1e-5)


@pytest.mark.parametrize("moment_dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32_moments", "bf16_moments"])
def test_live_zero_freezes_both_stages(moment_dtype):
    """``live <= 0``: m, v and the master stay bit-equal even when the
    provisional values are inf (a select, not a blend); the sums are
    still written."""
    p, g, m, v = _leaf(moment_dtype)
    g[0, 0] = np.inf
    tp = torch.tensor(p)
    tm, tv = torch.tensor(m).to(moment_dtype), torch.tensor(v).to(moment_dtype)
    keep = [x.clone() for x in (tp, tm, tv)]
    dead = torch.tensor(SCALARS[:7] + [0.0])
    psq, _ = tok.lamb_leaf_stage1(tp, torch.tensor(g), tm, tv, dead, 0.01,
                                  True)
    tok.lamb_leaf_stage2(tp, tm, tv, torch.tensor([1e-6, 0.271, 0.003, 0.0]),
                         torch.tensor([float("nan")]), 0.01, True)
    for got, want in zip((tp, tm, tv), keep):
        assert torch.equal(got, want)
    np.testing.assert_allclose(float(psq), float((keep[0] ** 2).sum()),
                               rtol=1e-6)


@pytest.mark.parametrize("bad,match", [
    (dict(p=torch.zeros(4, 4, dtype=torch.bfloat16)), "float32"),
    (dict(scalars=torch.zeros(5)), "scalars"),
    (dict(g=torch.zeros(4, 5)), "shape"),
    (dict(v=torch.zeros(4, 4, dtype=torch.bfloat16)), "share a dtype"),
    (dict(out=torch.zeros(3)), "out must be"),
    (dict(p=torch.zeros(4, 8)[:, ::2]), "contiguous"),
])
def test_stage1_refuses_what_the_kernel_does_not_take(bad, match):
    args = dict(p=torch.zeros(4, 4), g=torch.zeros(4, 4),
                m=torch.zeros(4, 4), v=torch.zeros(4, 4),
                scalars=torch.zeros(8), wd=0.0, adam_w_mode=True, out=None)
    args.update(bad)
    with pytest.raises((TypeError, ValueError), match=match):
        tok.lamb_leaf_stage1(**args)


def test_the_multi_leaf_calls_are_the_per_leaf_calls():
    """`lamb_leaves_stage1` / `lamb_leaves_stage2` over a list of leaves
    give each leaf what the per-leaf wrappers give it, with a trust ratio
    per leaf."""
    shapes = [(128, 512), (40, 7), (3,)]
    rng = np.random.default_rng(5)
    mk = lambda scale, pos=False: [torch.tensor(  # noqa: E731
        (np.abs if pos else np.asarray)(
            rng.standard_normal(s).astype(np.float32) * scale))
        for s in shapes]
    ps, gs, ms, vs = mk(0.05), mk(1.0), mk(1e-3), mk(1e-6, True)
    wds = [0.01, 0.0, 0.02]
    s1 = torch.tensor(SCALARS)
    s2 = s1[[3, 4, 5, 7]].contiguous()
    ratios = torch.tensor([1e-3, 2e-3, 3e-3])
    one = [[t.clone() for t in ts] for ts in (ps, ms, vs)]
    sums = tok.lamb_leaves_stage1(ps, gs, ms, vs, s1, wds, True)
    tok.lamb_leaves_stage2(ps, ms, vs, s2, ratios, wds, True)
    assert sums.shape == (3, 2)
    for i in range(3):
        p, m, v = (ts[i] for ts in one)
        psq, usq = tok.lamb_leaf_stage1(p, gs[i], m, v, s1, wds[i], True)
        tok.lamb_leaf_stage2(p, m, v, s2, ratios[i:i + 1], wds[i], True)
        assert torch.equal(sums[i], torch.stack([psq, usq]))
        assert torch.equal(p, ps[i]) and torch.equal(m, ms[i])
        assert torch.equal(v, vs[i])
    with pytest.raises(ValueError, match="lr_ratios"):
        tok.lamb_leaves_stage2(ps, ms, vs, s2, ratios[:2], wds, True)
    with pytest.raises(ValueError, match="every leaf"):
        tok.lamb_leaves_stage1(ps, gs[:2], ms, vs, s1, wds, True)
