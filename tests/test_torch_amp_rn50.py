"""The port's amp frontend (`amp.frontend`, `amp.handle`,
`amp._process_optimizer`), `FusedAdam` and the ResNet-50 bench step
(`train.make_rn50_train_step`) against the JAX package, on the CPU.

Checked: the O0-O5 policies field for field; O5's leaf dtypes on a fused
ResNet's params against JAX's `tree_cast`; the function-casting levels
activated (fp32 params, the policy active, cleared by a later O5); `FusedAdam` (AdamW, L2, a decay mask) and `with_master_weights`
over three steps of numpy-drawn gradients; bench.py's `one_step` three
times at O0 in fp32 on a small fused ResNet (loss, params, running
statistics), the JAX fused blocks in interpret mode; one O5 step in bf16
(finite, the dtypes O5 gives). Both sides compute in fp32 and differ in
summation order: losses rtol 1e-5, optimizer steps on given gradients
rtol 1e-5 with atol 2e-6 (eps 1e-6), running statistics rtol 1e-5 (atol
1e-6); bf16 params one bf16 ulp of their fp32 masters. The bench step
runs bench.py's FusedAdam(1e-3, weight_decay=1e-4) with eps 1e-3
(`BENCH_EPS`): a BN makes its block's output invariant to a per-channel
shift of its input, so a bias ahead of one (the stem's ``bn1.bias``) has
a near-cancelling gradient whose fp32 noise Adam's g / (sqrt(v) + eps)
would blow up to a visible share of an lr step at eps 1e-6 (and the next
steps' statistics move with it); at 1e-3 that noise stays fp32 noise,
and the params, losses and statistics keep the tight tolerances.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from rocm_apex_tpu import amp as jamp
from rocm_apex_tpu.models import resnet as jr
from rocm_apex_tpu.optimizers import FusedAdam as JaxFusedAdam
from rocm_apex_tpu_torch import amp
from rocm_apex_tpu_torch.convert import flatten_params, resnet_from_jax_variables
from rocm_apex_tpu_torch.models import resnet as tr
from rocm_apex_tpu_torch.optimizers import FusedAdam
from rocm_apex_tpu_torch.train import make_rn50_train_step

DTYPES = {jnp.float32: torch.float32, jnp.float16: torch.float16,
          jnp.bfloat16: torch.bfloat16}
TOL = dict(rtol=1e-5, atol=2e-6)
BENCH_EPS = 1e-3


def _draw(shape, seed, scale=1.0):
    return (scale * np.random.default_rng(seed).standard_normal(shape)
            ).astype(np.float32)


def _tdtype(d):
    if d is None or d is False:
        return d
    return DTYPES[jnp.dtype(d).type]


@pytest.mark.parametrize("level", ["O0", "O1", "O2", "O3", "O4", "O5"])
def test_build_policy(level):
    j = jamp.build_policy(level)
    t = amp.build_policy(level)
    for k, v in j.options.items():
        got = t.options[k]
        if k in ("cast_model_dtype", "cast_functions_dtype"):
            assert got == _tdtype(v), k
        else:
            assert got == v, k
    assert t.compute_dtype == _tdtype(j.compute_dtype)
    assert t.param_dtype == _tdtype(j.param_dtype)


def test_policy_checks():
    with pytest.raises(amp.AmpError):
        amp.build_policy("O5", cast_functions=True)
    with pytest.raises(amp.AmpError):
        amp.build_policy("O2", cast_functions_dtype=torch.float16)
    with pytest.raises(amp.AmpError):
        amp.build_policy("0")
    assert amp.build_policy("O5", loss_scale="dynamic").loss_scale == \
        "dynamic"


def _fused_resnet(jax_side, **kw):
    cfg = dict(stage_sizes=(2, 1), num_filters=8, num_classes=10,
               fused=True, **kw)
    if jax_side:
        return jr.ResNet(block=jr.Bottleneck, dtype=jnp.float32, **cfg)
    return tr.ResNet(block=tr.Bottleneck, dtype=torch.float32,
                     device="cpu", **cfg)


def test_initialize_o5_dtypes():
    jm = _fused_resnet(True)
    vs = jm.init(jax.random.PRNGKey(0), jnp.zeros((1, 32, 32, 3)))
    jparams, _, _ = jamp.initialize(vs["params"], opt_level="O5",
                                    verbosity=0)
    ref = {k: _tdtype(v.dtype) for k, v in
           flatten_params(jax.tree_util.tree_map(np.asarray, jparams)).items()}
    tm = _fused_resnet(False)
    params, _, state = amp.initialize(dict(tm.named_parameters()),
                                      opt_level="O5")
    assert {k: v.dtype for k, v in params.items()} == ref
    assert any(v == torch.float32 for v in ref.values())
    assert float(state.loss_scale) == 1.0


@pytest.mark.parametrize("level", ["O1", "O4"])
def test_casting_levels_activate(level):
    try:
        params, _, state = amp.initialize({"w": torch.zeros(2)},
                                          opt_level=level, verbosity=0)
        assert params["w"].dtype == torch.float32
        assert amp.current_policy() is state.policy
        assert state.policy.cast_functions
        amp.initialize({"w": torch.zeros(2)}, opt_level="O5", verbosity=0)
        assert amp.current_policy() is None
    finally:
        amp.init(None)


def _leaves(seed):
    return {"a": _draw((4, 8), seed), "b": _draw((8,), seed + 1),
            "c": _draw((3, 3, 2, 4), seed + 2)}


@pytest.mark.parametrize("mode", ["adamw", "l2", "masked"])
def test_fused_adam(mode):
    kw = dict(weight_decay=0.1, eps=1e-6, adam_w_mode=mode != "l2")
    if mode == "masked":
        kw["weight_decay_mask"] = {"a": True, "b": False, "c": True}
    jopt, topt = JaxFusedAdam(1e-2, **kw), FusedAdam(1e-2, **kw)
    p0 = _leaves(0)
    jp = {k: jnp.asarray(v) for k, v in p0.items()}
    tp = {k: torch.from_numpy(v) for k, v in p0.items()}
    js, ts = jopt.init(jp), topt.init(tp)
    for i in range(3):
        g = _leaves(10 + 5 * i)
        jp, js = jopt.step(jp, {k: jnp.asarray(v) for k, v in g.items()}, js)
        tp, ts = topt.step(tp, {k: torch.from_numpy(v) for k, v in g.items()},
                           ts)
    for k in p0:
        np.testing.assert_allclose(tp[k].numpy(), np.asarray(jp[k]), **TOL,
                                   err_msg=k)
        np.testing.assert_allclose(ts.m[k].numpy(), np.asarray(js.m[k]),
                                   **TOL)
        np.testing.assert_allclose(ts.v[k].numpy(), np.asarray(js.v[k]),
                                   rtol=1e-5, atol=1e-9)
    assert int(ts.count) == int(js.count) == 3


def test_fused_adam_skip():
    """A skipped step leaves params and state as they were."""
    opt = FusedAdam(1e-2)
    p = {k: torch.from_numpy(v) for k, v in _leaves(0).items()}
    s = opt.init(p)
    g = {k: torch.from_numpy(v) for k, v in _leaves(3).items()}
    p2, s2 = opt.step(p, g, s, skip=torch.tensor(True))
    assert all(torch.equal(p2[k], p[k]) for k in p)
    assert int(s2.count) == 0


def test_amsgrad_refused():
    with pytest.raises(RuntimeError, match="AMSGrad"):
        FusedAdam(amsgrad=True)


def test_with_master_weights():
    p0 = _leaves(20)
    jtx = jamp.with_master_weights(JaxFusedAdam(1e-2, eps=1e-6).tx)
    ttx = amp.with_master_weights(FusedAdam(1e-2, eps=1e-6).tx)
    jp = {k: jnp.asarray(v).astype(jnp.bfloat16) for k, v in p0.items()}
    jp["b"] = jnp.asarray(p0["b"])  # an fp32 leaf beside the bf16 ones
    tp = {k: torch.from_numpy(v).to(torch.bfloat16) for k, v in p0.items()}
    tp["b"] = torch.from_numpy(p0["b"])
    js, ts = jtx.init(jp), ttx.init(tp)
    for i in range(3):
        g = _leaves(30 + 5 * i)
        ju, js = jtx.update({k: jnp.asarray(v).astype(jp[k].dtype)
                             for k, v in g.items()}, js, jp)
        jp = optax.apply_updates(jp, ju)
        tu, ts = ttx.update({k: torch.from_numpy(v).to(tp[k].dtype)
                             for k, v in g.items()}, ts, tp)
        tp = {k: (v + tu[k]).to(v.dtype) for k, v in tp.items()}
    for k in p0:
        master = ts.master[k].numpy()
        np.testing.assert_allclose(master, np.asarray(js.master[k]), **TOL)
        assert tp[k].dtype == (torch.float32 if k == "b" else torch.bfloat16)
        # each param is its master rounded (one bf16 ulp: 2^-8 relative)
        np.testing.assert_allclose(tp[k].float().numpy(), master,
                                   rtol=2.0 ** -8, atol=1e-6)
    got = list(amp.master_params(ts))
    assert len(got) == len(p0)
    assert all(any(g is m for m in ts.master.values()) for g in got)


def _bench_case(steps=3):
    """bench.py's one_step on the JAX side (O0, fp32), from one init."""
    jm = _fused_resnet(True)
    x = _draw((2, 32, 32, 3), 1)
    y = np.array([3, 7], np.int32)
    vs = jm.init(jax.random.PRNGKey(0), jnp.asarray(x))
    params0 = jax.tree_util.tree_map(
        lambda a: np.asarray(a) + (_draw(a.shape, 5, 0.1) if a.ndim == 1
                                   else 0), vs["params"])
    stats0 = jax.tree_util.tree_map(np.asarray, vs["batch_stats"])
    opt = JaxFusedAdam(1e-3, weight_decay=1e-4, eps=BENCH_EPS)
    params, opt, st = jamp.initialize(
        jax.tree_util.tree_map(jnp.asarray, params0), opt, opt_level="O0",
        verbosity=0)
    opt_state = opt.init(params)
    bstats = stats0
    losses = []
    for _ in range(steps):
        def loss_fn(p):
            logits, mut = jm.apply({"params": p, "batch_stats": bstats},
                                   jnp.asarray(x), mutable=["batch_stats"])
            ce = optax.softmax_cross_entropy_with_integer_labels(
                logits.astype(jnp.float32), jnp.asarray(y)).mean()
            return jamp.scale_loss(ce, st), (mut["batch_stats"], ce)

        (_, (bs2, ce)), grads = jax.value_and_grad(loss_fn, has_aux=True)(
            params)
        grads, found_inf = jamp.unscale_grads(grads, st)
        st, skip = jamp.update_scale(st, found_inf)
        updates, opt2 = opt.update(grads, opt_state, params)
        new_params = optax.apply_updates(params, updates)
        params = jamp.skip_step(skip, new_params, params)
        opt_state = jamp.skip_step(skip, opt2, opt_state)
        bstats = bs2
        losses.append(float(ce))
    return dict(x=x, y=y, params0=params0, stats0=stats0, losses=losses,
                params=params, stats=bstats)


def test_bench_step_o0():
    ref = _bench_case()
    tm = _fused_resnet(False)
    resnet_from_jax_variables(ref["params0"], ref["stats0"], tm)
    params, opt, st = amp.initialize(
        {k: v.detach() for k, v in tm.named_parameters()},
        FusedAdam(1e-3, weight_decay=1e-4, eps=BENCH_EPS), opt_level="O0")
    opt_state = opt.init(params)
    step = make_rn50_train_step(tm, opt, st)
    sstates = st.scaler_states
    x, y = torch.from_numpy(ref["x"]), torch.from_numpy(ref["y"]).long()
    losses = []
    for _ in range(len(ref["losses"])):
        params, opt_state, sstates, loss = step(params, opt_state, sstates,
                                                x, y)
        losses.append(float(loss))
    np.testing.assert_allclose(losses, ref["losses"], rtol=1e-5)
    probe = tr.ResNet(block=tr.Bottleneck, stage_sizes=(2, 1), num_filters=8,
                      num_classes=10, fused=True, device="cpu")
    resnet_from_jax_variables(
        jax.tree_util.tree_map(np.asarray, ref["params"]), ref["stats"],
        probe)
    want = dict(probe.named_parameters())
    for k, v in params.items():
        np.testing.assert_allclose(v.detach().numpy(),
                                   want[k].detach().numpy(), **TOL,
                                   err_msg=k)
    want_b = dict(probe.named_buffers())
    for k, v in tm.named_buffers():
        np.testing.assert_allclose(v.numpy(), want_b[k].numpy(), rtol=1e-5,
                                   atol=1e-6, err_msg=k)


def test_o5_step_bf16():
    tm = tr.ResNet(block=tr.Bottleneck, stage_sizes=(2, 1), num_filters=16,
                   num_classes=10, fused=True, dtype=torch.bfloat16,
                   device="cpu")
    params, opt, st = amp.initialize(
        {k: v.detach() for k, v in tm.named_parameters()},
        FusedAdam(1e-3, weight_decay=1e-4), opt_level="O5")
    opt_state = opt.init(params)
    step = make_rn50_train_step(tm, opt, st)
    x = torch.from_numpy(_draw((2, 32, 32, 3), 2))
    y = torch.tensor([1, 4])
    new, opt_state, sstates, loss = step(params, opt_state, st.scaler_states,
                                         x, y)
    assert torch.isfinite(loss) and loss.dtype == torch.float32
    for k, v in new.items():
        bn = amp._tree.is_batchnorm_path(k)
        assert v.dtype == (torch.float32 if bn else torch.bfloat16), k
        assert torch.isfinite(v.float()).all(), k
        assert opt_state.master[k].dtype == torch.float32
    assert any(not torch.equal(new[k], params[k]) for k in params)
    for k, b in tm.named_buffers():
        assert torch.isfinite(b).all(), k
