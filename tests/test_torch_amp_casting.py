"""The port's O1/O4 function casting (`amp/amp.py`, `amp/lists/`) against
the JAX package's, on the CPU.

Checked: every decorator's output dtypes on the same nested arguments
(an fp32, a bf16 and an fp16 tensor at depth, an int tensor, a float
scalar) under no policy, O1, O4, a `disable_casts()` scope and after
re-initializing at O5, equal to JAX's; the registry on a namespace
object; `promote_function` over mixed dtypes (bf16 with fp16 gives fp32
on both sides); the cast lists and `is_*_op` equal to JAX's; and the
gradients of a `policy_function`-wrapped 2-layer GPT loss under O4 (fp32
params, bf16 compute) against `jax.grad` of the same wrapped JAX loss:
fp32 on both sides, each leaf within 3e-2 of its largest JAX element
(1.6e-2 seen: the two bf16 stacks round their products in different
places, and JAX's own fp32 run is as far from its bf16 one), the loss
within 1e-3 relative (5e-5 seen). Every test starts and ends with both packages'
active policy cleared, so no O1/O4 policy leaks into a later test file.
"""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rocm_apex_tpu import amp as jamp
from rocm_apex_tpu.amp.amp import init as jax_amp_init
from rocm_apex_tpu.amp.lists import functional_overrides as jfo
from rocm_apex_tpu.amp.lists import jnp_overrides as jlists
from rocm_apex_tpu.models.gpt import GPTConfig as JaxGPTConfig
from rocm_apex_tpu.models.gpt import GPTModel as JaxGPTModel
from rocm_apex_tpu_torch import amp
from rocm_apex_tpu_torch.amp import amp as tamp_mod
from rocm_apex_tpu_torch.amp.lists import functional_overrides as tfo
from rocm_apex_tpu_torch.amp.lists import torch_overrides as tlists
from rocm_apex_tpu_torch.convert import flatten_params, random_params
from rocm_apex_tpu_torch.models.gpt import GPTConfig, GPTModel

DECORATORS = ["half_function", "bfloat16_function", "float_function",
              "policy_function", "promote_function"]
LIST_NAMES = ["FP16_FUNCS", "BFLOAT16_FUNCS", "FP32_FUNCS", "CASTS",
              "SEQUENCE_CASTS", "BANNED_FUNCS"]


@pytest.fixture(autouse=True)
def _no_policy():
    amp.init(None)
    jax_amp_init(None)
    yield
    amp.init(None)
    jax_amp_init(None)


def _name(dtype):
    return str(dtype).replace("torch.", "")


def _args(lib):
    """fp32 at the top, bf16 in a list, fp16 in a dict in the list, an int
    tensor and a Python float as keyword arguments."""
    if lib == "jax":
        x = jnp.ones((2,), jnp.float32)
        y = jnp.ones((2,), jnp.bfloat16)
        z = jnp.ones((2,), jnp.float16)
        i = jnp.ones((2,), jnp.int32)
    else:
        x = torch.ones(2)
        y = torch.ones(2, dtype=torch.bfloat16)
        z = torch.ones(2, dtype=torch.float16)
        i = torch.ones(2, dtype=torch.int32)
    return (x, [y, {"z": z}]), dict(i=i, s=0.5)


def _dtypes(x, ys, i, s):
    return [_name(x.dtype), _name(ys[0].dtype), _name(ys[1]["z"].dtype),
            _name(i.dtype), type(s).__name__]


def _run(pkg, lib, decorator):
    args, kw = _args(lib)
    return getattr(pkg, decorator)(_dtypes)(*args, **kw)


def _initialize(level):
    """Both packages at ``level`` (None: no policy); returns the port's
    amp_state."""
    if level is None:
        return None
    jamp.initialize({"w": jnp.zeros(2)}, opt_level=level, verbosity=0)
    params, _, st = amp.initialize({"w": torch.zeros(2)}, opt_level=level,
                                   verbosity=0)
    assert params["w"].dtype == (torch.float32 if level in ("O1", "O4")
                                 else st.policy.cast_model_dtype)
    return st


@pytest.mark.parametrize("scope", ["plain", "disable_casts"])
@pytest.mark.parametrize("level", [None, "O1", "O4", "O5"])
@pytest.mark.parametrize("decorator", DECORATORS)
def test_decorator_dtypes_match_jax(decorator, level, scope):
    st = _initialize(level)
    if level in ("O1", "O4"):
        assert amp.current_policy() is st.policy
    else:
        assert amp.current_policy() is None
    if scope == "disable_casts":
        with amp.disable_casts(), jamp.disable_casts():
            got, want = _run(amp, "torch", decorator), \
                _run(jamp, "jax", decorator)
        assert got == ["float32", "bfloat16", "float16", "int32", "float"]
    else:
        got, want = _run(amp, "torch", decorator), \
            _run(jamp, "jax", decorator)
    assert got == want


def test_casting_levels_cast_as_documented():
    """The dtypes themselves: fp16 from `half_function` under O1 and O4;
    `policy_function` fp16 under O1, bf16 under O4; cleared by O5."""
    _initialize("O4")
    assert _run(amp, "torch", "half_function")[:3] == ["float16"] * 3
    assert _run(amp, "torch", "policy_function")[:3] == ["bfloat16"] * 3
    assert _run(amp, "torch", "float_function")[:3] == ["float32"] * 3
    _initialize("O1")
    assert _run(amp, "torch", "policy_function")[:3] == ["float16"] * 3
    _initialize("O5")
    assert amp.current_policy() is None
    assert _run(amp, "torch", "half_function")[:3] == \
        ["float32", "bfloat16", "float16"]


def test_disabled_policy_does_not_cast():
    policy = amp.build_policy("O4")
    amp.init(policy, enabled=False)
    assert amp.current_policy() is None
    amp.init(policy)
    assert amp.current_policy() is policy
    assert _run(amp, "torch", "policy_function")[0] == "bfloat16"


@pytest.mark.parametrize("register", ["register_half_function",
                                      "register_bfloat16_function",
                                      "register_float_function",
                                      "register_promote_function"])
def test_register_on_a_namespace(register):
    def fn(a, b):
        return [_name(a.dtype), _name(b.dtype)]

    tns = types.SimpleNamespace(fn=fn)
    jns = types.SimpleNamespace(fn=fn)
    getattr(amp, register)(tns, "fn")
    getattr(jamp, register)(jns, "fn")
    assert tns.fn is not fn and tns.fn.__name__ == "fn"
    ta, tb = torch.ones(1, dtype=torch.bfloat16), torch.ones(1)
    ja, jb = jnp.ones(1, jnp.bfloat16), jnp.ones(1)
    assert tns.fn(ta, tb) == ["bfloat16", "float32"]  # no policy
    _initialize("O4")
    assert tns.fn(ta, tb) == jns.fn(ja, jb)


PROMOTE = [("bfloat16", "float16"), ("bfloat16", "float32"),
           ("float16", "float16"), ("float16", "float32"),
           ("bfloat16", "bfloat16")]


@pytest.mark.parametrize("a,b", PROMOTE)
@pytest.mark.parametrize("level", ["O1", "O4"])
def test_promote_function_mixed_dtypes(level, a, b):
    _initialize(level)

    def fn(*xs):
        return [_name(x.dtype) for x in xs]

    got = amp.promote_function(fn)(
        torch.ones(1, dtype=getattr(torch, a)),
        torch.ones(1, dtype=getattr(torch, b)),
        torch.ones(1, dtype=torch.int64))
    want = jamp.promote_function(fn)(
        jnp.ones(1, getattr(jnp, a)), jnp.ones(1, getattr(jnp, b)),
        jnp.ones(1, jnp.int32))
    assert got[:2] == want[:2]
    assert got[2] == "int64"
    if {a, b} == {"bfloat16", "float16"}:
        assert got[:2] == ["float32", "float32"]
    # no floating argument: called as it is
    assert amp.promote_function(fn)(torch.ones(1, dtype=torch.int8)) == \
        ["int8"]


@pytest.mark.parametrize("name", LIST_NAMES)
def test_lists_match_jax(name):
    assert getattr(tlists, name) == getattr(jlists, name)
    assert getattr(tfo, name) == getattr(jfo, name)


def test_list_predicates_match_jax():
    names = set(jlists.FP16_FUNCS) | set(jlists.FP32_FUNCS) | \
        set(jlists.CASTS) | {"binary_cross_entropy", "no_such_op"}
    for n in sorted(names):
        assert tlists.is_low_precision_op(n) == jlists.is_low_precision_op(n)
        assert tlists.is_fp32_op(n) == jlists.is_fp32_op(n)
        assert tfo.is_fp32_op(n) == jfo.is_fp32_op(n)


def test_exports_match_jax():
    assert set(jamp.__all__) <= set(amp.__all__)
    for name in tamp_mod.__all__:
        assert getattr(amp, name) is getattr(tamp_mod, name)


# ---------------------------------------------------------------------------
# O4 on a 2-layer GPT: fp32 params, bf16 compute, fp32 gradients
# ---------------------------------------------------------------------------

SHAPE = dict(vocab_size=512, hidden_size=256, num_layers=2,
             num_attention_heads=2, max_position_embeddings=64,
             tensor_parallel_size=1, hidden_dropout=0.0,
             attention_dropout=0.0)
BATCH, SEQ = 2, 64
GRAD_SHARE = 3e-2


def _batch():
    rng = np.random.default_rng(3)
    tokens = rng.integers(0, SHAPE["vocab_size"], (BATCH, SEQ))
    return tokens.astype(np.int32), np.roll(tokens, -1, 1).astype(np.int32)


def test_o4_gpt_gradients_match_jax():
    cfg = GPTConfig(**SHAPE, params_dtype=torch.float32,
                    dtype=torch.bfloat16)
    tree = random_params(cfg, seed=0)
    tokens, labels = _batch()

    jmodel = JaxGPTModel(JaxGPTConfig(**SHAPE, params_dtype=jnp.float32,
                                      dtype=jnp.bfloat16))
    jparams, _, _ = jamp.initialize(
        jax.tree_util.tree_map(jnp.asarray, tree), opt_level="O4",
        verbosity=0)

    @jamp.policy_function
    def jloss(params, t, lbl):
        return jmodel.apply(params, t, labels=lbl, loss_reduction="mean")

    jl, jg = jax.value_and_grad(jloss)(jparams, jnp.asarray(tokens),
                                       jnp.asarray(labels))
    jg = flatten_params(jax.tree_util.tree_map(np.asarray, jg["params"]))

    model = GPTModel(cfg, device="cpu")
    params, _, st = amp.initialize(
        {k: torch.from_numpy(np.array(v)) for k, v in
         flatten_params(tree["params"]).items()}, opt_level="O4",
        verbosity=0)
    assert amp.current_policy() is st.policy
    assert all(p.dtype == torch.float32 for p in params.values())
    params = {k: p.requires_grad_(True) for k, p in params.items()}

    @amp.policy_function
    def loss_fn(p, t, lbl):
        assert all(v.dtype == torch.bfloat16 for v in p.values())
        return torch.func.functional_call(
            model, p, (t,), dict(labels=lbl, loss_reduction="mean"))

    loss = loss_fn(params, torch.from_numpy(tokens).long(),
                   torch.from_numpy(labels).long())
    names = list(params)
    grads = dict(zip(names, torch.autograd.grad(loss,
                                                [params[k] for k in names])))
    np.testing.assert_allclose(float(loss), float(jl), rtol=1e-3)
    assert set(grads) == set(jg)
    for k, g in grads.items():
        assert g.dtype == torch.float32, k
        want = jg[k].astype(np.float32)
        err = np.abs(g.numpy() - want).max() / (np.abs(want).max() + 1e-30)
        assert err < GRAD_SHARE, (k, err)
