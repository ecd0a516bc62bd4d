"""The port's masked `BertModel` (a padding mask: the unpacked flash
attention with the -1e30 bias) against the JAX package, on the CPU.

The tiny fp32 config of tests/test_torch_bert.py (2 layers, hidden 128,
4 heads, ffn 512, vocab 1024, S 64, B 2, dropout 0), with a padding mask
of two lengths (64 and 41: the second row's padded queries attend
nothing). The same numpy-drawn weights and tokens go into both models;
the JAX side runs its Pallas kernels in interpret mode (the unpacked
`_fwd`/`_bwd` with `compute_dbias=False`), the port its kernels' plain
versions. Tolerances are those of tests/test_torch_bert.py: both sides
compute in fp32 and differ in summation order only.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rocm_apex_tpu.models.bert import BertConfig as JaxBertConfig
from rocm_apex_tpu.models.bert import BertModel as JaxBertModel
from rocm_apex_tpu.optimizers.mixed import MixedPrecisionLamb as JaxLamb
from rocm_apex_tpu_torch.convert import (
    flatten_params,
    from_jax_params,
    random_params,
    train_state_from_jax_params,
)
from rocm_apex_tpu_torch.models.bert import BertConfig
from rocm_apex_tpu_torch.models.gpt import padding_bias
from rocm_apex_tpu_torch.optimizers import MixedPrecisionLamb
from rocm_apex_tpu_torch.train import make_bert_train_step

SHAPE = dict(vocab_size=1024, hidden_size=128, num_layers=2,
             num_attention_heads=4, ffn_hidden_size=512,
             max_position_embeddings=64, tensor_parallel_size=1,
             hidden_dropout=0.0, attention_dropout=0.0)
BATCH, SEQ = 2, 64
LENGTHS = (64, 41)
LR, WD = 1e-3, 0.01
STEPS = 3
LOGIT_TOL = dict(rtol=1e-4, atol=1e-4)


def jax_cfg():
    return JaxBertConfig(**SHAPE, params_dtype=jnp.float32,
                         dtype=jnp.float32)


def torch_cfg():
    return BertConfig(**SHAPE, params_dtype=torch.float32,
                      dtype=torch.float32)


def _batch():
    rng = np.random.default_rng(17)
    tokens = rng.integers(0, SHAPE["vocab_size"], (BATCH, SEQ))
    types = rng.integers(0, 2, (BATCH, SEQ))
    mask = (np.arange(SEQ)[None, :] < np.array(LENGTHS)[:, None])
    return (tokens.astype(np.int32), np.roll(tokens, 1, 1).astype(np.int32),
            types.astype(np.int32), mask.astype(np.int32))


def _np_tree(tree):
    return flatten_params(jax.tree_util.tree_map(np.asarray,
                                                 tree.get("params", tree)))


def _decay_mask(names):
    return {k: not (k.endswith("bias") or "layernorm" in k.lower())
            for k in names}


def _mask_tree(tree, prefix=""):
    return {k: (_mask_tree(v, f"{prefix}{k}.") if isinstance(v, dict)
                else _decay_mask([prefix + k])[prefix + k])
            for k, v in tree.items()}


BINARY_W = np.random.default_rng(19).standard_normal((BATCH, 2)).astype(
    np.float32)


@pytest.fixture(scope="module")
def jax_run():
    tree = random_params(torch_cfg(), seed=3)
    jtree = jax.tree_util.tree_map(jnp.asarray, tree)
    model = JaxBertModel(jax_cfg())
    tokens, labels, types, mask = _batch()
    jt, jl, jty, jm = (jnp.asarray(a) for a in (tokens, labels, types, mask))
    out = dict(tree=tree)
    out["logits"], out["binary"] = (np.asarray(a) for a in model.apply(
        jtree, jt, attention_mask=jm, tokentype_ids=jty))

    def loss_fn(p):
        losses, binary = model.apply(p, jt, attention_mask=jm,
                                     tokentype_ids=jty, lm_labels=jl)
        return jnp.mean(losses) + jnp.sum(binary * BINARY_W), losses

    (_, losses), grads = jax.value_and_grad(loss_fn, has_aux=True)(jtree)
    out["losses"] = np.asarray(losses)
    out["grads"] = _np_tree(grads)

    # three masked steps of bench.py's BERT one_step, eagerly
    opt = JaxLamb(LR, weight_decay=WD,
                  weight_decay_mask={"params": _mask_tree(tree["params"])},
                  compute_dtype=jnp.float32, moment_dtype=jnp.float32,
                  store_model=False)
    state = opt.init(jtree)
    traj = []
    for _ in range(STEPS):
        def step_loss(p):
            step_losses, _ = model.apply(p, jt, attention_mask=jm,
                                         lm_labels=jl)
            return jnp.mean(step_losses)

        loss, g = jax.value_and_grad(step_loss)(opt.model_params(state))
        state, found = opt.step_and_probe(state, g)
        assert not bool(found)
        traj.append(float(loss))
    out["traj"] = traj
    out["master"] = _np_tree(state.master)
    return out


def _inputs():
    return tuple(torch.from_numpy(a).long() for a in _batch())


def test_padding_bias_is_the_jax_models():
    """The (b, sq, sk) fp32 bias: -1e30 where the extended mask masks a
    pair (gpt.py:978-990), 0 elsewhere; a padded query row is all -1e30."""
    from rocm_apex_tpu_torch.models.bert import bert_extended_attention_mask

    mask = _inputs()[3]
    bias = padding_bias(bert_extended_attention_mask(mask), BATCH, SEQ)
    assert bias.shape == (BATCH, SEQ, SEQ) and bias.dtype == torch.float32
    n = LENGTHS[1]
    assert bool((bias[0] == 0).all())
    assert bool((bias[1, :n, :n] == 0).all())
    assert bool((bias[1, n:] == -1e30).all())
    assert bool((bias[1, :, n:] == -1e30).all())


def test_masked_logits_match_jax(jax_run):
    model = from_jax_params(jax_run["tree"], torch_cfg(), device="cpu")
    tokens, _, types, mask = _inputs()
    with torch.no_grad():
        logits, binary = model(tokens, attention_mask=mask,
                               tokentype_ids=types)
        unmasked, _ = model(tokens, tokentype_ids=types)
    np.testing.assert_allclose(logits.numpy(), jax_run["logits"],
                               **LOGIT_TOL)
    np.testing.assert_allclose(binary.numpy(), jax_run["binary"],
                               **LOGIT_TOL)
    # the mask really enters: the padded row differs from the unmasked run
    assert float((logits[1] - unmasked[1]).abs().max()) > 1e-3
    # an unpadded row attends all keys either way
    np.testing.assert_allclose(logits[0].numpy(), unmasked[0].numpy(),
                               rtol=1e-5, atol=1e-5)


def test_masked_losses_and_every_gradient_match_jax(jax_run):
    model = from_jax_params(jax_run["tree"], torch_cfg(), device="cpu")
    tokens, labels, types, mask = _inputs()
    losses, binary = model(tokens, attention_mask=mask, tokentype_ids=types,
                           lm_labels=labels)
    np.testing.assert_allclose(losses.detach().numpy(), jax_run["losses"],
                               rtol=1e-4, atol=1e-5)
    (losses.mean() + (binary * torch.from_numpy(BINARY_W)).sum()).backward()
    named = dict(model.named_parameters())
    assert set(named) == set(jax_run["grads"])
    for k, g in jax_run["grads"].items():
        got = named[k].grad.numpy()
        # relative to each gradient's largest entry, as test_torch_bert.py
        err = np.abs(got - g).max() / (np.abs(g).max() + 1e-30)
        assert err < 2e-5, (k, err)


def test_three_step_masked_lamb_trajectory_matches_jax(jax_run):
    names = flatten_params(jax_run["tree"]["params"])
    opt = MixedPrecisionLamb(LR, weight_decay=WD,
                             weight_decay_mask=_decay_mask(names),
                             compute_dtype=torch.float32)
    model, state = train_state_from_jax_params(jax_run["tree"], torch_cfg(),
                                               opt, device="cpu")
    step = make_bert_train_step(model, opt)
    tokens, labels, _, mask = _inputs()
    losses = []
    for _ in range(STEPS):
        state, loss, found = step(state, tokens, labels, attention_mask=mask)
        assert not bool(found)
        losses.append(float(loss))
    np.testing.assert_allclose(losses, jax_run["traj"], rtol=1e-5)
    assert losses[-1] < losses[0]
    for k, want in jax_run["master"].items():
        # as tests/test_torch_bert.py: fp32 gradient noise through three
        # normalized steps
        np.testing.assert_allclose(state.master[k].numpy(), want,
                                   rtol=1e-5, atol=2e-6, err_msg=k)


def test_masked_dropout_is_seeded_and_reproducible(jax_run):
    """With dropout on, a masked step draws its sites' seeds from the
    generator: the same seed gives the same loss, another seed another."""
    cfg = BertConfig(**{**SHAPE, "hidden_dropout": 0.1,
                        "attention_dropout": 0.1},
                     params_dtype=torch.float32, dtype=torch.float32)
    model = from_jax_params(jax_run["tree"], cfg, device="cpu")
    tokens, labels, _, mask = _inputs()

    def loss(seed):
        with torch.no_grad():
            losses, _ = model(tokens, attention_mask=mask, lm_labels=labels,
                              deterministic=False,
                              dropout_generator=torch.Generator().manual_seed(
                                  seed))
        return float(losses.mean())

    assert loss(1) == loss(1)
    assert loss(1) != loss(2)
    with torch.no_grad():
        det, _ = model(tokens, attention_mask=mask, lm_labels=labels)
    assert loss(1) != float(det.mean())
