"""The port's GPT training step against the JAX package, on the CPU.

One small fp32 config with the bench model's head_dim 128 (the packed
attention path needs hd % 128 == 0, gpt.py:443 of the JAX package):
vocab 512, hidden 256, 2 heads, 2 layers, S 64, B 2, dropout 0. The same
numpy-drawn weights (`convert.random_params`) and tokens go into both
models; the JAX side runs its Pallas kernels in interpret mode, the port
its kernels' plain versions. Tolerances are stated per test; the base is
fp32 ~1e-5 relative: both sides compute in fp32 and differ in summation
order only.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rocm_apex_tpu.amp.scaler import LossScaler as JaxLossScaler
from rocm_apex_tpu.models.gpt import GPTConfig as JaxGPTConfig
from rocm_apex_tpu.models.gpt import GPTModel as JaxGPTModel
from rocm_apex_tpu.optimizers.mixed import MixedPrecisionAdam as JaxAdam
from rocm_apex_tpu_torch.amp import LossScaler, all_finite
from rocm_apex_tpu_torch.convert import (
    flatten_params,
    from_jax_params,
    random_params,
    train_state_from_jax_params,
)
from rocm_apex_tpu_torch.models.gpt import GPTConfig, GPTModel
from rocm_apex_tpu_torch.optimizers import MixedPrecisionAdam
from rocm_apex_tpu_torch.train import make_train_step

SHAPE = dict(vocab_size=512, hidden_size=256, num_layers=2,
             num_attention_heads=2, max_position_embeddings=64,
             tensor_parallel_size=1, hidden_dropout=0.0,
             attention_dropout=0.0)
BATCH, SEQ = 2, 64
# Adam hyperparameters of the trajectory. eps 1e-6, not the default
# 1e-8: Adam's normalized step turns a near-zero gradient's fp32
# summation noise (~1e-7 of the tensor's scale) into up to a full lr step
# of either sign when eps is below that noise; at 1e-6 the step is
# smooth in the gradient, so the two trajectories stay comparable.
LR, WD, EPS = 1e-3, 0.01, 1e-6
STEPS = 3


def jax_cfg():
    return JaxGPTConfig(**SHAPE, params_dtype=jnp.float32, dtype=jnp.float32)


def torch_cfg(**kw):
    return GPTConfig(**{**SHAPE, **kw}, params_dtype=torch.float32,
                     dtype=torch.float32)


def _batch():
    rng = np.random.default_rng(11)
    tokens = rng.integers(0, SHAPE["vocab_size"], (BATCH, SEQ))
    return tokens.astype(np.int32), np.roll(tokens, -1, 1).astype(np.int32)


def _np_tree(tree):
    return flatten_params(jax.tree_util.tree_map(np.asarray,
                                                 tree["params"]))


@pytest.fixture(scope="module")
def jax_run():
    """Three JAX steps of bench.py's `one_step` (the scaled fused-head
    mean loss, `step_and_probe(grad_scale=1/scale)`, `scaler.update`),
    recording each step's loss and gradients and the final masters."""
    tree = random_params(torch_cfg(), seed=0)
    model = JaxGPTModel(jax_cfg())
    tokens, labels = _batch()
    opt = JaxAdam(LR, weight_decay=WD, eps=EPS, compute_dtype=jnp.float32)
    scaler = JaxLossScaler("dynamic")
    state = opt.init(jax.tree_util.tree_map(jnp.asarray, tree))
    sstate = scaler.init()
    losses, grads = [], []
    for _ in range(STEPS):
        def loss_fn(params, sstate=sstate):
            return model.apply(
                params, jnp.asarray(tokens), labels=jnp.asarray(labels),
                loss_reduction="mean",
            ) * scaler.loss_scale(sstate)

        scaled, g = jax.value_and_grad(loss_fn)(state.model)
        inv = 1.0 / scaler.loss_scale(sstate)
        state, found_inf = opt.step_and_probe(state, g, grad_scale=inv)
        sstate, _ = scaler.update(sstate, found_inf)
        losses.append(float(scaled * inv))
        # the scale is a power of two: dividing the gradient by it is
        # exact
        grads.append({k: v / float(1.0 / inv) for k, v in
                      _np_tree(g).items()})
    logits = model.apply(jax.tree_util.tree_map(jnp.asarray, tree),
                         jnp.asarray(tokens))
    return dict(tree=tree, losses=losses, grads=grads,
                master=_np_tree(state.master), logits=np.asarray(logits),
                loss_scale=float(sstate.loss_scale))


class TestForward:
    def test_uncached_logits_match_jax(self, jax_run):
        model = from_jax_params(jax_run["tree"], torch_cfg(), device="cpu")
        tokens, _ = _batch()
        logits = model(torch.from_numpy(tokens).long())
        assert logits.shape == (BATCH, SEQ, SHAPE["vocab_size"])
        # logits of order 1 after 2 layers and a 256-wide projection:
        # fp32 summation order differs with the thread count the two
        # libraries use (~2e-5 seen under the parallel test runner);
        # 1e-4, as tests/test_torch_gpt.py holds the cached logits
        np.testing.assert_allclose(logits.detach().numpy(),
                                   jax_run["logits"], rtol=1e-4, atol=1e-4)

    def test_loss_and_every_gradient_match_jax(self, jax_run):
        model = from_jax_params(jax_run["tree"], torch_cfg(), device="cpu")
        tokens, labels = _batch()
        loss = model(torch.from_numpy(tokens).long(),
                     labels=torch.from_numpy(labels).long(),
                     loss_reduction="mean")
        loss.backward()
        np.testing.assert_allclose(float(loss.detach()), jax_run["losses"][0],
                                   rtol=1e-5)
        named = dict(model.named_parameters())
        assert set(named) == set(jax_run["grads"][0])
        for k, g in jax_run["grads"][0].items():
            got = named[k].grad.numpy()
            # relative to each gradient's largest entry: fp32 sums over
            # the 128 rows (and 512 vocab columns) in two orders
            err = np.abs(got - g).max() / (np.abs(g).max() + 1e-30)
            assert err < 1e-5, (k, err)

    def test_per_token_losses_with_a_mask(self, jax_run):
        """``labels`` without a reduction returns per-token fp32 losses,
        times ``loss_mask``; their masked mean is the ``"mean"`` loss."""
        model = from_jax_params(jax_run["tree"], torch_cfg(), device="cpu")
        tokens, labels = _batch()
        mask = torch.ones(BATCH, SEQ)
        mask[:, -5:] = 0.0
        t, lbl = torch.from_numpy(tokens).long(), torch.from_numpy(labels)
        with torch.no_grad():
            losses = model(t, labels=lbl.long(), loss_mask=mask)
            mean = model(t, labels=lbl.long(), loss_mask=mask,
                         loss_reduction="mean")
        assert losses.shape == (BATCH, SEQ)
        assert torch.all(losses[:, -5:] == 0.0)
        np.testing.assert_allclose(float(losses.sum() / mask.sum()),
                                   float(mean), rtol=1e-6)


class TestTrainStep:
    def test_three_step_trajectory_matches_jax(self, jax_run):
        opt = MixedPrecisionAdam(LR, weight_decay=WD, eps=EPS,
                                 compute_dtype=torch.float32)
        scaler = LossScaler("dynamic")
        model, state = train_state_from_jax_params(
            jax_run["tree"], torch_cfg(), opt, device="cpu")
        sstate = scaler.init()
        step = make_train_step(model, opt, scaler)
        tokens, labels = _batch()
        losses = []
        for _ in range(STEPS):
            state, sstate, loss = step(state, sstate,
                                       torch.from_numpy(tokens).long(),
                                       torch.from_numpy(labels).long())
            losses.append(float(loss))
        np.testing.assert_allclose(losses, jax_run["losses"], rtol=1e-5)
        assert int(state.count) == STEPS
        assert float(sstate.loss_scale) == jax_run["loss_scale"]
        for k, m in jax_run["master"].items():
            # 2e-5 absolute is 2% of one lr step: the gradient noise
            # above through eps 1e-6, summed over the steps (4.6e-6 seen)
            np.testing.assert_allclose(state.master[k].numpy(), m,
                                       rtol=1e-5, atol=2e-5, err_msg=k)
            np.testing.assert_array_equal(
                dict(model.named_parameters())[k].detach().numpy(),
                state.master[k].numpy())

    def test_an_injected_inf_halves_the_scale_and_freezes_the_masters(
            self, jax_run):
        """One step with an inf in one gradient: `step_and_probe` reports
        it, the masters, moments, count and model stay bit-identical,
        and the dynamic scaler halves its scale and counts the overflow —
        the JAX optimizer and scaler decide the same."""
        opt = MixedPrecisionAdam(LR, weight_decay=WD, eps=EPS,
                                 compute_dtype=torch.float32)
        scaler = LossScaler("dynamic")
        model, state = train_state_from_jax_params(
            jax_run["tree"], torch_cfg(), opt, device="cpu")
        sstate = scaler.init()
        before = {k: v.clone() for k, v in state.master.items()}
        grads = {k: torch.full_like(v, 1e-3) for k, v in before.items()}
        grads["transformer.layer_1.mlp.dense_4h_to_h.bias"][3] = float("inf")
        state, found_inf = opt.step_and_probe(
            state, grads, grad_scale=1.0 / sstate.loss_scale)
        sstate, skip = scaler.update(sstate, found_inf)
        assert bool(found_inf) and bool(skip)
        assert float(sstate.loss_scale) == 2.0**15
        assert int(sstate.overflows) == 1 and int(sstate.unskipped) == 0
        assert int(state.count) == 0
        for k, v in before.items():
            assert torch.equal(state.master[k], v), k
            assert torch.equal(state.m[k], torch.zeros_like(v))
            assert torch.equal(dict(model.named_parameters())[k].detach(), v)

        jopt = JaxAdam(LR, weight_decay=WD, eps=EPS,
                       compute_dtype=jnp.float32)
        jscaler = JaxLossScaler("dynamic")
        jstate = jopt.init({k: jnp.asarray(v.numpy())
                            for k, v in before.items()})
        jgrads = {k: jnp.asarray(v.numpy()) for k, v in grads.items()}
        jstate2, jfound = jopt.step_and_probe(jstate, jgrads,
                                              grad_scale=2.0**-16)
        jss, _ = jscaler.update(jscaler.init(), jfound)
        assert bool(jfound) and float(jss.loss_scale) == 2.0**15
        for k, v in before.items():
            np.testing.assert_array_equal(np.asarray(jstate2.master[k]),
                                          v.numpy())

    def test_step_with_a_skip_and_a_decay_mask_matches_jax(self):
        """`step`: ``skip`` freezes every buffer and the count;
        ``weight_decay_mask`` decays only the parameters it names."""
        rng = np.random.default_rng(21)
        params = {k: rng.standard_normal(5).astype(np.float32)
                  for k in ("a", "b")}
        grads = {k: rng.standard_normal(5).astype(np.float32)
                 for k in params}
        kw = dict(weight_decay=0.5, weight_decay_mask={"a": True, "b": False})
        opt = MixedPrecisionAdam(0.1, compute_dtype=torch.float32, **kw)
        jopt = JaxAdam(0.1, compute_dtype=jnp.float32, **kw)
        state = opt.init({k: torch.from_numpy(v) for k, v in params.items()})
        jstate = jopt.init({k: jnp.asarray(v) for k, v in params.items()})
        tg = {k: torch.from_numpy(v) for k, v in grads.items()}
        jg = {k: jnp.asarray(v) for k, v in grads.items()}
        state = opt.step(state, tg, skip=torch.tensor(True))
        assert int(state.count) == 0
        for k, v in params.items():
            np.testing.assert_array_equal(state.master[k].numpy(), v)
        state = opt.step(state, tg, grad_scale=0.5)
        jstate = jopt.step(jstate, jg, grad_scale=0.5)
        assert int(state.count) == 1
        for k in params:
            np.testing.assert_allclose(state.master[k].numpy(),
                                       np.asarray(jstate.master[k]),
                                       rtol=1e-6, atol=1e-7)
            assert torch.equal(state.model[k], state.master[k])

    def test_scaler_grows_after_its_window(self):
        scaler = LossScaler("dynamic", init_scale=8.0, scale_window=2,
                            max_loss_scale=16.0)
        s = scaler.init()
        clean = torch.tensor(False)
        scales = []
        for _ in range(4):
            s, _ = scaler.update(s, clean)
            scales.append(float(s.loss_scale))
        # doubles after 2 clean steps, then clamps at the max
        assert scales == [8.0, 16.0, 16.0, 16.0]
        assert bool(all_finite([torch.ones(3)]))
        assert not bool(all_finite([torch.tensor([1.0, float("nan")])]))


class TestDropout:
    def test_dropout_is_seeded_per_step_and_reproducible(self, jax_run):
        """``deterministic=False`` turns on hidden, attention and
        embedding dropout with per-site seeds drawn from the generator:
        the loss moves off the deterministic one and the same generator
        state reproduces it bit for bit."""
        cfg = torch_cfg(hidden_dropout=0.1, attention_dropout=0.1)
        model = from_jax_params(jax_run["tree"], cfg, device="cpu")
        tokens, labels = _batch()
        args = (torch.from_numpy(tokens).long(),)
        kw = dict(labels=torch.from_numpy(labels).long(),
                  loss_reduction="mean")
        with torch.no_grad():
            det = float(model(*args, **kw))
            a = float(model(*args, **kw, deterministic=False,
                            dropout_generator=torch.Generator().manual_seed(1)))
            b = float(model(*args, **kw, deterministic=False,
                            dropout_generator=torch.Generator().manual_seed(1)))
            c = float(model(*args, **kw, deterministic=False,
                            dropout_generator=torch.Generator().manual_seed(2)))
        np.testing.assert_allclose(det, jax_run["losses"][0], rtol=1e-5)
        assert a == b and a != det and a != c


class TestEntryPoints:
    def test_training_entry_points_default_to_cuda(self):
        if torch.cuda.is_available():
            pytest.skip("a CUDA device is present")
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            GPTModel(torch_cfg())
        opt = MixedPrecisionAdam(compute_dtype=torch.float32)
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            train_state_from_jax_params(random_params(torch_cfg()),
                                        torch_cfg(), opt)

    @pytest.mark.parametrize("field,value", [
        ("comm_dtype", "int8"),
        ("activation_stats", True),
        ("checkpoint_activations", True),
        ("apply_residual_connection_post_layernorm", True),
    ])
    def test_unported_options_name_their_roadmap_item(self, field, value):
        """``activation_stats`` still raises naming its ROADMAP item (9b).
        The other three run now (tests/test_torch_remat.py and tests/
        test_torch_quantized_collectives.py hold them to JAX): at tp=1
        the int8 rings have no group and checkpointing recomputes the
        same layers, so both give the plain model's loss; post-LN is
        another model."""
        if field == "activation_stats":
            with pytest.raises(NotImplementedError, match="ROADMAP"):
                torch_cfg(**{field: value})
            return
        tree = random_params(torch_cfg(), seed=0)
        tokens, labels = (torch.from_numpy(a).long() for a in _batch())

        def loss(cfg):
            model = from_jax_params(tree, cfg, device="cpu")
            with torch.no_grad():
                return float(model(tokens, labels=labels,
                                   loss_reduction="mean"))

        plain, got = loss(torch_cfg()), loss(torch_cfg(**{field: value}))
        assert np.isfinite(got)
        if field == "apply_residual_connection_post_layernorm":
            assert abs(got - plain) > 1e-4 * abs(plain)
        else:
            np.testing.assert_allclose(got, plain, rtol=1e-6)
