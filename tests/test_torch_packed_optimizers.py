"""The port's packed-buffer optimizer updates and `PackedOptimizerStep`
against the JAX package, on the CPU.

The update wrappers run their plain PyTorch versions (a wrapper takes them
for CPU tensors), the JAX kernels their own CPU path, on the same
numpy-drawn buffers. Tolerances: one update is the same fp32 arithmetic
in the same order on both sides, so 1e-6 relative plus 1e-9 absolute
(XLA may regroup a quotient, ~1e-7). Three optimizer steps add the bias
corrections' pow (fp32 on both sides) and, for LAMB, trust-ratio norms
summed in another order (segmented row sums here, jax.ops.segment_sum
there): masters, moments and deltas 1e-6 relative plus 1e-9 (LAMB: 1e-8,
the ratio's ~1e-7 scaling a delta of 1e-2). A frozen or padded value is
held bit for bit.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rocm_apex_tpu.amp.scaler import LossScaler as JaxLossScaler
from rocm_apex_tpu.ops import optim_kernels as jok
from rocm_apex_tpu.ops import packing as jpk
from rocm_apex_tpu.optimizers import packed as jpacked
from rocm_apex_tpu_torch.amp import LossScaler
from rocm_apex_tpu_torch.ops import optim_kernels as tok
from rocm_apex_tpu_torch.ops import packing as tpk
from rocm_apex_tpu_torch.optimizers import (
    PackedOptimizerStep,
    adam_phase,
    packed_adam,
    packed_lamb,
)

ONE = dict(rtol=1e-6, atol=1e-9)
ROWS = 128


def _np(x):
    return x.float().numpy() if torch.is_tensor(x) \
        else np.asarray(x, dtype=np.float32)


def _bufs(seed, n, positive=()):
    """``n`` (ROWS, 1024) fp32 buffers of order 1 (those in ``positive``
    made positive: second moments), their last 7 rows padding (0)."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        b = rng.standard_normal((ROWS, tpk.WIDTH)).astype(np.float32)
        if i in positive:
            b = np.abs(b)
        b[-7:] = 0.0
        out.append(b)
    return out


def _col(seed, scale=0.01):
    """A (ROWS, 1) column, 0 on every third row and on the padding."""
    rng = np.random.default_rng(seed)
    c = (np.abs(rng.standard_normal((ROWS, 1))) * scale).astype(np.float32)
    c[::3] = 0.0
    c[-7:] = 0.0
    return c


def _both(arrays, dtypes=None):
    dtypes = dtypes or ["float32"] * len(arrays)
    return ([torch.from_numpy(a).to(getattr(torch, d))
             for a, d in zip(arrays, dtypes)],
            [jnp.asarray(a, d) for a, d in zip(arrays, dtypes)])


def _close(got, want, tol=ONE):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert tpk.dtype_name(g.dtype) == jnp.dtype(w.dtype).name
        np.testing.assert_allclose(_np(g), _np(w), **tol)


ADAM_S = [1e-2, 0.9, 1.0 - 0.9, 0.999, 1.0 - 0.999, 1e-8, 1 - 0.9 ** 3,
          1 - 0.999 ** 3, 0.5]


class TestUpdateKernels:
    @pytest.mark.parametrize("skip", [None, 0.0, 1.0])
    @pytest.mark.parametrize("adam_w", [True, False], ids=["adamw", "l2"])
    def test_adam_update(self, adam_w, skip):
        (p, g, m, v), (jp, jg, jm, jv) = _both(_bufs(1, 4, positive=(3,)))
        (wd,), (jwd,) = _both([_col(2)])
        s = ADAM_S + ([] if skip is None else [skip])
        got = tok.adam_update(p, g, m, v, wd, s, adam_w)
        _close(got, jok.adam_update(jp, jg, jm, jv, jwd, s, adam_w))
        if skip == 1.0:
            assert torch.equal(got[0], torch.zeros_like(p))
            assert torch.equal(got[1], m) and torch.equal(got[2], v)

    @pytest.mark.parametrize("dtypes", [
        ("float32", "bfloat16", "float32"),
        ("bfloat16", "float32", "float32"),
        ("bfloat16", "bfloat16", "bfloat16"),
    ], ids=["bf16_grad", "bf16_param", "bf16_all"])
    def test_adam_update_16_bit_buffers(self, dtypes):
        pd, gd, md = dtypes
        (p, g, m, v), (jp, jg, jm, jv) = _both(_bufs(3, 4, positive=(3,)),
                                               [pd, gd, md, md])
        (wd,), (jwd,) = _both([_col(4)])
        got = tok.adam_update(p, g, m, v, wd, ADAM_S, True)
        want = jok.adam_update(jp, jg, jm, jv, jwd, ADAM_S, True)
        # a bf16 moment rounds the same fp32 value: equal, or one ulp
        # apart where the fp32 values differ in their last bits
        _close(got, want, dict(rtol=2.0 ** -7 if md == "bfloat16" else 1e-6,
                               atol=1e-9))

    def test_adam_skip_freezes_an_inf_step_bit_for_bit(self):
        (p, g, m, v), _ = _both(_bufs(5, 4, positive=(3,)))
        (wd,), _ = _both([_col(6)])
        g[3, 5] = float("inf")
        g[9, 9] = float("nan")
        d, m2, v2 = tok.adam_update(p, g, m, v, wd, ADAM_S + [1.0], True)
        assert torch.equal(d, torch.zeros_like(d))
        assert torch.equal(m2, m) and torch.equal(v2, v)

    @pytest.mark.parametrize("first", [0.0, 1.0])
    @pytest.mark.parametrize("momentum_on", [True, False])
    @pytest.mark.parametrize("wd_after", [True, False])
    @pytest.mark.parametrize("nesterov", [True, False])
    def test_sgd_update(self, nesterov, wd_after, momentum_on, first):
        (p, g, b), (jp, jg, jb) = _both(_bufs(7, 3))
        (wd,), (jwd,) = _both([_col(8)])
        s = [1e-2, 0.9, 0.1, first, 0.5]
        _close(tok.sgd_update(p, g, b, wd, s, nesterov, wd_after,
                              momentum_on),
               jok.sgd_update(jp, jg, jb, jwd, s, nesterov, wd_after,
                              momentum_on))

    @pytest.mark.parametrize("w_mode", [True, False])
    def test_adagrad_update(self, w_mode):
        (p, g, h), (jp, jg, jh) = _both(_bufs(9, 3, positive=(2,)))
        (wd,), (jwd,) = _both([_col(10)])
        s = [1e-2, 1e-10, 0.5]
        _close(tok.adagrad_update(p, g, h, wd, s, w_mode),
               jok.adagrad_update(jp, jg, jh, jwd, s, w_mode))

    @pytest.mark.parametrize("reg_inside", [True, False])
    def test_novograd_update(self, reg_inside):
        (p, g, m), (jp, jg, jm) = _both(_bufs(11, 3))
        (wd, vcol), (jwd, jvcol) = _both([_col(12), _col(13, 1.0) + 0.5])
        s = [1e-2, 0.95, 0.05, 1e-8, 1 - 0.95 ** 2, 1 - 0.98 ** 2, 0.5]
        _close(tok.novograd_update(p, g, m, vcol, wd, s, reg_inside),
               jok.novograd_update(jp, jg, jm, jvcol, jwd, s, reg_inside))

    @pytest.mark.parametrize("adam_w", [True, False])
    def test_lamb_stages(self, adam_w):
        (p, g, m, v), (jp, jg, jm, jv) = _both(_bufs(14, 4, positive=(3,)))
        (wd, ratio), (jwd, jratio) = _both([_col(15), _col(16, 1.0)])
        s = [0.9, 0.999, 1.0 - 0.999, 0.1, 1e-6, 1 - 0.9 ** 2,
             1 - 0.999 ** 2, 0.5, 0.7]
        got = tok.lamb_stage1(p, g, m, v, wd, s, adam_w)
        _close(got, jok.lamb_stage1(jp, jg, jm, jv, jwd, s, adam_w))
        _close(tok.lamb_stage2(got[0], ratio, [1e-2]),
               jok.lamb_stage2(jnp.asarray(got[0].numpy()), jratio, [1e-2]))

    def test_scalars_may_be_one_device_vector(self):
        (p, g, m, v), _ = _both(_bufs(17, 4, positive=(3,)))
        (wd,), _ = _both([_col(18)])
        a = tok.adam_update(p, g, m, v, wd, ADAM_S, True)
        vec = tok.scalar_vector([torch.tensor(x) if i % 2 else x
                                 for i, x in enumerate(ADAM_S)], p.device)
        assert vec.dtype == torch.float32 and vec.shape == (9,)
        b = tok.adam_update(p, g, m, v, wd, vec, True)
        assert all(torch.equal(x, y) for x, y in zip(a, b))

    def test_refusals(self):
        (p, g, m, v), _ = _both(_bufs(19, 4))
        (wd,), _ = _both([_col(20)])
        with pytest.raises(ValueError, match="scalars"):
            tok.adam_update(p, g, m, v, wd, ADAM_S[:8], True)
        with pytest.raises(ValueError, match="column"):
            tok.adam_update(p, g, m, v, wd[:64], ADAM_S, True)
        with pytest.raises(ValueError, match="packed buffer"):
            tok.sgd_update(p[:100], g[:100], m[:100], wd[:100],
                           [1, 0, 0, 0, 1], False, False, False)
        # a device with no kernel and no plain version
        meta = [t.to("meta") for t in (p, g, m, v, wd)]
        with pytest.raises(RuntimeError, match="no kernel"):
            tok.adam_update(*meta, torch.zeros(9, device="meta"), True)


# ---------------------------------------------------------------------------
# the optimizers over trees
# ---------------------------------------------------------------------------

SHAPES = {"w": (33, 65), "b": (65,), "deep.k": (7, 3, 11)}


def _tree(seed, scale=1.0, shapes=SHAPES):
    rng = np.random.default_rng(seed)
    return {k: (rng.standard_normal(s) * scale).astype(np.float32)
            for k, s in shapes.items()}


def _jnest(flat, dtype=jnp.float32):
    out = {}
    for k, v in flat.items():
        node = out
        *path, leaf = k.split(".")
        for q in path:
            node = node.setdefault(q, {})
        node[leaf] = jnp.asarray(v, dtype)
    return out


def _jflat(tree):
    paths = jax.tree_util.tree_flatten_with_path(tree)[0]
    return {".".join(p.key for p in path): x for path, x in paths}


def _tflat(flat, dtype=torch.float32):
    return {k: torch.from_numpy(v).to(dtype) for k, v in flat.items()}


STEP_TOL = {"adam": ONE, "lamb": dict(rtol=1e-6, atol=1e-8)}


class TestPackedOptimizerStep:
    @pytest.mark.parametrize("compute", ["float32", "bfloat16"])
    @pytest.mark.parametrize("optimizer", ["adam", "lamb"])
    def test_three_steps_match_jax(self, optimizer, compute):
        params = _tree(1, 0.1)
        mask = {"w": True, "b": False, "deep.k": True}
        kw = dict(weight_decay=0.01, max_grad_norm=1.0 if optimizer == "lamb"
                  else 0.0)
        tdt = getattr(torch, compute)
        jopt = jpacked.PackedOptimizerStep(
            optimizer, 1e-2, compute_dtype=jnp.dtype(compute),
            weight_decay_mask=_jnest({k: float(v) for k, v in mask.items()}),
            **kw)
        opt = PackedOptimizerStep(optimizer, 1e-2, compute_dtype=tdt,
                                  weight_decay_mask=mask, **kw)
        jstate = jopt.init(_jnest(params))
        state = opt.init(_tflat(params))
        for t in range(3):
            grads = _tree(10 + t)
            # grads in the compute dtype, rounded alike on both sides
            tg = _tflat(grads, tdt)
            jg = _jnest({k: v.float().numpy() for k, v in tg.items()},
                        jnp.dtype(compute))
            state, found = opt.step_and_probe(state, tg, grad_scale=0.5)
            jstate, jfound = jopt.step_and_probe(jstate, jg, grad_scale=0.5)
            assert not bool(found) and not bool(jfound)
        assert int(state.count) == int(jstate.count) == 3
        tol = STEP_TOL[optimizer]
        for name in ("master", "m", "v"):
            _close(getattr(state, name), getattr(jstate, name), tol)
        jmodel = _jflat(jopt.model_params(jstate))
        for k, x in opt.model_params(state).items():
            assert x.dtype == tdt
            np.testing.assert_allclose(
                _np(x), _np(jmodel[k]),
                rtol=2.0 ** -7 if compute == "bfloat16" else 1e-6,
                atol=1e-9)
        jmasters = _jflat(jopt.masters(jstate))
        for k, x in opt.masters(state).items():
            np.testing.assert_allclose(_np(x), _np(jmasters[k]), **tol)

    def test_the_module_is_the_compute_copy(self):
        lin = torch.nn.Linear(65, 33)
        params = {"weight": torch.randn(33, 65), "bias": torch.randn(33)}
        opt = PackedOptimizerStep("adam", 1e-2, compute_dtype=torch.float32)
        state = opt.init(params, lin)
        assert state.model["weight"] is lin.weight
        grads = {k: torch.randn_like(v) for k, v in params.items()}
        state = opt.step(state, grads)
        for k, p in lin.named_parameters():
            assert torch.equal(p.detach(), opt.masters(state)[k])
            assert not torch.equal(p.detach(), params[k])

    @pytest.mark.parametrize("optimizer", ["adam", "lamb"])
    def test_an_overflowed_step_is_frozen_bit_for_bit(self, optimizer):
        opt = PackedOptimizerStep(optimizer, 1e-3, weight_decay=0.01,
                                  max_grad_norm=1.0)
        state = opt.init(_tflat(_tree(20)))
        g = _tflat(_tree(21), torch.bfloat16)
        state, f1 = opt.step_and_probe(state, g, grad_scale=1.0)
        keep = [[b.clone() for b in getattr(state, n)]
                for n in ("master", "m", "v")]
        model = {k: v.clone() for k, v in state.model.items()}
        g_inf = dict(g, b=g["b"].clone())
        g_inf["b"][0] = float("inf")
        state, f2 = opt.step_and_probe(state, g_inf, grad_scale=1.0)
        assert not bool(f1) and bool(f2) and int(state.count) == 1
        for n, kept in zip(("master", "m", "v"), keep):
            assert all(torch.equal(a, b)
                       for a, b in zip(getattr(state, n), kept)), n
        assert all(torch.equal(state.model[k], v) for k, v in model.items())

    def test_padding_stays_zero(self):
        opt = PackedOptimizerStep("adam", 1e-3, weight_decay=0.1,
                                  compute_dtype=torch.float32)
        state = opt.init(_tflat(_tree(22)))
        for t in range(3):
            state = opt.step(state, _tflat(_tree(23 + t)))
        spec = tpk.build_pack_spec(state.model)
        for name in ("master", "m", "v"):
            for buf, group in zip(getattr(state, name), spec.groups):
                live = torch.zeros(buf.numel(), dtype=torch.bool)
                for ls in group.leaf_specs:
                    live[ls.row_start * tpk.WIDTH:
                         ls.row_start * tpk.WIDTH + ls.numel] = True
                assert torch.all(buf.view(-1)[~live] == 0.0), name
                assert torch.any(buf.view(-1)[live] != 0.0), name

    def test_unknown_optimizer(self):
        with pytest.raises(ValueError, match="adam"):
            PackedOptimizerStep("sgd")


def _apply(params, updates):
    return {k: (p.float() + updates[k]).to(p.dtype) for k, p in params.items()}


def _run_transform(tx, params, gsteps, skips):
    state = tx.init(params)
    for g, skip in zip(gsteps, skips):
        updates, state = tx.update(g, state, params, skip=skip)
        params = _apply(params, updates)
    return params, state


class TestTransforms:
    @pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
    @pytest.mark.parametrize("which", ["adam", "lamb"])
    def test_update_matches_jax(self, which, dtype):
        tdt, jdt = getattr(torch, dtype), jnp.dtype(dtype)
        make = {"adam": (packed_adam, jpacked.packed_adam),
                "lamb": (packed_lamb, jpacked.packed_lamb)}[which]
        tx, jtx = (f(1e-2, weight_decay=0.01, grad_scale=0.5) for f in make)
        assert tx.update.kernel_skip and jtx.update.kernel_skip
        params = _tflat(_tree(30, 0.1), tdt)
        jparams = _jnest({k: _np(v) for k, v in params.items()}, jdt)
        state, jstate = tx.init(params), jtx.init(jparams)
        for t in range(2):
            g = _tree(31 + t)
            updates, state = tx.update(_tflat(g), state, params)
            jupdates, jstate = jtx.update(_jnest(g), jstate, jparams)
            jflat = _jflat(jupdates)
            for k, u in updates.items():
                assert u.dtype == torch.float32
                np.testing.assert_allclose(_np(u), _np(jflat[k]),
                                           **STEP_TOL[which])
            params = _apply(params, updates)
            jparams = jax.tree_util.tree_map(
                lambda p, u: (p.astype(jnp.float32) + u).astype(p.dtype),
                jparams, jupdates)
        _close(state.m, jstate.m, STEP_TOL[which])
        _close(state.v, jstate.v, STEP_TOL[which])
        assert int(state.count) == int(jstate.count) == 2

    def test_found_inf_continues_as_a_caller_skip(self):
        """An inf gradient's frozen step, and the steps after it, equal
        the same schedule with ``skip=True`` on finite gradients, bit for
        bit (tests/L0/test_packed_optimizers.py's contract)."""
        tx = packed_adam(1e-3, weight_decay=0.01)
        params = _tflat(_tree(40))
        gsteps = [_tflat(_tree(41 + t)) for t in range(3)]
        ginf = [dict(g) for g in gsteps]
        ginf[1]["b"] = ginf[1]["b"].clone()
        ginf[1]["b"][0] = float("inf")
        pa, sa = _run_transform(tx, params, ginf, [None] * 3)
        pb, sb = _run_transform(tx, params, gsteps,
                                [torch.tensor(s) for s in (False, True,
                                                           False)])
        assert int(sa.count) == int(sb.count) == 2
        assert all(torch.equal(pa[k], pb[k]) for k in pa)
        assert all(torch.equal(a, b) for a, b in zip(sa.m, sb.m))
        assert all(torch.equal(a, b) for a, b in zip(sa.v, sb.v))

    def test_adam_phase_clips_by_the_global_norm(self):
        """``max_grad_norm``: the grads are scaled by max / ||g|| when the
        norm exceeds it, so the first Adam step (m / sqrt(v) = sign) is
        unchanged but m is the clipped gradient's."""
        g = _tflat(_tree(50))
        spec = tpk.build_pack_spec(g)
        pp = tpk.pack_tree(_tflat(_tree(51)))
        pg = tpk.pack_tree(g, spec)
        zeros = [torch.zeros_like(b) for b in pp.buffers]
        wd = [torch.zeros(b.shape[0], 1) for b in pp.buffers]
        norm = float(torch.sqrt(sum((x.float() ** 2).sum()
                                    for x in g.values())))
        kw = dict(lr=1e-3, beta1=0.9, beta2=0.999, eps=1e-8, bc1=0.1,
                  bc2=0.001, grad_scale=1.0)
        _, m1, _, _ = adam_phase(pp, pg, zeros, zeros, wd, **kw)
        _, m2, _, _ = adam_phase(pp, pg, zeros, zeros, wd, max_grad_norm=1.0,
                                 **kw)
        np.testing.assert_allclose(_np(m2[0]), _np(m1[0]) / norm,
                                   rtol=1e-6, atol=1e-9)


class TestScaler:
    def test_unscale_packed_matches_jax(self):
        grads = _tree(60)
        grads["b"][3] = np.float32("inf")
        scaler, jscaler = LossScaler(init_scale=1024.0), \
            JaxLossScaler(init_scale=1024.0)
        packed = tpk.pack_tree(_tflat(grads, torch.bfloat16))
        jpackedg = jpk.pack_tree(_jnest({k: _np(v) for k, v in
                                         tpk.unpack_tree(packed).items()},
                                        jnp.bfloat16))
        out, inf = scaler.unscale_packed(scaler.init(), packed)
        jout, jinf = jscaler.unscale_packed(jscaler.init(), jpackedg)
        assert bool(inf) and bool(jinf)
        assert out.buffers[0].dtype == torch.float32
        _close(out.buffers, jout.buffers, dict(rtol=0.0, atol=0.0))
