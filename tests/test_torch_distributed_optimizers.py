"""The ZeRO optimizers (`contrib.optimizers.distributed_fused_adam`,
`distributed_fused_lamb`) against the JAX package's, on the CPU.

Two gloo ranks (spawned once for the module, `_torch_dp_ranks`'s
``"zero"`` suite) each feed their own numpy-drawn gradients of JAX's
test tree (w (24, 33), b (33,), emb (50, 16)) through three steps of
every configuration of ``R.ZERO_CONFIGS``: Adam at each ``predivide``,
L2 mode, the gradient-norm clip; LAMB with and without nvlamb and with
the weight-decay mask; the fp32, bf16 and e5m2 wires and int8 comm. The
JAX side runs the same in ``shard_map`` over two devices of the
conftest's host mesh. Also: e5m2 saturation at 57344, and the loss
scaler's round trip (``inv_scale``, ``with_info``; step 1 overflows on
rank 1 only, every rank skips it, masters, moments and count bit-frozen;
the port's ZeRO masters bit-equal to its replicated packed Adam on the
rank-order mean, as __graft_entry__.py part H holds JAX's). These
mirror tests/L0/test_distributed_optimizers.py:101-310.

Tolerance: the JAX test's, rtol 2e-6 and atol 2e-6 on the params (both
sides sum the same two fp32 values; the kernels' plain versions and
XLA's fusions round apart by an ulp); on a bf16 or e5m2 wire one step of
that wire (a master an ulp apart near a rounding boundary); the wires
among themselves as JAX's tests hold them. The exchanges a step are
counted and held to the module's derivation.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from jax.experimental.shard_map import shard_map
from jax.sharding import Mesh, PartitionSpec as P

import _torch_dp_ranks as R
from rocm_apex_tpu.contrib.optimizers import (
    distributed_fused_adam as jax_zero_adam,
    distributed_fused_lamb as jax_zero_lamb,
)
from rocm_apex_tpu_torch.contrib.optimizers import (
    DistributedFusedAdam,
    DistributedFusedLAMB,
    distributed_fused_adam,
)

DP = 2
TOL = dict(rtol=2e-6, atol=2e-6)
# a low wire's params are masters rounded to it: a master an fp32 ulp
# from JAX's near a rounding boundary lands one wire step away (bf16's
# step at most 2^-7 of the value, e5m2's 2^-2)
WIRE_TOL = {"bf16": dict(rtol=2 ** -7, atol=2e-6),
            "e5m2": dict(rtol=2 ** -2, atol=1e-4)}
SHAPES = {"w": (24, 33), "b": (33,), "emb": (50, 16)}


def _mesh():
    devs = jax.devices()
    if len(devs) < DP:
        pytest.skip(f"needs {DP} simulated devices")
    return Mesh(np.array(devs[:DP]), ("data",))


def _inputs():
    rng = np.random.default_rng(0)
    scale = {"w": 0.1, "b": 0.01, "emb": 0.1}
    inputs = {f"zp.{k}": (scale[k] * rng.standard_normal(s)).astype(
        np.float32) for k, s in SHAPES.items()}
    inputs.update({f"zg.{k}": rng.standard_normal((DP,) + s).astype(
        np.float32) for k, s in SHAPES.items()})
    hg = {k: (0.1 * rng.standard_normal((R.ZERO_STEPS, DP) + s)).astype(
        np.float32) for k, s in SHAPES.items()}
    hg["b"][R.OVERFLOW_STEP, R.OVERFLOW_RANK, 0] = np.inf
    inputs.update({f"hg.{k}": v for k, v in hg.items()})
    return inputs


def _params(inputs):
    return {k: jnp.asarray(inputs[f"zp.{k}"]) for k in SHAPES}


def _jax_tx(kind, kw):
    kw = dict(kw, axis_name="data")
    if "weight_decay_mask" in kw:
        kw["weight_decay_mask"] = dict(kw["weight_decay_mask"])
    return (jax_zero_adam if kind == "adam" else jax_zero_lamb)(R.LR, **kw)


def _jax_run(mesh, tx, params, grads, steps=R.ZERO_STEPS):
    def local(params, grads):
        grads = jax.tree_util.tree_map(lambda g: g[0], grads)
        state = tx.init(params)
        for _ in range(steps):
            updates, state = tx.update(grads, state, params)
            params = optax.apply_updates(params, updates)
        return params

    return jax.jit(shard_map(local, mesh=mesh, in_specs=(P(), P("data")),
                             out_specs=P(), check_rep=False))(params, grads)


def _jax_overflow(mesh, kind, inputs):
    tx = _jax_tx(kind, dict(weight_decay=0.01))
    raw = {k: jnp.asarray(inputs[f"hg.{k}"]) * R.SCALE for k in SHAPES}

    def local(params, gsteps):
        state = tx.init(params)
        flags = []
        for t in range(R.ZERO_STEPS):
            g = jax.tree_util.tree_map(lambda s: s[t][0], gsteps)
            updates, state, info = tx.update(g, state, params,
                                             inv_scale=1.0 / R.SCALE,
                                             with_info=True)
            params = optax.apply_updates(params, updates)
            flags.append(info["found_inf"])
        return params, jnp.stack(flags), state.count

    return jax.jit(shard_map(local, mesh=mesh,
                             in_specs=(P(), P(None, "data")),
                             out_specs=P(), check_rep=False))(
        _params(inputs), raw)


@pytest.fixture(scope="module")
def zero(tmp_path_factory):
    mesh = _mesh()
    inputs = _inputs()
    grads = {k: jnp.asarray(inputs[f"zg.{k}"]) for k in SHAPES}
    want = {name: _jax_run(mesh, _jax_tx(kind, kw), _params(inputs), grads)
            for name, (kind, kw) in R.ZERO_CONFIGS.items()}
    for kind in ("adam", "lamb"):
        want[f"overflow_{kind}"] = _jax_overflow(mesh, kind, inputs)
    outs = R.spawn(tmp_path_factory.mktemp("zero"), "zero", inputs)
    return dict(inputs=inputs, want=want, outs=outs)


def zero_exchanges(kind, comm="fp32", groups=1, world=DP, clip=False,
                   probe=False, skipped=False):
    """The exchanges of one update by kind (the module's derivation)."""
    out = {}

    def add(k, n):
        if n:
            out[k] = out.get(k, 0) + n

    hops = world - 1
    if comm == "int8":
        add("shift", groups * hops)
    else:
        add("reduce_scatter", groups)
    add("all_reduce", int(probe) + int(kind == "adam" and clip)
        + (1 + groups if kind == "lamb" else 0))
    if not skipped:
        add("shift" if comm == "int8" else "all_gather",
            groups * (hops if comm == "int8" else 1))
    return out


@pytest.mark.parametrize("name", list(R.ZERO_CONFIGS))
def test_trajectory_matches_jax(zero, name):
    """Three steps on each rank's own gradients: the params on both ranks
    bit-equal, and JAX's; the exchanges of each step as derived."""
    kind, kw = R.ZERO_CONFIGS[name]
    a, b = (o[f"zero_{name}"] for o in zero["outs"])
    for k in SHAPES:
        assert torch.equal(a["params"][k], b["params"][k]), k
        np.testing.assert_allclose(a["params"][k].numpy(),
                                   np.asarray(zero["want"][name][k]),
                                   err_msg=k, **WIRE_TOL.get(
                                       kw.get("allgather_dtype"), TOL))
    assert a["count"] == R.ZERO_STEPS
    want = zero_exchanges(kind, kw.get("comm_dtype", "fp32"),
                          clip=bool(kw.get("max_grad_norm")))
    assert a["exchanges"] == [want] * R.ZERO_STEPS


def test_master_shards_are_half_the_padded_buffer(zero):
    """Each rank holds its half of the fp32 masters: one dtype group, its
    rows padded to 64 x 2, a shard of whole 64-row blocks."""
    a, b = (o["zero_adam_predivide"]["master"] for o in zero["outs"])
    assert len(a) == 1 and a[0].shape == b[0].shape
    rows = a[0].shape[0]
    assert rows % 64 == 0 and a[0].shape[1] == 1024
    live = sum(-(-int(np.prod(s)) // 1024) for s in SHAPES.values())
    assert 2 * rows == -(-live // 128) * 128


def test_wires_against_fp32(zero):
    """bf16: bf16(master) to one fp32 ulp of the fp32 wire's params,
    rounded; e5m2 within its rounding (JAX's tests' bounds); the two
    ranks bit-equal on every wire."""
    for kind in ("adam", "lamb"):
        f32 = zero["outs"][0][f"zero_{kind}" + (
            "_predivide" if kind == "adam" else "")]["params"]
        bf = zero["outs"][0][f"zero_{kind}_bf16"]["params"]
        e5 = zero["outs"][0][f"zero_{kind}_e5m2"]["params"]
        for k in SHAPES:
            if kind == "adam":
                np.testing.assert_allclose(
                    bf[k].numpy(), f32[k].bfloat16().float().numpy(),
                    rtol=3e-7, atol=1e-9)
            else:
                np.testing.assert_allclose(bf[k].numpy(), f32[k].numpy(),
                                           rtol=2 ** -8, atol=2e-6)
            np.testing.assert_allclose(e5[k].numpy(), f32[k].numpy(),
                                       rtol=2 ** -2, atol=1e-4)


def test_e5m2_wire_saturates(zero):
    """Masters past e5m2's finite range land at its max (57344), not at
    inf (tests/L0/test_distributed_optimizers.py:284)."""
    for o in zero["outs"]:
        w = o["e5m2_saturation"]
        assert torch.isfinite(w).all()
        np.testing.assert_allclose(w.numpy(), 57344.0, rtol=1e-6)


def test_e5m2_bits_match_jax():
    """The wire's cast: clip to +-57344, then torch's float8_e5m2 cast,
    bit for bit JAX's ``clip(...).astype(float8_e5m2)`` over values
    around every rounding boundary, the range's edge and beyond."""
    rng = np.random.default_rng(9)
    x = np.concatenate([rng.standard_normal(4096) * 10.0 ** rng.integers(
        -8, 6, 4096), [0.0, -0.0, 57343.0, 57344.0, 60000.0, 61440.0, 1e9,
                       -1e9, 1.5e-5, 6.1e-5]]).astype(np.float32)
    fin = float(jnp.finfo(jnp.float8_e5m2).max)
    want = np.asarray(jnp.clip(jnp.asarray(x), -fin, fin).astype(
        jnp.float8_e5m2)).view(np.uint8)
    got = torch.clamp(torch.from_numpy(x), -fin, fin).to(
        torch.float8_e5m2).view(torch.uint8).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("kind", ("adam", "lamb"))
def test_overflow_round_trip(zero, kind):
    """Step 1's inf on rank 1 alone: both ranks report found_inf [False,
    True, False] as JAX's; the skipped step leaves params, masters,
    moments and count bit for bit as step 0 left them and moves no
    gather; the end state against JAX's."""
    jp, jflags, jcount = zero["want"][f"overflow_{kind}"]
    assert [bool(f) for f in np.asarray(jflags)] == [False, True, False]
    for o in zero["outs"]:
        run = o[f"overflow_{kind}"]
        assert run["flags"] == [False, True, False]
        s0, s1, s2 = run["states"]
        assert s2["count"] == int(jcount) == R.ZERO_STEPS - 1
        for k in SHAPES:
            assert torch.equal(s0["params"][k], s1["params"][k]), k
            np.testing.assert_allclose(s2["params"][k].numpy(),
                                       np.asarray(jp[k]), err_msg=k, **TOL)
        for name in ("master", "m", "v"):
            assert all(torch.equal(a, b) for a, b in zip(s0[name],
                                                         s1[name])), name
        ex = [zero_exchanges(kind, probe=True, skipped=t == R.OVERFLOW_STEP)
              for t in range(R.ZERO_STEPS)]
        assert run["exchanges"] == ex
    a, b = (o[f"overflow_{kind}"]["states"][-1] for o in zero["outs"])
    for k in SHAPES:
        assert torch.equal(a["params"][k], b["params"][k])


def test_adam_overflow_masters_equal_replicated_packed_adam(zero):
    """The ZeRO Adam under the scaler equals the port's replicated packed
    Adam on the rank-order mean gradients bit for bit (the same kernel
    on the same sums), the skip included (__graft_entry__.py part H)."""
    want = zero["outs"][0]["overflow_replicated"]
    got = zero["outs"][0]["overflow_adam"]["states"][-1]
    assert want["count"] == got["count"]
    for k in SHAPES:
        assert torch.equal(got["params"][k], want["params"][k]), k


def test_refusals_and_facades():
    """JAX's refusals (an unknown wire, int8 comm with a low wire,
    AMSGrad), and the class facades' hyperparameters."""
    with pytest.raises(ValueError, match="allgather_dtype"):
        distributed_fused_adam(1e-2, allgather_dtype="fp8")
    with pytest.raises(ValueError, match="already compresses"):
        distributed_fused_adam(1e-2, allgather_dtype="bf16",
                               comm_dtype="int8")
    with pytest.raises(ValueError, match="comm_dtype"):
        distributed_fused_adam(1e-2, comm_dtype="fp8")
    for cls in (DistributedFusedAdam, DistributedFusedLAMB):
        with pytest.raises(RuntimeError, match="AMSGrad"):
            cls(amsgrad=True)
        assert callable(cls().update)
