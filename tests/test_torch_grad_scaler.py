"""The port's transformer `GradScaler` and `sync_found_inf` against the
JAX package's, on the CPU.

Checked: the constructor's checks, raised where JAX raises; the scaler
with no axis bound against JAX's outside any mesh (an unbound axis is
skipped on both sides); two gloo ranks bound to "tensor" (spawned once,
`_torch_scaler_ranks.run`, a file-store rendezvous under the test's
temporary directory, 60 s timeouts), where rank 1 alone overflows at one
step: both ranks skip that step and back off, and each rank's scale,
window count, overflow count and skip at every step equal JAX's
`GradScaler` inside ``shard_map`` over a "tensor" axis of two host
devices on the same flags. The scaler's arithmetic is powers of two, so
the states are compared exactly.
"""

import multiprocessing

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.shard_map import shard_map
from jax.sharding import Mesh, PartitionSpec as P

import _torch_scaler_ranks
from rocm_apex_tpu.transformer.amp import GradScaler as JGradScaler
from rocm_apex_tpu.transformer.amp import sync_found_inf as jsync
from rocm_apex_tpu_torch.transformer import parallel_state
from rocm_apex_tpu_torch.transformer.amp import GradScaler, sync_found_inf

RANKS = 2
# rank 1 overflows at step 1 alone; the window of 2 grows the scale at
# step 3
FLAGS = [[False, False, False, False, True],
         [False, True, False, False, False]]
SCALER = dict(init_scale=2.0 ** 10, growth_interval=2)
JOIN_S = 120


@pytest.mark.parametrize("kw", [dict(growth_factor=1.0),
                                dict(backoff_factor=1.0),
                                dict(backoff_factor=0.0),
                                dict(growth_factor=4.0, backoff_factor=0.5)])
def test_constructor_checks_match_jax(kw):
    with pytest.raises(ValueError) as want:
        JGradScaler(**kw)
    with pytest.raises(ValueError) as got:
        GradScaler(**kw)
    assert str(got.value) == str(want.value)


def test_defaults_and_disabled_match_jax():
    for kw in (dict(), dict(enabled=False), dict(growth_factor=4.0,
                                                 backoff_factor=0.25)):
        j, t = JGradScaler(**kw), GradScaler(**kw)
        assert t.dynamic == j.dynamic
        assert float(t.init().loss_scale) == float(j.init().loss_scale)
        assert t.axis_names == j.axis_names == ("tensor", "pipe")
    assert parallel_state.TENSOR_AXIS == "tensor"
    assert parallel_state.PIPE_AXIS == "pipe"


def _state_tuple(s):
    return tuple(float(x) for x in s)


def test_unbound_axes_are_skipped():
    """No group bound: the flag passes through, and the scaler steps as
    JAX's does outside a mesh."""
    parallel_state.clear_axis_groups()
    assert bool(sync_found_inf(torch.tensor(True)))
    assert not bool(sync_found_inf(False))
    assert bool(jsync(jnp.asarray(True)))
    t, j = GradScaler(**SCALER), JGradScaler(**SCALER)
    ts, js = t.init(), j.init()
    for flag in FLAGS[1] + FLAGS[0]:
        ts, tskip = t.update(ts, torch.tensor(flag))
        js, jskip = j.update(js, jnp.asarray(flag))
        assert _state_tuple(ts) == _state_tuple(js)
        assert bool(tskip) == bool(jskip) == flag


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    workdir = tmp_path_factory.mktemp("scaler")
    ctx = multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=_torch_scaler_ranks.run,
                         args=(r, RANKS, str(workdir), FLAGS, SCALER))
             for r in range(RANKS)]
    for p in procs:
        p.start()
    for p in procs:
        p.join(JOIN_S)
    hung = [r for r, p in enumerate(procs) if p.is_alive()]
    for p in procs:
        if p.is_alive():
            p.terminate()
            p.join(10)
    assert not hung, f"ranks {hung} did not finish in {JOIN_S} s"
    assert all(p.exitcode == 0 for p in procs), [p.exitcode for p in procs]
    return [torch.load(workdir / f"rank{r}.pt", weights_only=False)
            for r in range(RANKS)]


@pytest.fixture(scope="module")
def jax_run():
    """JAX's GradScaler inside shard_map over a "tensor" axis of two
    devices, each device with its rank's flag: per step and rank, the
    state and the skip."""
    mesh = Mesh(np.array(jax.devices()[:RANKS]), ("tensor",))
    scaler = JGradScaler(**SCALER)

    def local(state, flag):
        state, skip = scaler.update(state, flag[0])
        return tuple(x[None] for x in state), skip[None]

    step = jax.jit(shard_map(local, mesh=mesh, in_specs=(P(), P("tensor")),
                             out_specs=(P("tensor"), P("tensor")),
                             check_rep=False))
    state = scaler.init()
    states, skips = [], []
    for i in range(len(FLAGS[0])):
        flags = jnp.asarray([FLAGS[r][i] for r in range(RANKS)])
        per_rank, skip = step(state, flags)
        states.append([tuple(float(x[r]) for x in per_rank)
                       for r in range(RANKS)])
        skips.append([bool(skip[r]) for r in range(RANKS)])
        state = type(state)(*(x[0] for x in per_rank))
    return states, skips


@pytest.mark.parametrize("rank", range(RANKS))
def test_two_ranks_sync_overflow_like_jax(ranks, jax_run, rank):
    states, skips = jax_run
    out = ranks[rank]
    want_skip = [any(FLAGS[r][i] for r in range(RANKS))
                 for i in range(len(FLAGS[0]))]
    assert out["synced"] == want_skip
    assert out["skips"] == want_skip == [s[rank] for s in skips]
    assert out["states"] == [s[rank] for s in states]
    assert out["alone"] == FLAGS[rank]
    # the overflow backed the scale off on both ranks, then the window
    # grew it back: 2^10 -> 2^9 -> 2^10 -> 2^9
    assert [s[0] for s in out["states"]] == [1024.0, 512.0, 512.0, 1024.0,
                                             512.0]
