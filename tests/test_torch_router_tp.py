"""The replica router over tp=2 engines against the JAX package, on the
CPU.

Two ranks of a gloo group (spawned once for the module,
`_torch_tp_ranks.run`'s ``"router"`` suite, 60 s timeouts) each build the
same fleet: a `ReplicaRouter` over two tp=2 engines of the tiny fp32 GPT
(JAX tests/L0/test_disagg.py's shapes: vocab 96, hidden 32, 2 layers, 4
heads; 2 slots, capacity 24, budget 4, pages of 4), on weights sliced
from one tp=1 tree of std 0.3 (so greedy tokens vary), and make the
same calls. Held against a JAX `ReplicaRouter` over two JAX tp=2
engines (two devices of the conftest's host mesh) and the port's tp=1
fleet here, on float and int8 pages: the tokens; a rolling drain of
replica 0 whose payloads ship to replica 1 (each rank's heads its own
pool's bits, both ranks' payloads the same bits, the layout and values
of the tp=1 fleet's payload, within 1e-6 of its scale, one int8 step on
int8 pools); a `replica_kill` and a `replica_stall` that quarantine
replica 0 at the same tick on both ranks; one trace id per request, the
same on both ranks.

The clock: a request with a deadline, with rank 1 reaching the step
1 s after rank 0, past the deadline on its own clock and not on rank
0's. An engine and a router at tp=2 take tensor rank 0's clock on such
ticks, so both ranks expire the request at the same tick and the rest
of the serve runs alike. (Without it, rank 1 expired the request a tick
before rank 0, the ranks stepped different batches and their exchanges
no longer matched: ROADMAP Queue 3.)
"""

import jax
import jax.numpy as jnp
import pytest
import torch

import _torch_tp_ranks as R
from rocm_apex_tpu.inference import InferenceEngine as JaxEngine
from rocm_apex_tpu.inference import ReplicaRouter as JaxRouter
from rocm_apex_tpu.inference import SamplingParams as JaxSamplingParams
from rocm_apex_tpu.inference import shard_tp1_params as jax_shard_tp1_params
from rocm_apex_tpu.models.gpt import GPTConfig as JaxGPTConfig
from rocm_apex_tpu.models.gpt import GPTModel as JaxGPTModel
from rocm_apex_tpu.transformer import parallel_state as jax_parallel_state
from rocm_apex_tpu_torch.convert import (
    flatten_params,
    from_jax_params,
    random_params,
)
from rocm_apex_tpu_torch.inference import InferenceEngine, ReplicaRouter

TP = 2
FORMS = {"float": {}, "int8": dict(kv_dtype=torch.int8)}
PAYLOAD_RTOL = 1e-6


def _jax_fleet_tokens(tree):
    """A JAX router over two JAX tp=2 engines (the second adopting the
    first's step programs), on each page form."""
    devs = jax.devices()
    if len(devs) < TP:
        pytest.skip(f"needs {TP} simulated devices")
    mesh = jax_parallel_state.initialize_model_parallel(TP, 1,
                                                        devices=devs[:TP])
    try:
        model = JaxGPTModel(JaxGPTConfig(
            **R.GPT_SHAPE, tensor_parallel_size=TP, hidden_dropout=0.0,
            attention_dropout=0.0, params_dtype=jnp.float32,
            dtype=jnp.float32))
        params = jax_shard_tp1_params(
            model, jax.tree_util.tree_map(jnp.asarray, tree), mesh)
        out = {}
        for form, kw in FORMS.items():
            kw = {**R.ENGINE, **({"kv_dtype": jnp.int8} if kw else {}),
                  "sampling": JaxSamplingParams(temperature=0.0), "seed": 0}
            e0 = JaxEngine(model, params, **kw)
            e1 = JaxEngine(model, params, step_source=e0, **kw)
            res = JaxRouter(engines=[e0, e1]).generate(
                R.PROMPTS, max_new_tokens=R.MAX_NEW)
            out[form] = [(r.tokens, r.finish_reason) for r in res]
        return out
    finally:
        jax_parallel_state.destroy_model_parallel()


@pytest.fixture(scope="module")
def fleet(tmp_path_factory):
    tree = random_params(R.gpt_config(1, init_method_std=0.3), seed=1)
    inputs = {f"p.{k}": v for k, v in flatten_params(tree["params"]).items()}
    jax_tokens = _jax_fleet_tokens(tree)
    outs = R.spawn(tmp_path_factory.mktemp("router_tp"), "router", inputs)
    tp1 = from_jax_params(tree, R.gpt_config(1), device="cpu")
    ref = {}
    for form, kw in FORMS.items():
        ref[f"{form}_tokens"] = R._fleet_tokens(ReplicaRouter(
            engines=R._router_engines(tp1, **kw)))
        ref[f"{form}_drain"] = R._drain_run(tp1, 0, **kw)
    return dict(outs=outs, jax=jax_tokens, ref=ref, tp1=tp1)


@pytest.mark.parametrize("form", list(FORMS))
def test_fleet_tokens_match_jax_router_and_tp1_fleet(fleet, form):
    """Both ranks' fleet tokens equal the JAX router's over tp=2 engines
    and the port's tp=1 fleet's; the prompts give varied tokens."""
    want = fleet["jax"][form]
    assert len({t for toks, _ in want for t in toks}) > 3
    assert fleet["ref"][f"{form}_tokens"] == want
    for o in fleet["outs"]:
        assert o[f"{form}_tokens"] == want


@pytest.mark.parametrize("form", list(FORMS))
def test_drain_ships_pages_bit_equal_per_rank(fleet, form):
    """`drain_replica(0)` mid-serve: every payload's heads of a rank are
    its pool's blocks bit for bit, both ranks' payloads hold the same
    bits, and they carry every head, as the tp=1 fleet's payload (layer
    0 bit for bit, later layers within 1e-6 of their scale, one step on
    int8 pools: the row-parallel sums add two partial products); the
    migrated requests finish with the undisturbed fleet's tokens and
    free every page."""
    d0, d1 = (o[f"{form}_drain"] for o in fleet["outs"])
    ref = fleet["ref"][f"{form}_drain"]
    assert d0["payloads"] and set(d0["payloads"]) == set(ref["payloads"])
    for d in (d0, d1):
        assert d["own_blocks_equal"]
        assert d["tokens"] == fleet["jax"][form]
        assert d["page_migrations"] >= 1
        assert d["pages_used"] == [0, 0]
    for rid, p0 in d0["payloads"].items():
        p1, pref = d1["payloads"][rid], ref["payloads"][rid]
        assert {k: v for k, v in p0.items() if not isinstance(v, list)} == \
            {k: v for k, v in pref.items() if not isinstance(v, list)}
        for key in ("k", "v", "k_scale", "v_scale"):
            for layer, (a, b, c) in enumerate(zip(
                    p0.get(key, ()), p1.get(key, ()), pref.get(key, ()))):
                assert torch.equal(a, b), (rid, key, layer)
                assert a.shape == c.shape and a.dtype == c.dtype
                if layer == 0:
                    assert torch.equal(a, c), (rid, key)
                elif a.dtype == torch.int8:
                    assert (a.int() - c.int()).abs().max() <= 1
                else:
                    assert float((a - c).abs().max()) <= PAYLOAD_RTOL * float(
                        c.abs().max()), (rid, key, layer)


@pytest.mark.parametrize("site", ["kill", "stall"])
def test_injected_fault_quarantines_at_the_same_tick(fleet, site):
    """A `replica_kill` (at fleet tick 2) or `replica_stall` (from tick
    1, caught by the zero-progress probe) of replica 0: both ranks log
    the fault at the same tick, quarantine replica 0 at the same tick
    and migrate the same requests, whose tokens equal the undisturbed
    fleet's."""
    r0, r1 = (o[site] for o in fleet["outs"])
    assert r0 == r1
    assert r0["replica_quarantines"] >= 1
    tick = R.KILL_TICK if site == "kill" else R.STALL_TICK
    assert r0["fault_log"][0][1:] == (tick, 0)
    first = r0["states"].index(("quarantined", "up"))
    if site == "kill":
        assert first == R.KILL_TICK and r0["replica_kills"] == 1
    assert r0["tokens"] == fleet["jax"]["float"]


@pytest.mark.parametrize("target", ["engine", "router"])
def test_deadline_decided_on_rank_0s_clock(fleet, target):
    """The ranks' clocks disagree about a deadline (rank 1 arrives after
    it): both ranks expire the request at the same tick with the same
    result, and the other request runs to its length."""
    c0, c1 = (o[f"clock_{target}"] for o in fleet["outs"])
    assert c0 == c1
    (toks0, why0), (toks1, why1) = c0["results"]
    assert why0 == "deadline" and why1 == "length"
    assert len(toks1) == R.MAX_NEW


@pytest.mark.parametrize("target", ["engine", "router"])
def test_clock_exchanged_only_while_a_deadline_is_live(fleet, target):
    """Ticks take rank 0's clock through an exchange while the
    time-bounded request is queued or in flight, and exchange no clock
    once it has expired, though the other request runs on."""
    c = fleet["outs"][0][f"clock_{target}"]
    at, ex = c["expired_at"], c["clock_exchanges"]
    assert at < c["ticks"] - 1
    assert all(n >= 1 for n in ex[:at + 1])
    assert ex[at + 1:] == [0] * (c["ticks"] - at - 1)


def test_trace_ids_are_the_same_on_every_rank(fleet):
    ids = [o["router_trace_ids"] for o in fleet["outs"]]
    assert ids[0] == ids[1]
    assert len(set(ids[0])) == len(R.PROMPTS)
    assert [o["router_ids"] for o in fleet["outs"]] == [[0, 1, 2]] * TP


def test_replicas_share_one_tensor_group():
    """Replicas over different tensor axes (or sizes) refuse to form a
    fleet: its clock and trace ids ride one group."""
    tree = random_params(R.gpt_config(1), seed=1)
    a = from_jax_params(tree, R.gpt_config(1), device="cpu")
    b = from_jax_params(tree, R.gpt_config(1, tensor_axis="other"),
                        device="cpu")
    engines = [InferenceEngine(m, **R.ENGINE) for m in (a, b)]
    with pytest.raises(ValueError, match="share one tensor group"):
        ReplicaRouter(engines=engines)
