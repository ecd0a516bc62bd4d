"""The port's paged KV cache against the JAX package, on the CPU.

Host bookkeeping (`PageAllocator`, `PrefixStore`) is driven call for
call beside the JAX classes; the device primitives (`ops.paging`) and
`PagedKVCache` writes must leave bit-identical pools and scales, drops
included; the paged decode read's plain version and the chunk read are
held against the JAX functions, whose Pallas kernels run in interpret
mode here, at tolerance 1e-5 (fp32 on both sides, summation order
differs; int8 pools dequantize the same way on both); and the cached
GPT steps through a paged cache against the JAX model's.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rocm_apex_tpu.inference import PageAllocator as JaxPageAllocator
from rocm_apex_tpu.inference import PagedKVCache as JaxPagedKVCache
from rocm_apex_tpu.inference import PrefixStore as JaxPrefixStore
from rocm_apex_tpu.models.gpt import GPTConfig as JaxGPTConfig
from rocm_apex_tpu.models.gpt import GPTModel as JaxGPTModel
from rocm_apex_tpu.ops import paging as jpaging
from rocm_apex_tpu.ops.flash_attention import (
    flash_attention_decode_paged as jax_decode_paged,
)
from rocm_apex_tpu.ops.flash_attention_segments import (
    flash_attention_chunk_paged as jax_chunk_paged,
)
from rocm_apex_tpu_torch.convert import from_jax_params, random_params
from rocm_apex_tpu_torch.inference import (
    PageAllocator,
    PagedKVCache,
    PrefixStore,
)
from rocm_apex_tpu_torch.models.gpt import GPTConfig
from rocm_apex_tpu_torch.ops import paging
from rocm_apex_tpu_torch.ops.flash_attention import (
    flash_attention_decode_paged,
    flash_attention_decode_paged_plain,
)
from rocm_apex_tpu_torch.ops.flash_attention_segments import (
    flash_attention_chunk_paged,
)

ATTN_TOL = dict(rtol=1e-5, atol=1e-5)
LOGIT_TOL = dict(rtol=1e-4, atol=1e-4)


def _t(a):
    return torch.from_numpy(np.array(a))


def _j(a):
    return jnp.asarray(np.array(a))


# ---------------------------------------------------------------------------
# host bookkeeping, call for call
# ---------------------------------------------------------------------------


def _call(obj, name, *args, **kw):
    try:
        return ("ok", getattr(obj, name)(*args, **kw))
    except (ValueError, RuntimeError) as e:
        return (type(e).__name__, str(e))


@pytest.mark.parametrize("seed", [0, 1])
def test_allocator_matches_jax_call_for_call(seed):
    """A random program of alloc/ref/decref(park)/refcount, errors
    included, with ``on_evict`` firing on parked-page reclaims: the same
    results, snapshots and evictions as the JAX allocator, and the
    invariants hold after every call."""
    rng = np.random.default_rng(seed)
    pair = (JaxPageAllocator(6), PageAllocator(6))
    evicted = ([], [])
    for a, ev in zip(pair, evicted):
        a.on_evict = ev.append
    for _ in range(300):
        op = int(rng.integers(0, 4))
        page = int(rng.integers(0, 6))
        args = {
            0: ("alloc", (int(rng.integers(0, 4)),), {}),
            1: ("ref", (page,), {}),
            2: ("decref", (page,), {"park": bool(rng.integers(0, 2))}),
            3: ("refcount", (page,), {}),
        }[op]
        got = [(_call(a, args[0], *args[1], **args[2]), a.snapshot(),
                a.pages_used, a.available) for a in pair]
        assert got[0] == got[1]
        pair[1].assert_consistent()
    assert evicted[0] == evicted[1]
    assert evicted[1], "the program never reclaimed a parked page"


def test_prefix_store_matches_jax_call_for_call():
    """Chains registered from random prompts over a 3-token alphabet
    (so prompts share prefixes), matches with full and partial pages,
    and unregisters that cascade to orphans: the same keys, matches,
    registrations and sizes as the JAX store."""
    rng = np.random.default_rng(2)
    ps = 3
    pair = (JaxPrefixStore(ps), PrefixStore(ps))
    next_page = 0
    for _ in range(120):
        op = int(rng.integers(0, 3))
        prompt = rng.integers(0, 3, int(rng.integers(1, 12))).tolist()
        if op == 0:  # register the prompt's full pages as one chain
            keys = [None, None]
            for i in range(len(prompt) // ps):
                toks = prompt[i * ps:(i + 1) * ps]
                keys = [s.register(k, toks, next_page)
                        for s, k in zip(pair, keys)]
                assert keys[0] == keys[1]
                assert pair[1].chain_key(keys[1], toks) == pair[0].chain_key(
                    keys[0], toks)
                next_page += 1
        elif op == 1:
            want, got = pair[0].match(prompt), pair[1].match(prompt)
            # the JAX store breaks a tie between partial borrows by set
            # order; the port takes the oldest page. Both borrow a page
            # that holds the matched tokens.
            assert got[1:] == want[1:]
            full = len(got[0]) - (1 if got[2] else 0)
            assert got[0][:full] == want[0][:full]
            assert len(got[0]) == len(want[0])
            if got[2]:
                m, part = got[1], got[2]
                for store, pages in zip(pair[::-1], (got[0], want[0])):
                    entry = store._by_page[pages[-1]]
                    assert list(entry.tokens[:part]) == prompt[m - part:m]
        else:
            page = int(rng.integers(0, max(next_page, 1)))
            for s in pair:
                s.unregister_page(page)
        assert len(pair[0]) == len(pair[1])
        assert all(pair[0].is_registered(p) == pair[1].is_registered(p)
                   for p in range(next_page))
    with pytest.raises(ValueError, match="page_size"):
        pair[1].register(None, [1], 0)


# ---------------------------------------------------------------------------
# device primitives and PagedKVCache writes, bit for bit
# ---------------------------------------------------------------------------


def _caches(num_layers, num_slots, capacity, heads, hd, page_size,
            num_pages=None, quantized=False):
    j = JaxPagedKVCache.create(num_layers, num_slots, capacity, heads, hd,
                               page_size=page_size, num_pages=num_pages,
                               dtype=jnp.float32, quantized=quantized)
    t = PagedKVCache.create(num_layers, num_slots, capacity, heads, hd,
                            page_size=page_size, num_pages=num_pages,
                            dtype=torch.float32, quantized=quantized,
                            device="cpu")
    return j, t


def _set_table(j, t, table, lengths=None):
    table = np.asarray(table, np.int32)
    j = j.replace(page_table=jnp.asarray(table))
    t.page_table = torch.from_numpy(table.copy())
    if lengths is not None:
        j = j.replace(lengths=jnp.asarray(np.asarray(lengths, np.int32)))
        t.lengths = torch.from_numpy(np.asarray(lengths, np.int32))
    return j, t


def _assert_same(j, t):
    for jb, tb in zip(j.k + j.v, t.k + t.v):
        np.testing.assert_array_equal(tb.numpy(), np.asarray(jb))
    if j.quantized:
        for jb, tb in zip(j.k_scale + j.v_scale, t.k_scale + t.v_scale):
            np.testing.assert_array_equal(tb.numpy(), np.asarray(jb))
    np.testing.assert_array_equal(t.lengths.numpy(), np.asarray(j.lengths))


@pytest.mark.parametrize("page_size", [4, 5])
def test_float_writes_and_views_match_jax_bit_for_bit(page_size):
    """`write` at lengths (one slot at the device capacity drops) and
    `write_at` with a pad slot, a past-capacity position and a token on
    an unmapped entry (all three dropped), then `fork_page`,
    `paged_view` and the free functions on the same inputs: identical
    pools, and the dropped rows land nowhere."""
    rng = np.random.default_rng(page_size)
    j, t = _caches(2, 3, 12, 2, 4, page_size, num_pages=9)
    P = t.pages_per_slot
    table = np.full((3, P), 9, np.int32)
    table[0, :P] = np.arange(P)
    table[1, :2] = [P, P + 1]  # the rest unmapped
    cap = t.capacity
    j, t = _set_table(j, t, table, lengths=[3, 2 * page_size - 1, cap])
    new = rng.standard_normal((3, 1, 2, 4)).astype(np.float32)
    j = j.write(1, _j(new), _j(2 * new))
    assert t.write(1, _t(new), _t(2 * new)) is t
    _assert_same(j, t)
    assert float(t.k[1][table[0, 0], :, 3].abs().sum()) > 0
    slots = np.array([0, 3, 1, 0, 1], np.int32)  # 3: pad
    pos = np.array([cap - 1, 0, 2 * page_size, cap, 1], np.int32)
    chunk = rng.standard_normal((5, 2, 4)).astype(np.float32)
    j = j.write_at(0, _j(slots), _j(pos), _j(chunk), _j(-chunk))
    t.write_at(0, _t(slots), _t(pos), _t(chunk), _t(-chunk))
    _assert_same(j, t)
    # three rows landed: (0, cap-1), (1, 1) and the decode rows; the pad,
    # the position past capacity and the unmapped entry dropped
    assert int((t.k[0].abs().sum(dim=(1, 3)) > 0).sum()) == 2
    j = j.fork_page(jnp.int32(table[0, 0]), jnp.int32(8))
    t.fork_page(int(table[0, 0]), 8)
    _assert_same(j, t)
    for jb, tb in zip(j.k, t.k):
        np.testing.assert_array_equal(
            paging.paged_view(tb, t.page_table).numpy(),
            np.asarray(jpaging.paged_view(jb, j.page_table)),
        )
    pool = rng.standard_normal((9, 2, page_size, 4)).astype(np.float32)
    x = rng.standard_normal((5, 2, 4)).astype(np.float32)
    want = jpaging.paged_scatter(_j(pool), _j(table), _j(slots), _j(pos),
                                 _j(x))
    got = paging.paged_scatter(_t(pool), _t(table), _t(slots), _t(pos),
                               _t(x))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    pages, offs = paging.paged_destinations(_t(table), _t(slots), _t(pos),
                                            page_size, 9)
    jpages, joffs = jpaging.paged_destinations(_j(table), _j(slots),
                                               _j(pos), page_size, 9)
    np.testing.assert_array_equal(pages.numpy(), np.asarray(jpages))
    np.testing.assert_array_equal(offs.numpy(), np.asarray(joffs))
    np.testing.assert_array_equal(
        paging.paged_fork(_t(pool), 2, 5).numpy(),
        np.asarray(jpaging.paged_fork(_j(pool), 2, 5)),
    )


def test_int8_writes_match_jax_bit_for_bit():
    """int8 pools: a first write sets the page scales, a second write
    ten times larger into the same pages RAISES them and requantizes the
    rows already there; a third, smaller, leaves the scales alone. Bytes
    and scales equal the JAX package's exactly (both round half to even
    and divide in IEEE fp32), and the dequantized view of each step is
    within 1.5 quantization steps of the written values."""
    rng = np.random.default_rng(11)
    j, t = _caches(1, 2, 8, 2, 4, 4, num_pages=5, quantized=True)
    table = np.array([[0, 1], [3, 5]], np.int32)  # slot 1: one unmapped
    j, t = _set_table(j, t, table, lengths=[0, 2])
    x1 = rng.standard_normal((2, 2, 2, 4)).astype(np.float32)
    scales = []
    for scale_by, lengths in ((1.0, [0, 2]), (10.0, [2, 2]), (0.1, [4, 6])):
        x = x1 * scale_by
        j, t = _set_table(j, t, table, lengths)
        j = j.write(0, _j(x), _j(-x))
        t.write(0, _t(x), _t(-x))
        _assert_same(j, t)
        scales.append(t.k_scale[0][table[0, 0]].clone())
    assert torch.all(scales[1] > scales[0]) and torch.equal(scales[2],
                                                            scales[1])
    view = paging.paged_view(t.k[0], t.page_table, t.k_scale[0])
    step = t.k_scale[0][table[0, 0]].max()
    np.testing.assert_allclose(view[0, 2:4].numpy(), 10 * x1[0],
                               atol=float(1.5 * step))
    np.testing.assert_array_equal(
        view.numpy(),
        np.asarray(jpaging.paged_view(j.k[0], j.page_table, j.k_scale[0])),
    )
    # the free function, with a drop, on its own inputs
    pool = rng.integers(-127, 128, (5, 2, 4, 4)).astype(np.int8)
    scale = np.abs(rng.standard_normal((5, 2))).astype(np.float32) * 0.01
    slots = np.array([0, 0, 1, 2], np.int32)
    pos = np.array([1, 5, 3, 0], np.int32)
    x = 3.0 * rng.standard_normal((4, 2, 4)).astype(np.float32)
    jp, js = jpaging.quantized_paged_scatter(_j(pool), _j(scale), _j(table),
                                             _j(slots), _j(pos), _j(x))
    tp, ts = paging.quantized_paged_scatter(_t(pool), _t(scale), _t(table),
                                            _t(slots), _t(pos), _t(x))
    np.testing.assert_array_equal(tp.numpy(), np.asarray(jp))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    assert np.any(ts.numpy() > scale)


def test_cache_shapes_capacity_and_bytes():
    cfg = GPTConfig(vocab_size=96, hidden_size=32, num_layers=2,
                    num_attention_heads=4, max_position_embeddings=32,
                    params_dtype=torch.float32, dtype=torch.float32)
    c = PagedKVCache.for_model(cfg, 2, 24, page_size=5, device="cpu")
    jc = JaxPagedKVCache.for_model(
        JaxGPTConfig(vocab_size=96, hidden_size=32, num_layers=2,
                     num_attention_heads=4, max_position_embeddings=32,
                     tensor_parallel_size=1, dtype=jnp.float32),
        2, 24, page_size=5,
    )
    assert (c.pages_per_slot, c.capacity, c.num_pages) == (5, 25, 10)
    assert tuple(c.k[0].shape) == tuple(jc.k[0].shape)
    assert c.cache_bytes() == jc.cache_bytes()
    assert int(c.page_table.min()) == c.num_pages
    q8 = PagedKVCache.for_model(cfg, 2, 24, page_size=4, quantized=True,
                                device="cpu")
    bf = PagedKVCache.for_model(cfg, 2, 24, page_size=4,
                                dtype=torch.bfloat16, device="cpu")
    assert q8.k[0].dtype == torch.int8 and q8.quantized
    assert q8.cache_bytes() < 0.6 * bf.cache_bytes()
    c.lengths = torch.tensor([24, 3], dtype=torch.int32)
    c.advance(2, torch.tensor([True, False]))
    assert c.lengths.tolist() == [25, 3]
    assert c.reset_slot(0).lengths.tolist() == [0, 3]


# ---------------------------------------------------------------------------
# the paged decode read and the chunk read against the JAX kernels
# ---------------------------------------------------------------------------


def _paged_inputs(rng, page_size, quantized, num_slots=3, heads=2, hd=16,
                  pages_per_slot=4):
    """Pools, scales and a table: slot 0 holds 3 pages, slot 1 one page,
    slot 2 two pages and two unmapped (sentinel) entries."""
    num_pages = 8
    shape = (num_pages, heads, page_size, hd)
    if quantized:
        k = rng.integers(-127, 128, shape).astype(np.int8)
        v = rng.integers(-127, 128, shape).astype(np.int8)
        ks = (0.02 * (1 + rng.random((num_pages, heads)))).astype(np.float32)
        vs = (0.02 * (1 + rng.random((num_pages, heads)))).astype(np.float32)
    else:
        k = rng.standard_normal(shape).astype(np.float32)
        v = rng.standard_normal(shape).astype(np.float32)
        ks = vs = None
    table = np.full((num_slots, pages_per_slot), num_pages, np.int32)
    table[0, :3] = [5, 0, 7]
    table[1, :1] = [2]
    table[2, :2] = [4, 1]
    return k, v, ks, vs, table


@pytest.mark.parametrize("quantized", [False, True])
@pytest.mark.parametrize("page_size", [4, 5])
def test_decode_paged_matches_jax(page_size, quantized):
    """The decode grid: a prefix ending mid-page, an empty slot, and a
    dead row whose bound (the device capacity) reaches the sentinel
    entries; o and lse against the JAX kernel."""
    rng = np.random.default_rng(page_size + 10 * quantized)
    k, v, ks, vs, table = _paged_inputs(rng, page_size, quantized)
    heads, hd = k.shape[1], k.shape[3]
    cap = table.shape[1] * page_size
    lengths = np.array([2 * page_size + 1, 0, cap], np.int32)
    q = rng.standard_normal((3, heads, hd)).astype(np.float32)
    scale = 0.3
    jo, jlse = jax_decode_paged(
        _j(q.reshape(3 * heads, 1, hd)), _j(k), _j(v), _j(table),
        _j(lengths), scale,
        k_scale=None if ks is None else _j(ks),
        v_scale=None if vs is None else _j(vs), return_lse=True,
    )
    o, lse = flash_attention_decode_paged(
        _t(q), _t(k), _t(v), _t(table), _t(lengths), scale,
        None if ks is None else _t(ks), None if vs is None else _t(vs),
        return_lse=True,
    )
    np.testing.assert_allclose(
        o.numpy(), np.asarray(jo).reshape(3, heads, hd), **ATTN_TOL)
    np.testing.assert_allclose(
        lse.numpy(), np.asarray(jlse).reshape(3, heads), **ATTN_TOL)
    assert np.all(o[1].numpy() == 0) and np.all(lse[1].numpy() == -1e30)
    # one slot per row: a row reads its own slot, pads read nothing
    ids = np.array([2, 0, 3, 2], np.int32)
    o2, lse2 = flash_attention_decode_paged_plain(
        _t(q[[2, 0, 0, 2]]), _t(k), _t(v), _t(table), _t(lengths), scale,
        None if ks is None else _t(ks), None if vs is None else _t(vs),
        _t(ids),
    )
    np.testing.assert_allclose(o2[0].numpy(), o[2].numpy(), **ATTN_TOL)
    np.testing.assert_allclose(o2[1].numpy(), o[0].numpy(), **ATTN_TOL)
    np.testing.assert_allclose(lse2[3].numpy(), lse[2].numpy(), **ATTN_TOL)
    assert np.all(o2[2].numpy() == 0)


@pytest.mark.parametrize("quantized", [False, True])
@pytest.mark.parametrize("page_size", [4, 5])
def test_chunk_paged_matches_jax(page_size, quantized):
    """A packed chunk of two slot pieces out of slot order and pads,
    against each slot's pre-chunk paged prefix: the real tokens' outputs
    agree with the JAX function (pads are never read)."""
    rng = np.random.default_rng(3 + page_size + 10 * quantized)
    k, v, ks, vs, table = _paged_inputs(rng, page_size, quantized)
    heads, hd = k.shape[1], k.shape[3]
    budget = 8
    seg = np.array([2, 2, 2, 0, 0, 3, 3, 3], np.int32)  # 3: pads
    lengths = np.array([page_size + 2, 3, 2 * page_size], np.int32)
    q, kc, vc = (rng.standard_normal((heads, budget, hd)).astype(np.float32)
                 for _ in range(3))
    scale = 0.25
    want = jax_chunk_paged(
        _j(q), _j(kc), _j(vc), _j(seg), _j(k), _j(v), _j(table),
        _j(lengths), scale, k_scale=None if ks is None else _j(ks),
        v_scale=None if vs is None else _j(vs),
    )
    got = flash_attention_chunk_paged(
        _t(q), _t(kc), _t(vc), _t(seg), _t(k), _t(v), _t(table),
        _t(lengths), scale, None if ks is None else _t(ks),
        None if vs is None else _t(vs),
    )
    assert got.dtype == torch.float32 and got.shape == (budget, heads, hd)
    np.testing.assert_allclose(got[:5].numpy(), np.asarray(want)[:5],
                               **ATTN_TOL)


# ---------------------------------------------------------------------------
# the cached GPT steps through a paged cache
# ---------------------------------------------------------------------------


SHAPE = dict(vocab_size=96, hidden_size=32, num_layers=2,
             num_attention_heads=4, max_position_embeddings=32,
             tensor_parallel_size=1)


@pytest.fixture(scope="module")
def models():
    tcfg = GPTConfig(**SHAPE, params_dtype=torch.float32, dtype=torch.float32)
    tree = random_params(tcfg, seed=3)
    jcfg = JaxGPTConfig(**SHAPE, hidden_dropout=0.0, attention_dropout=0.0,
                        params_dtype=jnp.float32, dtype=jnp.float32)
    return (jcfg, JaxGPTModel(jcfg), jax.tree_util.tree_map(jnp.asarray,
                                                           tree),
            tcfg, from_jax_params(tree, tcfg, device="cpu"))


@pytest.mark.parametrize("quantized", [False, True])
@pytest.mark.parametrize("page_size", [4, 5])
def test_chunk_then_decode_logits_match_jax(models, page_size, quantized):
    """Two packed chunks (pieces out of slot order, pads) and two decode
    steps, slot 1 idle in the second (a dead row at capacity): per-row
    logits agree with the JAX model's, the dead row's write drops, and
    the float pools agree."""
    jcfg, jmodel, jparams, tcfg, model = models
    jc = JaxPagedKVCache.for_model(jcfg, 2, 24, page_size=page_size,
                                   quantized=quantized)
    tc = PagedKVCache.for_model(tcfg, 2, 24, page_size=page_size,
                                quantized=quantized, device="cpu")
    table = np.full((2, tc.pages_per_slot), tc.num_pages, np.int32)
    table[0, :3] = [4, 1, 7]
    table[1, :2] = [0, 9]
    jc, tc = _set_table(jc, tc, table)
    rng = np.random.default_rng(page_size)
    p0 = rng.integers(0, 96, 9).tolist()
    p1 = rng.integers(0, 96, 6).tolist()
    lengths = np.zeros((2,), np.int32)
    for pieces in ([(1, p1[:4], 0), (0, p0[:3], 0)],
                   [(0, p0[3:9], 3), (1, p1[4:6], 4)]):
        toks = np.zeros((12,), np.int32)
        slots = np.full((12,), 2, np.int32)
        pos = np.zeros((12,), np.int32)
        at = 0
        for slot, tk, start in pieces:
            toks[at:at + len(tk)] = tk
            slots[at:at + len(tk)] = slot
            pos[at:at + len(tk)] = np.arange(start, start + len(tk))
            at += len(tk)
        jc, tc = _set_table(jc, tc, table, lengths)
        jlog, jc = jmodel.apply(jparams, _j(toks)[None], cache=jc,
                                chunk=(_j(slots), _j(pos)))
        tlog, tc = model(_t(toks)[None], cache=tc,
                         chunk=(_t(slots), _t(pos)))
        np.testing.assert_allclose(tlog[0, :at].numpy(),
                                   np.asarray(jlog)[0, :at], **LOGIT_TOL)
        for slot, tk, start in pieces:
            lengths[slot] = start + len(tk)
    for step, dead in ((0, None), (1, 1)):
        dec = np.array([[p0[step]], [p1[step]]], np.int32)
        run = lengths.copy()
        if dead is not None:
            run[dead] = tc.capacity
        jc, tc = _set_table(jc, tc, table, run)
        pools = [b.clone() for b in tc.k]
        jlog, jc = jmodel.apply(jparams, _j(dec), cache=jc)
        tlog, tc = model(_t(dec), cache=tc)
        live = [s for s in range(2) if s != dead]
        np.testing.assert_allclose(tlog[live].numpy(),
                                   np.asarray(jlog)[live], **LOGIT_TOL)
        np.testing.assert_array_equal(tc.lengths.numpy(),
                                      np.asarray(jc.lengths))
        if dead is not None:
            # only slot 0's page took a row
            changed = [int(p) for p in torch.nonzero(
                (tc.k[0] != pools[0]).flatten(1).any(1)).flatten()]
            assert changed == [int(table[0, lengths[0] // page_size])]
        lengths[live] += 1
    if not quantized:
        for jb, tb in zip(jc.k + jc.v, tc.k + tc.v):
            np.testing.assert_allclose(tb.numpy(), np.asarray(jb),
                                       **LOGIT_TOL)


def test_paged_entry_points_refuse(models):
    """Whole-prompt prefill on a paged cache raises as the JAX model
    does; a CUDA tensor never falls back to the plain version (here:
    there is no CUDA device to put one on)."""
    _, _, _, tcfg, model = models
    tc = PagedKVCache.for_model(tcfg, 1, 24, page_size=4, device="cpu")
    with pytest.raises(ValueError, match="whole-prompt"):
        model(torch.zeros((1, 4), dtype=torch.int64), cache=tc)
    q = torch.zeros((1, 4, 8))
    pool = torch.zeros((2, 4, 4, 8))
    with pytest.raises(RuntimeError, match="no kernel for device"):
        flash_attention_decode_paged(
            q.to("meta"), pool.to("meta"), pool.to("meta"),
            torch.zeros((1, 1), dtype=torch.int32, device="meta"),
            torch.zeros((1,), dtype=torch.int32, device="meta"))
    with pytest.raises(ValueError, match="both"):
        flash_attention_decode_paged(
            q, pool, pool, torch.zeros((1, 1), dtype=torch.int32),
            torch.zeros((1,), dtype=torch.int32),
            k_scale=torch.ones((2, 4)))
