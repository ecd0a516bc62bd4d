"""The port's speculative decoding against the JAX engine's, on the CPU.

The geometry of tests/L0/test_speculative.py (the tiny fp32 GPT: vocab
96, hidden 32, 2 layers, 4 heads, 32 positions; 2 slots, capacity 24;
budget 4 for the baselines, 6 for speculation), the same numpy-drawn
weights on both sides (`convert.random_params` into the JAX params and
through `convert.from_jax_params` into the port). Under greedy sampling
the port's spec engine must give the JAX spec engine's tokens, finish
reasons and draft counters at k = 2 and 4 on the contiguous cache, bf16
pages and int8 pages (page 4), and its own non-speculative tokens; the
port's numpy `NGramDrafter` must propose the JAX drafter's tokens bit
for bit. Rollback is "never written": an always-wrong drafter changes
nothing, shared prefix pages keep their bytes, preemption still
recovers, and the commit runs after the decode grid (the contiguous
grid's dead-row write lands at the span's first position).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rocm_apex_tpu.inference import InferenceEngine as JaxEngine
from rocm_apex_tpu.inference import KVCache as JaxKVCache
from rocm_apex_tpu.inference import PagedKVCache as JaxPagedKVCache
from rocm_apex_tpu.inference import NGramDrafter as JaxDrafter
from rocm_apex_tpu.inference import SamplingParams as JaxSamplingParams
from rocm_apex_tpu.models.gpt import GPTConfig as JaxGPTConfig
from rocm_apex_tpu.models.gpt import GPTModel as JaxGPTModel
from rocm_apex_tpu_torch.convert import from_jax_params, random_params
from rocm_apex_tpu_torch.inference import (
    InferenceEngine,
    KVCache,
    NGramDrafter,
    PagedKVCache,
    SamplingParams,
)
from rocm_apex_tpu_torch.models.gpt import GPTConfig

SHAPE = dict(vocab_size=96, hidden_size=32, num_layers=2,
             num_attention_heads=4, max_position_embeddings=32,
             tensor_parallel_size=1)
ENGINE = dict(num_slots=2, capacity=24, prefill_token_budget=4)
SPEC_BUDGET = 6
# periodic tails: the drafter's high-acceptance regime, so accepted
# drafts (not only the bonus token) are exercised
PROMPTS = [[1, 2, 3, 1, 2, 3, 1, 2], [7, 8, 9, 7, 8, 9, 7]]
MAX_NEW = 8
DRAFT_COUNTERS = ("tokens_drafted", "tokens_accepted", "rollbacks")
LOGIT_TOL = dict(rtol=1e-4, atol=1e-4)

LAYOUTS = [
    pytest.param({}, id="contig"),
    pytest.param({"paged": True, "page_size": 4}, id="paged"),
    pytest.param({"paged": True, "page_size": 4, "kv_dtype": torch.int8},
                 id="paged-int8"),
]


@pytest.fixture(scope="module")
def engines():
    tcfg = GPTConfig(**SHAPE, params_dtype=torch.float32, dtype=torch.float32)
    tree = random_params(tcfg, seed=1)
    jparams = jax.tree_util.tree_map(jnp.asarray, tree)
    models = {}
    for impl in ("flash", "jnp"):
        jcfg = JaxGPTConfig(**SHAPE, hidden_dropout=0.0,
                            attention_dropout=0.0, params_dtype=jnp.float32,
                            dtype=jnp.float32, attention_impl=impl)
        pcfg = GPTConfig(**SHAPE, params_dtype=torch.float32,
                         dtype=torch.float32, attention_impl=impl)
        models[impl] = (JaxGPTModel(jcfg),
                        from_jax_params(tree, pcfg, device="cpu"))
    donors = []  # JAX engines whose compiled steps same-geometry ones adopt

    def make(jax_side, cls=None, impl="flash", **kw):
        kw = {**ENGINE, **kw}
        jmodel, model = models[impl]
        if not jax_side:
            return (cls or InferenceEngine)(
                model, sampling=SamplingParams(temperature=0.0), **kw)
        if kw.get("kv_dtype") is torch.int8:
            kw["kv_dtype"] = jnp.int8
        kw["sampling"] = JaxSamplingParams(temperature=0.0)
        for donor in donors:
            try:
                return JaxEngine(jmodel, jparams, step_source=donor, **kw)
            except ValueError:
                continue
        eng = JaxEngine(jmodel, jparams, **kw)
        donors.append(eng)
        return eng

    make.vocab = tcfg.vocab_size
    make.models, make.jparams = models, jparams
    return make


def _spec(k, **kw):
    return dict(prefill_token_budget=SPEC_BUDGET, spec_k=k, **kw)


def _run(eng, prompts=PROMPTS, max_new=MAX_NEW):
    return [(r.tokens, r.finish_reason)
            for r in eng.generate(prompts, max_new_tokens=max_new)]


_BASELINES = {}


def _baseline(engines, layout):
    key = tuple(sorted((k, str(v)) for k, v in layout.items()))
    if key not in _BASELINES:
        _BASELINES[key] = _run(engines(False, **layout))
    return _BASELINES[key]


class _ShiftedDrafter:
    """The real drafter's proposals shifted by +1 mod vocab (JAX
    tests/L0/test_speculative.py:237): near-certain rejection."""

    def __init__(self, drafter_cls, k, vocab):
        self._inner = drafter_cls(k)
        self.window = self._inner.window
        self._vocab = vocab

    def __call__(self, histories, lengths):
        drafts, counts = self._inner(histories, lengths)
        return (np.asarray(drafts) + 1) % self._vocab, np.asarray(counts)


# ---------------------------------------------------------------------------
# the drafter
# ---------------------------------------------------------------------------


def _hist(tokens, window=16):
    h = np.full((1, window), -1, np.int32)
    h[0, window - len(tokens):] = tokens
    return h, np.array([len(tokens)], np.int32)


class TestNGramDrafter:
    @pytest.mark.parametrize("k,window,ngrams,seed", [
        (2, 16, (3, 2), 0), (4, 16, (3, 2), 1), (4, 64, (3, 2), 2),
        (3, 24, (4, 2, 1), 3),
    ])
    def test_propose_matches_jax_bitwise(self, k, window, ngrams, seed):
        """Seeded histories over a small alphabet (many matches), every
        live length from 0 to the window, the dead region filled either
        with the -1 pad or with stale tokens that would match."""
        rng = np.random.default_rng(seed)
        rows = 2 * window + 2
        hist = rng.integers(0, 5, size=(rows, window)).astype(np.int32)
        lengths = rng.integers(0, window + 1, size=rows).astype(np.int32)
        lengths[:window + 1] = np.arange(window + 1)
        for r in range(rows):
            if r % 2 == 0:
                hist[r, :window - lengths[r]] = -1
        got = NGramDrafter(k, window=window, ngrams=ngrams)(hist, lengths)
        want = JaxDrafter(k, window=window, ngrams=ngrams)(hist, lengths)
        for g, w in zip(got, want):
            assert g.dtype == np.int32
            np.testing.assert_array_equal(g, np.asarray(w))

    def test_suffix_match_proposes_following_tokens(self):
        drafts, counts = NGramDrafter(3, window=16)(
            *_hist([5, 6, 7, 8, 5, 6, 7]))
        assert int(counts[0]) == 3 and drafts[0].tolist() == [8, 5, 6]

    def test_no_repeat_means_no_proposal(self):
        _, counts = NGramDrafter(3, window=16)(*_hist([1, 2, 3, 4, 5, 6, 7]))
        assert int(counts[0]) == 0

    def test_pad_and_stale_regions_cannot_match(self):
        hist = np.full((1, 16), -1, np.int32)
        hist[0, 9:11] = [4, 5]  # stale: beyond the live length
        hist[0, 14:16] = [4, 5]  # the live suffix
        _, counts = NGramDrafter(3, window=16)(hist, np.array([2], np.int32))
        assert int(counts[0]) == 0

    def test_validates_construction(self):
        with pytest.raises(ValueError, match="k must be"):
            NGramDrafter(0)
        with pytest.raises(ValueError, match="window"):
            NGramDrafter(8, window=4)


# ---------------------------------------------------------------------------
# the model's speculative chunk and the commit
# ---------------------------------------------------------------------------


def _caches(jmodel, model, layout):
    """A JAX and a port cache of 2 slots x 24 rows in the layout, pages
    mapped out of order."""
    jcfg, tcfg = jmodel.cfg, model.cfg
    if not layout.get("paged"):
        return (JaxKVCache.for_model(jcfg, 2, 24),
                KVCache.for_model(tcfg, 2, 24, device="cpu"), None)
    q = layout.get("kv_dtype") is torch.int8
    jc = JaxPagedKVCache.for_model(jcfg, 2, 24, page_size=4, quantized=q)
    tc = PagedKVCache.for_model(tcfg, 2, 24, page_size=4, quantized=q,
                                device="cpu")
    table = np.full((2, tc.pages_per_slot), tc.num_pages, np.int32)
    table[0] = [3, 7, 0, 10, 5, 1]
    table[1] = [2, 8, 4, 11, 6, 9]
    jc = jc.replace(page_table=jnp.asarray(table))
    tc.page_table.copy_(torch.from_numpy(table))
    return jc, tc, table


def _chunk(pieces, commit_pad=()):
    """A 12-row chunk of (slot, tokens, start) pieces, then pads (slot
    2); the pieces of slots in ``commit_pad`` carry the pad id in the
    commit slots."""
    toks = np.zeros((12,), np.int32)
    slots = np.full((12,), 2, np.int32)
    commit = np.full((12,), 2, np.int32)
    pos = np.zeros((12,), np.int32)
    at = 0
    for slot, tk, start in pieces:
        n = len(tk)
        toks[at:at + n], slots[at:at + n] = tk, slot
        commit[at:at + n] = 2 if slot in commit_pad else slot
        pos[at:at + n] = np.arange(start, start + n)
        at += n
    return toks, slots, pos, commit, at


def _cache_arrays(c):
    return [np.asarray(x) for x in (
        *c.k, *c.v, *(getattr(c, "k_scale", None) or ()),
        *(getattr(c, "v_scale", None) or ()))]


@pytest.mark.parametrize("impl", ["flash", "jnp"])
@pytest.mark.parametrize("layout", LAYOUTS)
def test_spec_chunk_and_commit_match_jax(engines, layout, impl):
    """The model's 3-tuple chunk against JAX's: slot 0 a speculative
    span (commit slot = pad), slot 1 prompt rows that commit. The logits
    and each layer's chunk K/V agree, the span's rows stay unwritten
    (bit for bit as before the chunk), slot 1's land; then the commit of
    the span's first rows through `write_at` (host-resolved rows on the
    port) leaves the JAX commit's cache (float: within 1e-5)."""
    jmodel, model = engines.models[impl]
    jparams = engines.jparams
    jc, tc, table = _caches(jmodel, model, layout)
    rng = np.random.default_rng(5)
    p0, p1 = rng.integers(0, 96, 7).tolist(), rng.integers(0, 96, 9).tolist()
    toks, slots, pos, _, at = _chunk([(0, p0[:6], 0), (1, p1[:5], 0)])
    jlog, jc = jmodel.apply(jparams, jnp.asarray(toks)[None], cache=jc,
                            chunk=(jnp.asarray(slots), jnp.asarray(pos)))
    tlog, tc = model(torch.from_numpy(toks)[None], cache=tc,
                     chunk=(torch.from_numpy(slots), torch.from_numpy(pos)))
    np.testing.assert_allclose(tlog[0, :at].numpy(), np.asarray(jlog)[0, :at],
                               **LOGIT_TOL)
    lengths = np.array([6, 5], np.int32)
    jc = jc.replace(lengths=jnp.asarray(lengths))
    tc.lengths = torch.from_numpy(lengths.copy())
    span = [p0[6], 11, 12, 13]  # the last token and three drafts
    toks, slots, pos, commit, at = _chunk(
        [(0, span, 6), (1, p1[5:9], 5)], commit_pad=(0,))
    before = [x.copy() for x in _cache_arrays(tc)]
    jlog, jc, (jk, jv) = jmodel.apply(
        jparams, jnp.asarray(toks)[None], cache=jc,
        chunk=(jnp.asarray(slots), jnp.asarray(pos), jnp.asarray(commit)))
    tlog, tc, (tk, tv) = model(
        torch.from_numpy(toks)[None], cache=tc,
        chunk=(torch.from_numpy(slots), torch.from_numpy(pos),
               torch.from_numpy(commit)))
    np.testing.assert_allclose(tlog[0, :at].numpy(), np.asarray(jlog)[0, :at],
                               **LOGIT_TOL)
    for layer in range(model.cfg.num_layers):
        for t, j in ((tk, jk), (tv, jv)):
            np.testing.assert_allclose(t[layer][:at].numpy(),
                                       np.asarray(j[layer])[:at],
                                       rtol=1e-5, atol=1e-5)
    after = _cache_arrays(tc)
    if table is None:  # slot 0's rows 6.. unwritten, slot 1's 5..8 written
        for b, a in zip(before, after):
            np.testing.assert_array_equal(a[0], b[0])
            assert not np.array_equal(a[1, 5:9], b[1, 5:9])
    else:  # slot 0's pages untouched, scales included
        span_pages = table[0, 6 // 4:10 // 4 + 1]
        for b, a in zip(before, after):
            np.testing.assert_array_equal(a[span_pages], b[span_pages])
    # the commit of the span's first three rows (two accepted drafts)
    cs = np.full((12,), 2, np.int32)
    cp = np.zeros((12,), np.int32)
    cs[:3], cp[:3] = 0, np.arange(6, 9)
    for layer in range(model.cfg.num_layers):
        jc = jc.write_at(layer, jnp.asarray(cs), jnp.asarray(cp), jk[layer],
                         jv[layer])
    rows = (tc.host_rows(cs, cp, table) if table is not None
            else tc.host_rows(cs, cp))
    rows = tc.rows_from(torch.from_numpy(cs), torch.from_numpy(cp),
                        *(torch.from_numpy(r) for r in rows))
    for layer in range(model.cfg.num_layers):
        tc.write_at(layer, None, None, tk[layer], tv[layer], rows=rows)
    if layout.get("kv_dtype") is None:
        for t, j in zip(_cache_arrays(tc), _cache_arrays(jc)):
            np.testing.assert_allclose(t, j, rtol=1e-5, atol=1e-5)
    else:  # int8: pools within one step of JAX's, scales within 1e-5
        for t, j in zip(_cache_arrays(tc), _cache_arrays(jc)):
            if t.dtype == np.int8:
                assert np.abs(t.astype(np.int32) - j).max() <= 1
            else:
                np.testing.assert_allclose(t, j, rtol=1e-5, atol=1e-7)


# ---------------------------------------------------------------------------
# parity with the JAX engine and with the non-speculative engine
# ---------------------------------------------------------------------------


class TestSpeculativeParity:
    @pytest.mark.parametrize("k", [2, 4])
    @pytest.mark.parametrize("layout", LAYOUTS)
    def test_greedy_matches_jax_and_baseline(self, engines, layout, k):
        """The JAX spec engine's tokens, finish reasons and draft
        counters, and the port's own non-speculative tokens; every
        drafted token accepted or rolled back; every page returned."""
        eng = engines(False, **_spec(k, **layout))
        got = _run(eng)
        jeng = engines(True, **_spec(k, **layout))
        assert got == _run(jeng)
        s, js = eng.stats(), jeng.stats()
        assert {c: s[c] for c in DRAFT_COUNTERS} == {
            c: js[c] for c in DRAFT_COUNTERS}
        assert got == _baseline(engines, layout)
        assert s["tokens_accepted"] > 0
        assert (s["rollbacks"] > 0) == (
            s["tokens_drafted"] > s["tokens_accepted"])
        assert s["acceptance_rate"] == pytest.approx(
            s["tokens_accepted"] / s["tokens_drafted"])
        assert s["pages_used"] == 0.0
        # one fetch a device step, none for the commit
        assert s["host_fetches"] == s["mixed_steps"] + s["decode_only_steps"]

    @pytest.mark.parametrize("layout", LAYOUTS)
    def test_jnp_attention_matches_jax(self, engines, layout):
        """attention_impl="jnp": the two-piece speculative form (the
        committed prefix from the cache, the span's rows from the
        projections, one softmax) gives the JAX "jnp" spec engine's
        tokens and counters, and the flash spec engine's tokens."""
        eng = engines(False, impl="jnp", **_spec(2, **layout))
        got = _run(eng)
        jeng = engines(True, impl="jnp", **_spec(2, **layout))
        assert got == _run(jeng)
        assert {c: eng.stats()[c] for c in DRAFT_COUNTERS} == {
            c: jeng.stats()[c] for c in DRAFT_COUNTERS}
        assert got == _run(engines(False, **_spec(2, **layout)))

    def test_constructor_refusals_match_jax(self, engines):
        """spec_k needs the chunked scheduler and spec_k + 1 budget rows,
        and does not compose with an adapter pool: the JAX messages."""
        cases = [
            dict(spec_k=2, prefill_token_budget=None, max_prompt_len=24),
            dict(spec_k=4),  # 4 + 1 > budget 4
            dict(spec_k=2, prefill_token_budget=6, adapter_pool=object()),
            dict(spec_k=-1),
        ]
        for kw in cases:
            msgs = []
            for jax_side in (False, True):
                with pytest.raises(ValueError) as err:
                    engines(jax_side, **kw)
                msgs.append(str(err.value))
            assert msgs[0] == msgs[1]


# ---------------------------------------------------------------------------
# rollback: never written, not undone
# ---------------------------------------------------------------------------


class TestRollback:
    @pytest.mark.parametrize("layout", LAYOUTS)
    def test_always_wrong_drafter_is_harmless(self, engines, layout):
        """A drafter wrong on nearly every token: the baseline's tokens
        on every layout (a junk committed row would move later argmaxes;
        a rejected int8 row would have raised a page scale), as on the
        JAX side, and every page back."""
        vocab = engines.vocab
        eng = engines(False, drafter=_ShiftedDrafter(NGramDrafter, 2, vocab),
                      **_spec(2, **layout))
        got = _run(eng)
        assert got == _baseline(engines, layout)
        jeng = engines(True, drafter=_ShiftedDrafter(JaxDrafter, 2, vocab),
                       **_spec(2, **layout))
        assert got == _run(jeng)
        s = eng.stats()
        assert s["tokens_drafted"] > 0 and s["rollbacks"] > 0
        assert s["tokens_accepted"] < s["tokens_drafted"]
        assert {c: s[c] for c in DRAFT_COUNTERS} == {
            c: jeng.stats()[c] for c in DRAFT_COUNTERS}
        assert s["pages_used"] == 0.0
        eng.reset_stats()
        s = eng.stats()
        assert s["tokens_drafted"] == 0.0 and s["rollbacks"] == 0.0
        assert s["acceptance_rate"] == 0.0

    @pytest.mark.parametrize("kv_dtype", [None, torch.int8],
                             ids=["bf16-pages", "int8-pages"])
    def test_shared_prefix_pages_never_written(self, engines, kv_dtype):
        """B maps A's registered prompt pages by reference and serves
        speculative spans under an always-wrong drafter: the shared
        pages' bytes (pools and int8 scales, every layer) are bitwise
        what A's prefill left, and both requests give the unshared
        baseline's tokens."""
        sys_prefix = list(range(40, 52))  # 3 full pages at page size 4
        p_a, p_b = sys_prefix + [1, 2, 3], sys_prefix + [7, 8]
        layout = dict(paged=True, page_size=4, kv_dtype=kv_dtype)
        ref = engines(False, **layout)
        want = [_run(ref, [p], 6) for p in (p_a, p_b)]
        eng = engines(False, prefix_sharing=True,
                      drafter=_ShiftedDrafter(NGramDrafter, 2, engines.vocab),
                      **_spec(2, **layout))
        got_a = _run(eng, [p_a], 6)
        shared = [p for p in range(eng.cache.num_pages)
                  if eng._store.is_registered(p)]
        assert len(shared) == 3
        idx = torch.tensor(shared)
        c = eng.cache
        before = [t[idx].clone() for t in
                  (*c.k, *c.v, *(c.k_scale or ()), *(c.v_scale or ()))]
        got_b = _run(eng, [p_b], 6)
        after = [t[idx] for t in
                 (*c.k, *c.v, *(c.k_scale or ()), *(c.v_scale or ()))]
        for x, y in zip(before, after):
            assert torch.equal(x, y)
        assert [got_a, got_b] == want
        s = eng.stats()
        assert s["prefix_hits"] >= 1 and s["rollbacks"] > 0

    def test_preemption_under_speculation(self, engines):
        """Two requests exhaust a 5-page pool under speculation: the
        youngest is preempted and recomputed, the tokens are the
        unconstrained pool's, as on the JAX side, every page back. (At
        6 new tokens both engines livelock instead: the stalled slot's
        last decode asks for its page after the readmitted request's
        prefill has taken the freed ones.)"""
        prompts = [list(range(1, 9)), list(range(9, 17))]
        want = _run(engines(False, paged=True, page_size=4), prompts, 8)
        kw = _spec(2, paged=True, page_size=4, num_pages=5)
        eng = engines(False, **kw)
        got = _run(eng, prompts, 8)
        assert got == want
        jeng = engines(True, **kw)
        assert got == _run(jeng, prompts, 8)
        s = eng.stats()
        assert s["preemptions"] >= 1 and s["pages_used"] == 0.0
        assert s["preemptions"] == jeng.stats()["preemptions"]


# ---------------------------------------------------------------------------
# the commit runs after the decode grid
# ---------------------------------------------------------------------------


class _JunkDeadRows(InferenceEngine):
    """Feeds the decode grid's dead rows a junk token, so what the grid
    writes at a dead slot's length is visibly garbage (the engine feeds
    a dead row its last token, whose K/V equal the span's first row up
    to rounding), and records each commit's rows."""

    commits = None

    def _decode_body(self, tokens, active, lengths, rows=None, poison=None):
        junk = (self.model.cfg.vocab_size - 1 - tokens) % \
            self.model.cfg.vocab_size
        self._grid_inputs = (torch.where(active, tokens, junk), active,
                             lengths, rows)
        return super()._decode_body(self._grid_inputs[0], active, lengths,
                                    rows, poison)

    def _commit(self, chunk_kv, slots, positions):
        self.commits = (chunk_kv, slots.copy(), positions.copy())
        super()._commit(chunk_kv, slots, positions)

    def committed_rows_intact(self):
        """The last commit's rows hold the chunk's K/V, bit for bit."""
        (ks, vs), slots, positions = self.commits
        rows = np.nonzero(slots < self.num_slots)[0]
        c = self.cache
        return all(
            torch.equal(buf[layer][slots[r], positions[r]],
                        new[layer][r].to(buf[layer].dtype))
            for buf, new in ((c.k, ks), (c.v, vs))
            for layer in range(len(ks)) for r in rows
        )


class _CommitBeforeGrid(_JunkDeadRows):
    """The wrong order: the commit's rows then take the decode grid's
    dead-row write (the grid replayed after the commit is the cache a
    commit before the grid would leave)."""

    def _commit(self, chunk_kv, slots, positions):
        super()._commit(chunk_kv, slots, positions)
        tokens, active, lengths, rows = self._grid_inputs
        with torch.no_grad():
            self.cache.lengths = lengths.to(torch.int32)
            self.model(tokens[:, None], cache=self.cache, rows=rows)


def _intact_after_each_commit(eng):
    for p in PROMPTS:
        eng.add_request(p, MAX_NEW)
    intact = []
    while eng.has_work():
        eng.commits = None
        eng.step()
        if eng.commits is not None:
            intact.append(eng.committed_rows_intact())
    return intact


def test_commit_runs_after_the_decode_grid(engines):
    """On the contiguous cache a slot with a span is a dead row of the
    tick's grid, whose write lands at its length: the span's first
    committed row. With the commit after the grid (the engine's order)
    every committed row holds the chunk's K/V after the tick and the
    tokens are the baseline's; a commit before the grid leaves the
    grid's junk in the span's first row."""
    right = engines(False, cls=_JunkDeadRows, **_spec(2))
    assert _run(right) == _baseline(engines, {})
    right = engines(False, cls=_JunkDeadRows, **_spec(2))
    intact = _intact_after_each_commit(right)
    assert intact and all(intact)
    wrong = engines(False, cls=_CommitBeforeGrid, **_spec(2))
    assert not all(_intact_after_each_commit(wrong))


# ---------------------------------------------------------------------------


def _rows_case(seed, num_slots=3, capacity=22, page_size=4):
    """Unique (slot, position) rows over every drop case: pads (slot id
    ``num_slots``), negative slots and positions, positions at and past
    capacity, in-range rows; and a page table with unmapped entries."""
    rng = np.random.default_rng(seed)
    grid = [(s, p) for s in range(-1, num_slots + 1)
            for p in range(-2, capacity + 4)]
    pick = rng.choice(len(grid), size=40, replace=False)
    slots = np.array([grid[i][0] for i in pick], np.int32)
    positions = np.array([grid[i][1] for i in pick], np.int32)
    pages_per_slot = -(-capacity // page_size)
    num_pages = num_slots * pages_per_slot
    table = rng.permutation(num_pages).reshape(num_slots, pages_per_slot)
    table[rng.random(table.shape) < 0.35] = num_pages  # unmapped
    return slots, positions, table


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("layout", LAYOUTS)
def test_host_rows_match_device_rows(layout, seed):
    """The engine resolves every cache write on the host (`host_rows`);
    direct model callers resolve them on the device (`chunk_rows`,
    `ops.paging.paged_rows`). Both apply one drop rule: the same kept
    rows and destinations on pads, out-of-range slots and positions and
    unmapped pages, and a `write_at` through either leaves the same
    pools and scales, bit for bit."""
    from rocm_apex_tpu_torch.inference.kv_cache import chunk_rows
    from rocm_apex_tpu_torch.ops.paging import paged_rows

    num_slots, capacity, heads, hd = 3, 22, 2, 8
    slots, positions, table = _rows_case(seed, num_slots, capacity)
    st, pt = torch.from_numpy(slots), torch.from_numpy(positions)
    if layout:
        kw = dict(page_size=layout["page_size"], dtype=torch.float32,
                  quantized=layout.get("kv_dtype") == torch.int8)
        caches = [PagedKVCache.create(1, num_slots, capacity, heads, hd,
                                      device="cpu", **kw) for _ in range(2)]
        for c in caches:
            c.page_table.copy_(torch.from_numpy(table))
        host = caches[0].host_rows(slots, positions, table)
        dev = paged_rows(caches[0].page_table, st, pt, kw["page_size"],
                         caches[0].num_pages)
        pairs = zip(host, (dev.keep, dev.pages, dev.offsets))
    else:
        caches = [KVCache.create(1, num_slots, capacity, heads, hd,
                                 dtype=torch.float32, device="cpu")
                  for _ in range(2)]
        host = caches[0].host_rows(slots, positions)
        dev = chunk_rows(st, pt, num_slots, capacity)
        pairs = zip(host, (dev.keep, dev.keep_slots, dev.keep_positions))
    kept = len(host[0])
    assert 0 < kept < len(slots)
    for h, d in pairs:
        np.testing.assert_array_equal(h, d.numpy())
    gen = torch.Generator().manual_seed(seed)
    k_new, v_new = (torch.randn((len(slots), heads, hd), generator=gen)
                    for _ in range(2))
    rows = caches[1].rows_from(st, pt, *(torch.from_numpy(a) for a in host))
    caches[0].write_at(0, st, pt, k_new, v_new)
    caches[1].write_at(0, st, pt, k_new, v_new, rows=rows)
    names = ("k", "v") + (("k_scale", "v_scale")
                          if layout.get("kv_dtype") == torch.int8 else ())
    for name in names:
        assert torch.equal(getattr(caches[0], name)[0],
                           getattr(caches[1], name)[0]), name
