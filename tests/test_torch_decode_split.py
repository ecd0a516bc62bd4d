"""The split decode read shared by the contiguous cache and the page
pools (``csrc/decode_split.cuh``), on the CPU.

- One read, two caches: `decode_spans_plain` over a contiguous cache and
  `decode_paged_spans_plain` over page pools that hold the same keys
  through a permuted table give the same bits, o and lse, at pages of 16
  and 64, in the decode grid's form and the chunk's (slot ids with
  padding), with a dead row at capacity and bounds that end inside a
  span and inside a page. The card checks the kernels the same way
  (chip_smoke.py, groups ``decode`` and ``paged``).
- The contiguous split read against the JAX package's
  `flash_attention_decode` (its Pallas kernel in interpret mode) on
  numpy-drawn fp32 inputs at 1e-5 (both sides fp32; the summation order
  differs), at the plan's split and at hand-picked ones.
- The capacity rule: a paged cache made for a capacity its pages round up
  keeps that capacity (`PagedKVCache.host_capacity`), the model hands it
  to both paged reads, and the paged read bounded by it plans the
  contiguous read's split and reads its bits.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rocm_apex_tpu.ops.flash_attention import (
    flash_attention_decode as jax_decode,
)
from rocm_apex_tpu_torch.convert import from_jax_params, random_params
from rocm_apex_tpu_torch.inference import (InferenceEngine, PagedKVCache,
                                           SamplingParams)
from rocm_apex_tpu_torch.models import gpt as tgpt
from rocm_apex_tpu_torch.models.gpt import GPTConfig
from rocm_apex_tpu_torch.ops import flash_attention as fa
from rocm_apex_tpu_torch.ops import flash_attention_segments as fas

TOL = dict(rtol=1e-5, atol=1e-5)
H100_SMS = 132
SLOTS, HEADS, HD = 4, 2, 16


def _t(a):
    return None if a is None else torch.from_numpy(np.asarray(a))


def _pools(k, v, page_size, rng):
    """Page pools holding a (slots, capacity, heads, hd) K/V cache through
    one permuted table, every page mapped (the capacity a whole number of
    pages). Returns (k pool, v pool, table)."""
    slots, cap, heads, hd = k.shape
    pps = cap // page_size
    perm = rng.permutation(slots * pps)

    def pool(cache):
        out = np.empty((slots * pps, heads, page_size, hd), cache.dtype)
        out[perm] = cache.reshape(slots, pps, page_size, heads,
                                  hd).transpose(0, 1, 3, 2, 4).reshape(
                                      slots * pps, heads, page_size, hd)
        return out

    return pool(k), pool(v), perm.reshape(slots, pps).astype(np.int32)


def _same(a, b):
    return all(torch.equal(x, y) for x, y in zip(a, b))


# slot 0: ends inside a span and (page 64) inside a page; slot 1: a dead
# row at capacity; slot 2: a span boundary; slot 3: empty
LENGTHS = np.array([45, 256, 64, 0], np.int32)
# the chunk form: rows naming their slots out of order, pads (id SLOTS)
SLOT_IDS = np.array([2, 0, 0, 3, 1, SLOTS, 2, SLOTS], np.int32)


@pytest.mark.parametrize("slot_ids", [None, SLOT_IDS],
                         ids=["decode grid", "chunk"])
@pytest.mark.parametrize("page_size", [16, 64])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_contiguous_and_paged_split_reads_are_bit_equal(page_size, slot_ids,
                                                        dtype):
    rng = np.random.default_rng(page_size)
    cap = 256
    k = rng.standard_normal((SLOTS, cap, HEADS, HD)).astype(np.float32)
    v = rng.standard_normal((SLOTS, cap, HEADS, HD)).astype(np.float32)
    kp, vp, table = _pools(k, v, page_size, rng)
    rows = SLOTS if slot_ids is None else len(slot_ids)
    q = _t(rng.standard_normal((rows, HEADS, HD)).astype(np.float32))
    q, kc, vc, kp, vp = (t.to(dtype) for t in map(_t, (q, k, v, kp, vp)))
    lengths, table, ids = _t(LENGTHS), _t(table), _t(slot_ids)
    spans, span_len = fa.decode_span_plan(rows, HEADS, cap, H100_SMS)
    assert spans > 1 and LENGTHS[0] % span_len and LENGTHS[0] < span_len * 2
    assert page_size != 64 or 0 < LENGTHS[0] % page_size
    contig = fa.decode_spans_plain(q, kc, vc, lengths, 0.3, spans,
                                   span_len, ids)
    paged = fa.decode_paged_spans_plain(q, kp, vp, table, lengths, 0.3,
                                        spans, span_len, slot_ids=ids)
    assert _same(contig, paged)
    # the wrappers' CPU path (the unsplit plain reads) too
    assert _same(
        fa.flash_attention_decode(q, kc, vc, lengths, 0.3, True, ids),
        fa.flash_attention_decode_paged(q, kp, vp, table, lengths, 0.3,
                                        return_lse=True, slot_ids=ids))
    o, lse = contig
    empty = ([3] if slot_ids is None else
             [i for i, s in enumerate(SLOT_IDS) if s in (3, SLOTS)])
    assert torch.all(o[empty] == 0) and torch.all(lse[empty] == -1e30)


@pytest.mark.parametrize("spans,span_len", [
    (None, None),  # the plan's: 4 spans of 32 at capacity 128
    (2, 96),  # spans past the capacity's last key
    (8, 32),  # more spans than live keys need
    (1, 128),  # one span: the whole walk
])
def test_contiguous_split_read_matches_jax(spans, span_len):
    """The decode grid: a full slot, a row ending inside a span, a row
    shorter than one span and an empty one, against the JAX kernel."""
    rng = np.random.default_rng(7)
    cap = 128
    k = rng.standard_normal((SLOTS, cap, HEADS, HD)).astype(np.float32)
    v = rng.standard_normal((SLOTS, cap, HEADS, HD)).astype(np.float32)
    q = rng.standard_normal((SLOTS, HEADS, HD)).astype(np.float32)
    lengths = np.array([cap, 77, 9, 0], np.int32)
    scale = 0.3
    if spans is None:
        spans, span_len = fa.decode_span_plan(SLOTS, HEADS, cap, H100_SMS)
        assert (spans, span_len) == (4, 32)
    # JAX's layout: (slots * heads, t, hd) rows, one bound a row
    jo, jlse = jax_decode(
        jnp.asarray(q.reshape(SLOTS * HEADS, 1, HD)),
        jnp.asarray(k.transpose(0, 2, 1, 3).reshape(SLOTS * HEADS, cap, HD)),
        jnp.asarray(v.transpose(0, 2, 1, 3).reshape(SLOTS * HEADS, cap, HD)),
        jnp.asarray(np.repeat(lengths, HEADS)), scale, return_lse=True)
    o, lse = fa.decode_spans_plain(_t(q), _t(k), _t(v), _t(lengths), scale,
                                   spans, span_len)
    np.testing.assert_allclose(o.numpy(),
                               np.asarray(jo).reshape(SLOTS, HEADS, HD),
                               **TOL)
    np.testing.assert_allclose(lse.numpy(),
                               np.asarray(jlse).reshape(SLOTS, HEADS), **TOL)
    assert np.all(o[3].numpy() == 0) and np.all(lse[3].numpy() == -1e30)


def test_a_paged_cache_keeps_its_capacity_for_the_plan():
    """Capacity 60 on pages of 16: the pools hold 64 rows a slot, whose
    split (2 spans of 32) is not capacity 60's (1 span of 64). The cache
    keeps 60, and the paged read bounded by it reads the contiguous
    read's bits, split and unsplit."""
    cfg = GPTConfig(vocab_size=64, hidden_size=32, num_layers=1,
                    num_attention_heads=HEADS, max_position_embeddings=64,
                    params_dtype=torch.float32, dtype=torch.float32)
    c = PagedKVCache.for_model(cfg, SLOTS, 60, page_size=16, device="cpu")
    assert (c.capacity, c.host_capacity) == (64, 60)
    plan = fa.decode_span_plan(SLOTS, HEADS, 60, H100_SMS)
    assert plan == (1, 64)
    assert fa.decode_span_plan(SLOTS, HEADS, 64, H100_SMS) == (2, 32)
    rng = np.random.default_rng(3)
    k = rng.standard_normal((SLOTS, 64, HEADS, HD)).astype(np.float32)
    v = rng.standard_normal((SLOTS, 64, HEADS, HD)).astype(np.float32)
    kp, vp, table = _pools(k, v, 16, rng)
    q = _t(rng.standard_normal((SLOTS, HEADS, HD)).astype(np.float32))
    lengths = _t(np.array([60, 33, 64, 0], np.int32))  # 64: a dead row
    kc, vc = _t(k[:, :60]), _t(v[:, :60])
    args = (q, _t(kp), _t(vp), _t(table), lengths, 0.3)
    assert _same(
        fa.decode_spans_plain(q, kc, vc, lengths, 0.3, *plan),
        fa.decode_paged_spans_plain(*args, *plan, capacity=60))
    assert _same(
        fa.flash_attention_decode(q, kc, vc, lengths, 0.3, True),
        fa.flash_attention_decode_paged(*args, return_lse=True,
                                        capacity=60))
    with pytest.raises(ValueError, match="capacity 65"):
        fa.flash_attention_decode_paged(*args, capacity=65)


def test_the_model_hands_both_paged_reads_the_host_capacity(monkeypatch):
    """The paged engine at capacity 24 on pages of 5 (25 rows a slot):
    every chunk read and decode read gets capacity 24, the contiguous
    cache's, and the greedy tokens equal the contiguous engine's."""
    cfg = GPTConfig(vocab_size=64, hidden_size=32, num_layers=2,
                    num_attention_heads=HEADS, max_position_embeddings=32,
                    params_dtype=torch.float32, dtype=torch.float32)
    model = from_jax_params(random_params(cfg, seed=5), cfg, device="cpu")
    greedy = dict(num_slots=2, capacity=24, prefill_token_budget=8,
                  sampling=SamplingParams(temperature=0.0))
    seen = []

    def spy(fn):
        def wrapped(*a, **kw):
            seen.append((fn.__name__, kw.get("capacity", a[11:12])))
            return fn(*a, **kw)
        return wrapped

    prompts = [[1, 2, 3, 4, 5, 6, 7], [9, 8, 7], [5] * 12]
    want = InferenceEngine(model, **greedy).generate(prompts,
                                                     max_new_tokens=4)
    monkeypatch.setattr(tgpt, "flash_attention_decode_paged",
                        spy(fa.flash_attention_decode_paged))
    monkeypatch.setattr(tgpt, "flash_attention_chunk_paged",
                        spy(fas.flash_attention_chunk_paged))
    got = InferenceEngine(model, paged=True, page_size=5,
                          **greedy).generate(prompts, max_new_tokens=4)
    assert [r.tokens for r in got] == [r.tokens for r in want]
    names = {n for n, _ in seen}
    assert names == {"flash_attention_decode_paged",
                     "flash_attention_chunk_paged"}
    assert all(cap in (24, (24,)) for _, cap in seen), seen
