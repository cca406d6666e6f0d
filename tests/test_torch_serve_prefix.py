"""The port's prefix sharing and chunked prefill (``serve/prefix.py``,
``LanguageModel.prefill_chunk_at``, ``attention.chunk_attention`` /
``_ring_update``, ``ServeEngine(prefill_chunk=, prefix_entries=)``) on
the CPU against the JAX package: the reference's
``tests/test_serve_prefix.py`` ported, plus its
``test_sliding_window_prompt_longer_than_ring``. The same seeded numpy
inputs go through both packages, the reference's params carried over by
``bridge``; each serve family at its reduced config in f32 (qwen3-14b
dense GQA, deepseek-v2-236b MLA + MoE, falcon-mamba-7b SSM, zamba2-7b
hybrid).

The engines' greedy tokens are held equal to the reference engine's:
the reference engine (one per arch, reused across tests, monolithic
admission) decodes the same prompts; every reduced family routes each
token on its own (deepseek's reduced MoE sends every token to all 4
experts under capacity 1.25 N), so a request's greedy tokens do not
depend on what shares its batch. Tolerances (f32, sums in another
order): chunk logits, ``chunk_attention`` outputs and cache rows within
rtol/atol 1e-5 of the reference's (measured up to ~4e-6); the
``_ring_update`` scatter exact.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_get_config
from repro.models import attention as RA
from repro.models import build_model as ref_build_model
from repro.serve import ServeEngine as RefServeEngine
from repro.serve.prefix import PrefixPool as RefPrefixPool
from repro_torch import bridge
from repro_torch.configs import get_config
from repro_torch.models import attention as A
from repro_torch.models import build_model
from repro_torch.serve import ServeEngine, parse_sampler
from repro_torch.serve.prefix import PrefixPool, RadixIndex
from repro_torch.serve.scheduler import TierSLO
from _torch_threads import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

ALL_ARCHS = ["qwen3-14b", "deepseek-v2-236b", "falcon-mamba-7b",
             "zamba2-7b"]   # dense GQA / MLA / SSM / hybrid
TOL = dict(rtol=1e-5, atol=1e-5)
ENGINE = dict(slots=3, capacity=64, seed=7)

_PAIRS: dict = {}
_REF_ENGINES: dict = {}
_REF_TOKENS: dict = {}


def pair(arch, **changes):
    """(cfg, port model, port params, ref model, ref params) for the
    reduced arch with ``changes`` (fields that leave the params' shapes
    alone: a window, the softcap), the reference's init of the arch
    carried over (one init per arch)."""
    if arch not in _PAIRS:
        rmodel = ref_build_model(ref_get_config(arch).reduced())
        rparams = jax.jit(rmodel.init)(jax.random.key(1))
        model = build_model(get_config(arch).reduced())
        _PAIRS[arch] = (rparams, bridge.lm_params_to_torch(
            jax.device_get(rparams), model))
    rparams, params = _PAIRS[arch]
    rcfg = dataclasses.replace(ref_get_config(arch).reduced(), **changes)
    cfg = dataclasses.replace(get_config(arch).reduced(), **changes)
    return cfg, build_model(cfg), params, ref_build_model(rcfg), rparams


def ref_tokens(arch, prompts, max_new, **changes):
    """The reference engine's greedy tokens for ``prompts`` (monolithic
    admission, 3 slots of 64): one engine per arch, reused, its prompt
    buffers bucketed by 16 (an exact padding) to bound its compiles."""
    key = (arch, tuple(sorted(changes.items())),
           tuple(p.tobytes() for p in prompts), max_new)
    if key not in _REF_TOKENS:
        ekey = key[:2]
        if ekey not in _REF_ENGINES:
            _, _, _, rmodel, rparams = pair(arch, **changes)
            _REF_ENGINES[ekey] = RefServeEngine(rmodel, rparams,
                                                prefill_bucket=16, **ENGINE)
        _REF_TOKENS[key] = [np.asarray(t) for t in
                            _REF_ENGINES[ekey].generate(prompts, max_new)]
    return _REF_TOKENS[key]


_JITS: dict = {}


def ref_jit(rmodel, name: str):
    """A jitted method of a reference model, made once (one compile per
    input shape instead of one per eager op)."""
    key = (repr(rmodel.cfg), name)
    if key not in _JITS:
        _JITS[key] = jax.jit(getattr(rmodel, name))
    return _JITS[key]


def _prompts(cfg, lens, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(1, cfg.vocab_size, (l,)).astype(np.int32)
            for l in lens]


def _same(a_list, b_list):
    assert len(a_list) == len(b_list)
    for a, b in zip(a_list, b_list):
        np.testing.assert_array_equal(a, b)


def _np(x):
    return x.detach().float().numpy() if torch.is_tensor(x) \
        else np.asarray(x, np.float32)


# ------------------------------------------------------------ radix index

def test_radix_insert_longest_and_edge_split():
    ix = RadixIndex()
    ix.insert((1, 2, 3, 4), 0)
    ix.insert((1, 2, 5), 1)          # splits the (1,2,3,4) edge at 2
    ix.insert((1, 2), 2)             # lands exactly on the split node
    assert ix.longest((1, 2, 3, 4, 9)) == (0, 4)
    assert ix.longest((1, 2, 5, 7)) == (1, 3)
    assert ix.longest((1, 2, 9)) == (2, 2)   # falls back to shorter hit
    assert ix.longest((9, 9)) is None
    assert ix.get((1, 2)) == 2
    assert ix.get((1, 2, 3)) is None  # mid-edge: not a stored prefix
    assert len(ix) == 3


def test_radix_remove_prunes_and_merges():
    ix = RadixIndex()
    ix.insert((1, 2, 3, 4), 0)
    ix.insert((1, 2, 3, 4, 5, 6), 1)
    ix.remove(0)                     # pass-through node merges back
    assert len(ix) == 1
    assert ix.get((1, 2, 3, 4)) is None
    assert ix.longest((1, 2, 3, 4, 5, 6, 7)) == (1, 6)
    ix.remove(1)
    assert len(ix) == 0
    assert ix.longest((1, 2, 3, 4, 5, 6)) is None
    assert not ix.root.children      # fully pruned


def test_radix_error_paths():
    ix = RadixIndex()
    with pytest.raises(ValueError, match="empty"):
        ix.insert((), 0)
    ix.insert((1, 2), 0)
    with pytest.raises(ValueError, match="already indexed"):
        ix.insert((3, 4), 0)         # entry id reuse
    with pytest.raises(ValueError, match="already held"):
        ix.insert((1, 2), 1)         # prefix reuse


# ------------------------------------------------------------ prefix pool

def test_pool_refcount_pins_entry_against_eviction():
    pool = PrefixPool(1, min_tokens=2)
    e = pool.insert((1, 2, 3))
    assert e is not None
    hit = pool.acquire((1, 2, 3, 9))
    assert hit == (e, 3)
    # the only entry is pinned: insert must skip, not evict
    assert pool.insert((7, 8)) is None
    pool.release(e)
    assert pool.insert((7, 8)) is not None   # now evictable
    assert pool.stats["evictions"] == 1
    with pytest.raises(ValueError, match="below zero"):
        pool.release(e)


def test_pool_lru_eviction_order():
    pool = PrefixPool(2, min_tokens=1)
    e0 = pool.insert((1, 1))
    e1 = pool.insert((2, 2))
    m = pool.acquire((1, 1, 5))      # touches e0 -> e1 becomes LRU
    pool.release(m[0])
    pool.insert((3, 3))
    assert pool.has((1, 1)) and pool.has((3, 3))
    assert not pool.has((2, 2))      # e1 was evicted
    assert e0 != e1


def test_pool_min_tokens_and_dedup():
    """The pool's semantics, and one operation sequence through both
    packages' pools: the same entries, hits, evictions and stats."""
    pool = PrefixPool(4, min_tokens=3)
    assert pool.insert((1, 2)) is None        # too short to store
    e = pool.insert((1, 2, 3))
    assert pool.insert((1, 2, 3)) is None     # duplicate key: no-op
    assert pool.acquire((1, 2, 9)) is None    # match below min_tokens
    assert pool.stats["misses"] == 1
    hit = pool.acquire((1, 2, 3, 4))
    assert hit == (e, 3)
    assert pool.stats["hits"] == 1 and pool.stats["hit_tokens"] == 3
    assert pool.hit_rate == 0.5
    rng = np.random.default_rng(0)
    out = []
    for P in (PrefixPool, RefPrefixPool):
        p, trace = P(3, min_tokens=2), []
        for _ in range(40):
            toks = tuple(rng.integers(0, 3, int(rng.integers(1, 5))))
            op = int(rng.integers(0, 3))
            if op == 0:
                trace.append(("i", p.insert(toks)))
            elif op == 1:
                m = p.acquire(toks)
                trace.append(("a", m))
                if m is not None and rng.random() < 0.7:
                    p.release(m[0])
            else:
                trace.append(("h", p.has(toks)))
        out.append((trace, dict(p.stats)))
        rng = np.random.default_rng(0)
    assert out[0] == out[1]


# ---------------------------------- chunk attention and the ring scatter

def test_ring_update_and_insert_span_match_reference():
    """The in-place scatters against the reference's functional ones, on
    a ring (chunks past, across and within the ring's length, pad
    positions, an inactive row) and on a linear buffer (a tail past the
    capacity is dropped); rows addressed through a slot list."""
    rng = np.random.default_rng(4)
    cap, C = 8, 11
    ring = rng.standard_normal((4, cap, 2, 3)).astype(np.float32)
    chunk = rng.standard_normal((4, C, 2, 3)).astype(np.float32)
    start = np.array([0, 5, 13, 7], np.int32)
    lengths = np.array([11, 4, 9, 0], np.int32)
    want = RA._ring_update(jnp.asarray(ring), jnp.asarray(chunk),
                           jnp.asarray(start), jnp.asarray(lengths))
    got = A._ring_update(torch.tensor(ring), torch.tensor(chunk),
                         torch.tensor(start), torch.tensor(lengths))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    lin = rng.standard_normal((4, 16, 2, 3)).astype(np.float32)
    want = np.asarray(RA._insert_span(jnp.asarray(lin), jnp.asarray(chunk),
                                      jnp.asarray(start)))
    big = torch.tensor(np.concatenate([lin, lin]))   # rows 4..7 addressed
    A._insert_span(big, torch.tensor(chunk), torch.tensor(start),
                   torch.tensor(lengths), rows=torch.arange(4, 8))
    np.testing.assert_array_equal(big[:4].numpy(), lin)
    for b in range(4):              # the valid span; the reference also
        lo, hi = start[b], min(16, start[b] + lengths[b])   # writes pads
        np.testing.assert_array_equal(big[4 + b, lo:hi].numpy(),
                                      want[b, lo:hi])
        np.testing.assert_array_equal(big[4 + b, :lo].numpy(), lin[b, :lo])


@pytest.mark.parametrize("window", [0, 8])
def test_chunk_attention_matches_reference(window):
    """``chunk_attention`` on a linear buffer (window 0) and on a ring
    (window 8, chunks resumed past the ring's length), with the softcap:
    outputs within 1e-5 of the reference's, and the cache it leaves
    equal where it is ever read (the reference also writes the pad
    positions of a linear buffer)."""
    changes = dict(sliding_window=window, attn_logit_softcap=2.0)
    cfg, model, params, rmodel, rparams = pair("smollm-135m", **changes)
    p = {k: v[0] for k, v in params["layers"]["attn"].items()}
    rp = {k: v[0] for k, v in rparams["layers"]["attn"].items()}
    rng = np.random.default_rng(5)
    S_buf = 8 if window else 32
    _, Hkv, hd = cfg.attn_dims
    ck = rng.standard_normal((3, S_buf, Hkv, hd)).astype(np.float32)
    cv = rng.standard_normal((3, S_buf, Hkv, hd)).astype(np.float32)
    C = 6
    x = rng.standard_normal((3, C, cfg.d_model)).astype(np.float32)
    start = np.array([0, 9, 20], np.int32)
    lengths = np.array([6, 3, 0], np.int32)
    qpos = start[:, None] + np.arange(C, dtype=np.int32)[None]
    out, k, v = A.chunk_attention(cfg, p, torch.tensor(x), torch.tensor(ck),
                                  torch.tensor(cv), torch.tensor(qpos),
                                  torch.tensor(start), torch.tensor(lengths))
    rout, rk, rv = jax.jit(functools.partial(RA.chunk_attention, cfg))(
        rp, jnp.asarray(x), jnp.asarray(ck), jnp.asarray(cv),
        jnp.asarray(qpos), jnp.asarray(start), jnp.asarray(lengths))
    for b in range(2):              # the inactive row's output is unused
        np.testing.assert_allclose(_np(out[b, :lengths[b]]),
                                   np.asarray(rout)[b, :lengths[b]], **TOL)
    for got, want in ((k, rk), (v, rv)):
        if window:
            np.testing.assert_allclose(_np(got), np.asarray(want), **TOL)
        else:
            for b in range(3):
                end = start[b] + lengths[b]
                np.testing.assert_allclose(_np(got[b, :end]),
                                           np.asarray(want)[b, :end], **TOL)


# ------------------------------------- chunked prefill: model layer exact

@pytest.mark.parametrize("arch", ALL_ARCHS)
def test_chunked_prefill_matches_monolithic(arch):
    """The port's ``prefill_chunk_at`` resumed in chunks of 3 (into rows
    2 and 0 of a 3-slot cache, the third slot untouched) against the
    reference's: each chunk's logits within 1e-5 where the row was
    active, the caches' read rows within 1e-5, and 5 greedy decode steps
    with the same tokens and logits within 1e-5; the first tokens equal
    the port's monolithic ``prefill_at``'s."""
    cfg, model, params, rmodel, rparams = pair(arch)
    lens, cap, C = np.array([7, 5]), 32, 3
    slots = np.array([2, 0])
    rng = np.random.default_rng(0)
    B, S = len(lens), int(lens.max())
    toks = np.zeros((B, S), np.int32)
    for i, l in enumerate(lens):
        toks[i, :l] = rng.integers(1, cfg.vocab_size, size=l)
    mono_logits, _ = model.prefill_at(params, model.init_cache(3, cap),
                                      torch.tensor(toks),
                                      torch.tensor(slots),
                                      lengths=torch.tensor(lens))
    cache = model.init_cache(3, cap)
    before = {k: v.clone() for k, v in cache.items()}
    rcache = rmodel.init_cache(3, cap)
    start, logits = np.zeros(B, np.int32), None
    while (start < lens).any():
        cl = np.clip(lens - start, 0, C).astype(np.int32)
        chunk = np.zeros((B, C), np.int32)
        for i in range(B):
            chunk[i, :cl[i]] = toks[i, start[i]:start[i] + cl[i]]
        lg, cache = model.prefill_chunk_at(
            params, cache, torch.tensor(chunk), torch.tensor(slots),
            start=torch.tensor(start), chunk_lengths=torch.tensor(cl))
        rlg, rcache = ref_jit(rmodel, "prefill_chunk_at")(
            rparams, rcache, jnp.asarray(chunk), jnp.asarray(slots),
            start=jnp.asarray(start), chunk_lengths=jnp.asarray(cl))
        act = cl > 0
        np.testing.assert_allclose(_np(lg)[act], np.asarray(rlg)[act],
                                   **TOL)
        done = act & (start + cl == lens)
        logits = _np(lg) if logits is None else np.where(
            done[:, None], _np(lg), logits)
        start = start + cl
    for name in cache:              # slot 1 was never addressed
        assert torch.equal(cache[name][:, 1] if name != "pos"
                           else cache[name][1],
                           before[name][:, 1] if name != "pos"
                           else before[name][1]), name
    assert cache["pos"].tolist() == np.asarray(rcache["pos"]).tolist()
    nxt = logits.argmax(-1).astype(np.int32)
    np.testing.assert_array_equal(nxt, _np(mono_logits).argmax(-1))
    tok = np.zeros((3, 1), np.int32)
    tok[slots, 0] = nxt
    for _ in range(5):               # caches must agree, not just logits
        lc, cache = model.decode_step(params, cache, torch.tensor(tok))
        lr, rcache = ref_jit(rmodel, "decode_step")(rparams, rcache,
                                                    jnp.asarray(tok))
        np.testing.assert_allclose(_np(lc)[slots], np.asarray(lr)[slots],
                                   **TOL)
        tok = _np(lc)[:, 0].argmax(-1)[:, None].astype(np.int32)
        np.testing.assert_array_equal(
            tok[slots], np.asarray(lr)[slots, 0].argmax(-1)[:, None])


# ----------------------------------------- engine layer: chunked + prefix

@pytest.mark.parametrize("arch", ALL_ARCHS)
def test_engine_chunked_matches_unchunked(arch):
    """prefill_chunk=4 admission emits exactly the reference engine's
    tokens (slot reuse: more requests than slots), and every decode tick
    made one decode_step call."""
    cfg, model, params, _, _ = pair(arch)
    ps = _prompts(cfg, [7, 12, 5, 9], seed=2)
    eng = ServeEngine(model, params, cfg, prefill_chunk=4, **ENGINE)
    _same(ref_tokens(arch, ps, 6), eng.generate(ps, 6))
    assert eng.stats["chunk_calls"] > 0
    assert eng.stats["decode_calls"] == eng.stats["decode_steps"]
    assert eng.stats["flash_decode_outside_ticks"] == 0
    assert eng.logits_finite


def _sessions(cfg):
    shared = _prompts(cfg, [16], seed=3)[0]
    return shared, [np.concatenate([shared, p])
                    for p in _prompts(cfg, [4, 6, 5], seed=5)]


@pytest.mark.parametrize("arch", ALL_ARCHS)
def test_engine_prefix_reuse_byte_identical(arch):
    """Requests sharing a long prefix decode byte-identically to the
    reference engine's cold prefill — wave 2 hits the snapshots wave 1
    left behind and restores them on the device."""
    cfg, model, params, _, _ = pair(arch)
    _, sess = _sessions(cfg)
    cold = ref_tokens(arch, sess, 6)
    eng = ServeEngine(model, params, cfg, prefill_chunk=4,
                      prefix_entries=16, prefix_min_tokens=4, **ENGINE)
    _same(cold, eng.generate(sess, 6))           # wave 1: cold store
    _same(cold, eng.generate(sess, 6))           # wave 2: prefix hits
    assert eng.stats["prefix_hits"] >= 3
    assert eng.stats["prefix_hit_tokens"] >= 3 * 16
    assert eng.stats["restore_calls"] >= 1
    assert eng.stats["decode_calls"] == eng.stats["decode_steps"]


@pytest.mark.parametrize("arch", ALL_ARCHS)
def test_engine_multi_turn_hits_retirement_snapshot(arch):
    """Prefix-only mode (no chunk knob): a turn-2 prompt that extends
    turn 1's prompt + emitted tokens hits the retirement snapshot and
    stays exact against the reference engine."""
    cfg, model, params, _, _ = pair(arch)
    _, sess = _sessions(cfg)
    turn1 = ref_tokens(arch, sess, 6)
    turn2 = [np.concatenate([s, o, e]) for s, o, e in
             zip(sess, turn1, _prompts(cfg, [3, 4, 5], seed=9))]
    eng = ServeEngine(model, params, cfg, prefix_entries=16,
                      prefix_min_tokens=4, **ENGINE)
    _same(turn1, eng.generate(sess, 6))
    _same(ref_tokens(arch, turn2, 6), eng.generate(turn2, 6))
    assert eng.stats["prefix_hits"] >= 3


def test_windowed_ring_chunked_prompt_longer_than_window():
    """Chunked admission on a sliding-window arch whose prompt exceeds
    the KV ring: the ring keeps each row's newest window and the greedy
    output matches the reference engine (and the port's monolithic
    path)."""
    cfg, model, params, _, _ = pair("smollm-135m", sliding_window=8)
    ps = _prompts(cfg, [20, 13], seed=14)        # 20 > ring of 8
    ref = ref_tokens("smollm-135m", ps, 5, sliding_window=8)
    kw = dict(ENGINE, slots=2)
    _same(ref, ServeEngine(model, params, cfg, **kw).generate(ps, 5))
    eng = ServeEngine(model, params, cfg, prefill_chunk=6, **kw)
    _same(ref, eng.generate(ps, 5))
    assert eng.cache.data["k"].shape[2] == 8     # a ring of the window


def test_sliding_window_prompt_longer_than_ring():
    """A windowed arch admits prompts LONGER than its KV ring (the ring
    keeps each row's newest window) through monolithic admission —
    greedy matches teacher-forced windowed forward (the port's training
    forward, with the window mask, over prompt + generated tokens) and
    the reference engine."""
    cfg, model, params, _, _ = pair("smollm-135m", sliding_window=8)
    prompts = _prompts(cfg, [20, 13], seed=14)   # 20 > ring of 8
    outs = ServeEngine(model, params, cfg, slots=2,
                       capacity=64).generate(prompts, max_new_tokens=5)
    _same(ref_tokens("smollm-135m", prompts, 5, sliding_window=8), outs)
    for p, g in zip(prompts, outs):
        full = np.concatenate([p, g])[None]
        logits, _ = model.forward(params, torch.tensor(full))
        want = _np(logits)[0, len(p) - 1:full.shape[1] - 1].argmax(-1)
        np.testing.assert_array_equal(want, g)


def test_softcap_decode_matches_the_reference_jnp_decode():
    """The softcap at decode, model level: reduced smollm with
    attn_logit_softcap=2 (a cap that bites at this scale) prefills
    through the port and the reference, then 4 decode steps against the
    reference's jnp decode (``use_flash=False``, which applies the cap)
    within 1e-5, and away from the same model's decode without the cap.
    (tests/test_torch_lm.py holds one layer's capped decode against the
    reference's kernel path, which drops the cap.)"""
    cfg, model, params, rmodel, rparams = pair("smollm-135m",
                                               attn_logit_softcap=2.0)
    toks = _prompts(cfg, [9, 9], seed=21)
    toks = np.stack(toks)
    _, cache = model.prefill(params, torch.tensor(toks), cache_len=16)
    _, rcache = rmodel.prefill(rparams, jnp.asarray(toks), cache_len=16)
    _, plain, _, _, _ = pair("smollm-135m")
    _, ucache = plain.prefill(params, torch.tensor(toks), cache_len=16)
    rdecode = ref_jit(rmodel, "decode_step")
    apart = 0.0
    for t in np.random.default_rng(3).integers(0, cfg.vocab_size,
                                               (4, 2, 1)):
        lg, cache = model.decode_step(params, cache, torch.tensor(t))
        rl, rcache = rdecode(rparams, rcache, jnp.asarray(t))
        ul, ucache = plain.decode_step(params, ucache, torch.tensor(t))
        np.testing.assert_allclose(_np(lg), np.asarray(rl), **TOL)
        apart = max(apart, float(np.abs(_np(lg) - _np(ul)).max()))
    assert apart > 1e-3


# --------------------------------------------------- mid-flight robustness

def test_cancel_request_sharing_pinned_prefix():
    """Kill a request whose prefix entry is shared with (and pinned by)
    another live request: the survivor's tokens stay byte-identical to
    the reference engine's, the hold is released, and the entry
    survives for later hits."""
    cfg, model, params, _, _ = pair("qwen3-14b")
    shared = _prompts(cfg, [16], seed=3)[0]
    a = np.concatenate([shared, _prompts(cfg, [5], seed=4)[0]])
    b = np.concatenate([shared, _prompts(cfg, [6], seed=6)[0]])
    c = np.concatenate([shared, _prompts(cfg, [4], seed=8)[0]])
    ref_b, ref_c = ref_tokens("qwen3-14b", [b, c], 6)

    eng = ServeEngine(model, params, cfg, slots=2, capacity=64, seed=7,
                      prefill_chunk=4, prefix_entries=8,
                      prefix_min_tokens=4)
    eng.generate([shared], 2)        # primer seeds the store
    rid_a = eng.submit(a, 6)
    rid_b = eng.submit(b, 6)
    eng.step()                       # both mid-prefill, entries pinned
    held = [r.hold for r in eng._pending if r.hold is not None]
    assert held                      # at least one pinned hit
    assert all(eng.pool.meta[h].refs >= 1 for h in held)
    assert eng.cancel(rid_a)         # kill A mid-prefill
    finished = eng.run([])
    by_rid = {f.request.rid: f.tokens for f in finished}
    assert rid_a not in by_rid       # A never completes
    np.testing.assert_array_equal(by_rid[rid_b], ref_b)
    assert all(m.refs == 0 for m in eng.pool.meta.values())  # no leaks
    assert eng.cancel(999) is False  # unknown rid: no-op
    hits_before = eng.stats["prefix_hits"]
    np.testing.assert_array_equal(eng.generate([c], 6)[0], ref_c)
    assert eng.stats["prefix_hits"] > hits_before


def test_cancel_mid_decode_survivor_unaffected():
    """Cancelling a decoding request frees its slot without disturbing a
    concurrent slot's token stream (the reference engine's tokens)."""
    cfg, model, params, _, _ = pair("qwen3-14b")
    ps = _prompts(cfg, [6, 9], seed=11)
    ref = ref_tokens("qwen3-14b", ps, 8)
    eng = ServeEngine(model, params, cfg, slots=2, capacity=64, seed=7,
                      prefill_chunk=4)
    rid0 = eng.submit(ps[0], 8)
    rid1 = eng.submit(ps[1], 8)
    for _ in range(4):               # prefill done, a few decode steps
        eng.step()
    assert eng.cancel(rid0)
    finished = eng.run([])
    by_rid = {f.request.rid: f.tokens for f in finished}
    assert rid0 not in by_rid
    np.testing.assert_array_equal(by_rid[rid1], ref[1])
    assert eng.cache.free_slots == 2


# ----------------------------------------------------- admission limiting

def test_admit_limit_caps_admissions_per_tick():
    cfg, model, params, _, _ = pair("qwen3-14b")
    eng = ServeEngine(model, params, cfg, slots=4, capacity=64, seed=7,
                      admit_limit=1)
    ps = _prompts(cfg, [5, 5, 5, 5], seed=12)
    for p in ps:
        eng.submit(p, 4)
    eng.step()
    assert len(eng.scheduler.active) == 1    # one admission, not four
    out = eng.run([])
    by_rid = {f.request.rid: f.tokens for f in sorted(
        out, key=lambda f: f.request.rid)}
    _same(ref_tokens("qwen3-14b", ps, 4), list(by_rid.values()))


# ------------------------------------------- preemption x prefix store

def test_preempt_mid_decode_pins_snapshot_and_resumes_byte_identical():
    """Preempting a mid-decode request releases its slot but PINS its
    resident-state snapshot (prompt + emitted[:-1]) in the prefix store:
    while the continuation queues, the entry is hittable and cannot be
    evicted; re-admission replays it as a one-token suffix prefill and
    the stream resumes byte-identically (position-folded sampling, here
    top-k: the port's own keys, so the run is held against the port's
    FIFO run of the same submissions). Afterwards every hold drains to
    refs 0 and the entry is still hittable."""
    cfg, model, params, _, _ = pair("qwen3-14b")
    long_p, short_p = _prompts(cfg, [9, 6], seed=31)
    sampler = parse_sampler("top_k:8:0.8")
    slos = {0: TierSLO(1e-6, 10.0), 1: TierSLO(10.0, 60.0)}

    ref = ServeEngine(model, params, cfg, slots=1, capacity=64, seed=7,
                      sampler=sampler)
    r_long = ref.submit(long_p, 8, tier=1)
    r_short = ref.submit(short_p, 4, tier=0)
    ref_by = {f.request.rid: f.tokens for f in ref.run([])}

    eng = ServeEngine(model, params, cfg, slots=1, capacity=64, seed=7,
                      sampler=sampler, prefill_chunk=4, prefix_entries=8,
                      prefix_min_tokens=4, slos=slos)
    e_long = eng.submit(long_p, 8, tier=1)
    while not eng.scheduler.active or not any(
            st.emitted for st in eng.scheduler.active.values()):
        eng.step()                   # prefill + first decode tokens
    eng.step()
    eng.step()                       # a few emitted tokens
    e_short = eng.submit(short_p, 4, tier=0)
    eng.step()                       # preemption pass evicts the decode

    assert eng.stats["preemptions"] == 1
    (cont,) = [r for r in eng.scheduler.queued_requests()
               if r.rid == e_long]
    snap = tuple(int(t) for t in cont.tokens[:-1])
    assert eng._preempt_holds.get(e_long) is not None
    hold = eng._preempt_holds[e_long]
    assert eng.pool.meta[hold].refs >= 1     # pinned: unevictable
    assert eng.pool.has(snap)
    hits_before = eng.stats["prefix_hits"]

    fin = eng.run([])
    by = {f.request.rid: f for f in fin}
    assert by[e_long].preemptions == 1
    np.testing.assert_array_equal(by[e_long].tokens, ref_by[r_long])
    np.testing.assert_array_equal(by[e_short].tokens, ref_by[r_short])
    assert eng.stats["prefix_hits"] > hits_before
    assert eng.stats["prefix_hit_tokens"] >= len(snap)
    assert eng.stats["replayed_tokens"] >= 1
    assert eng.stats["decode_calls"] == eng.stats["decode_steps"]
    assert not eng._preempt_holds
    assert all(m.refs == 0 for m in eng.pool.meta.values())
    assert eng.pool.has(snap)
