"""The port's dense language model (``repro_torch.models``: layers, mlp,
attention, lm) on the CPU against the JAX package, on the same seeded
numpy inputs and the same params (the reference's init carried over by
``bridge.lm_params_to_torch``), for ``smollm-135m.reduced()`` (4 heads
over 1 kv head, head_dim 72) and a reduced GQA variant (9 heads over 3
kv heads, G = 3, head_dim 32, smollm's grouping).

Tolerances in f32 (measured here: logits <= 1.5e-6 absolute on values
of order one, cache rows <= 5e-6): atol and rtol 1e-5 — the same f32
function with sums taken in another order (XLA's and PyTorch's CPU
matmuls and reductions). bf16 norms: one bf16 ulp (rtol 2^-7). The
whole model in bf16, as served: see ``BF16_LOGITS``/``BF16_CACHE``.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as REF_ARCHS
from repro.configs import get_config as ref_get_config
from repro.configs import param_count as ref_param_count
from repro.models import attention as RA
from repro.models import build_model as ref_build_model
from repro.models import layers as RL
from repro.models import mlp as RM
from repro_torch import bridge
from repro_torch.configs import ModelConfig, get_config, param_count
from repro_torch.models import attention as A
from repro_torch.models import build_model
from repro_torch.models import layers as L
from repro_torch.models import mlp as M
from repro_torch.serve import ServeEngine
from repro_torch.train.step import value_and_grad
from repro_torch.treepath import tree_leaves

TOL = dict(rtol=1e-5, atol=1e-5)
GQA = dict(num_heads=9, num_kv_heads=3, head_dim=32)
VARIANTS = {"reduced": {}, "gqa": GQA}
_MODELS = {}


def _pair(variant):
    """(port cfg, port model, port params, ref model, ref params)."""
    if variant not in _MODELS:
        changes = VARIANTS[variant]
        rcfg = dataclasses.replace(ref_get_config("smollm-135m").reduced(),
                                   **changes)
        cfg = dataclasses.replace(get_config("smollm-135m").reduced(),
                                  **changes)
        rmodel = ref_build_model(rcfg)
        rparams = rmodel.init(jax.random.key(1))
        model = build_model(cfg)
        params = bridge.lm_params_to_torch(jax.device_get(rparams), model)
        _MODELS[variant] = (cfg, model, params, rmodel, rparams)
    return _MODELS[variant]


def _np(x):
    return np.asarray(x, np.float32) if not torch.is_tensor(x) \
        else x.detach().float().numpy()


def _close(got, want, **tol):
    np.testing.assert_allclose(_np(got), _np(want), **(tol or TOL))


def _tokens(cfg, shape, seed):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, shape).astype(np.int32)


# ------------------------------------------------------------------ config

def test_smollm_config_matches_reference():
    assert dataclasses.asdict(get_config("smollm-135m")) == \
        dataclasses.asdict(ref_get_config("smollm-135m"))
    assert get_config("smollm-135m").attn_dims == (9, 3, 64)


@pytest.mark.parametrize("arch", sorted(REF_ARCHS))
def test_derived_config_parts_match_reference(arch):
    """attn_dims, reduced() and param_count on every reference config."""
    rcfg = ref_get_config(arch)
    cfg = ModelConfig(**dataclasses.asdict(rcfg))
    assert cfg.attn_dims == rcfg.attn_dims
    assert dataclasses.asdict(cfg.reduced()) == \
        dataclasses.asdict(rcfg.reduced())
    assert param_count(cfg) == ref_param_count(rcfg)
    assert param_count(cfg.reduced()) == ref_param_count(rcfg.reduced())


# -------------------------------------------------------------------- init

def test_init_layout_and_distributions():
    """The port's own init: the reference's tree, shapes and dtypes, at
    its distributions (fan-in normal, embed std 0.02, norms at one)."""
    cfg, model, _, rmodel, rparams = _pair("gqa")
    p = model.init(torch.Generator().manual_seed(0), "cpu")
    flat = jax.tree_util.tree_flatten_with_path(rparams)[0]
    for path, leaf in flat:
        keys = [k.key for k in path]
        t = p
        for k in keys:
            t = t[k]
        assert tuple(t.shape) == leaf.shape, keys
        assert str(t.dtype).split(".")[-1] == str(leaf.dtype), keys
    assert abs(p["embed"].std().item() - 0.02) < 1e-3
    wq = p["layers"]["attn"]["wq"]
    assert abs(wq.std().item() * cfg.d_model ** 0.5 - 1.0) < 0.03
    assert torch.equal(p["layers"]["ln1"]["scale"],
                       torch.ones(cfg.num_layers, cfg.d_model))
    marker = model.stacked_marker(p)
    assert marker["layers"]["mlp"]["wi"] is True
    assert marker["embed"] is False and marker["final_norm"]["scale"] is False
    # param_count is analytic and leaves out the norm scales
    norms = (2 * cfg.num_layers + 1) * cfg.d_model
    n = sum(x.numel() for x in tree_leaves(p))
    assert n == param_count(cfg)[0] + norms


# ------------------------------------------------------------------ layers

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rmsnorm_and_layernorm_match_reference(dtype):
    rng = np.random.default_rng(0)
    x = rng.standard_normal((3, 5, 48), np.float32) * 3
    s = rng.standard_normal(48).astype(np.float32)
    b = rng.standard_normal(48).astype(np.float32)
    jx = jnp.asarray(x, dtype)
    tx = torch.tensor(np.asarray(jx.astype(jnp.float32))).to(
        getattr(torch, dtype))
    tol = TOL if dtype == "float32" else dict(rtol=2 ** -7, atol=1e-6)
    got = L.rmsnorm(tx, torch.tensor(s))
    assert got.dtype == tx.dtype
    _close(got, RL.rmsnorm(jx, jnp.asarray(s)), **tol)
    _close(L.layernorm(tx, torch.tensor(s), torch.tensor(b)),
           RL.layernorm(jx, jnp.asarray(s), jnp.asarray(b)),
           **(tol if dtype == "float32" else dict(rtol=2 ** -6, atol=2e-2)))


def test_rope_and_mlp_match_reference():
    cfg, _, params, _, rparams = _pair("gqa")
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 7, 3, 32), np.float32)
    pos = np.stack([np.arange(7), np.arange(7) + 100]).astype(np.int32)
    _close(L.apply_rope(torch.tensor(x), torch.tensor(pos), 10000.0),
           RL.apply_rope(jnp.asarray(x), jnp.asarray(pos), 10000.0))
    h = rng.standard_normal((2, 5, cfg.d_model), np.float32)
    p0 = {k: v[0] for k, v in params["layers"]["mlp"].items()}
    r0 = {k: v[0] for k, v in rparams["layers"]["mlp"].items()}
    _close(M.mlp_block(cfg, p0, torch.tensor(h)),
           RM.mlp_block(cfg, r0, jnp.asarray(h)))


# --------------------------------------------------------------- attention

def _layer0(variant):
    cfg, _, params, _, rparams = _pair(variant)
    return (cfg, {k: v[0] for k, v in params["layers"]["attn"].items()},
            {k: v[0] for k, v in rparams["layers"]["attn"].items()})


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_qkv_project_matches_reference(variant):
    cfg, p, rp = _layer0(variant)
    x = np.random.default_rng(2).standard_normal((2, 6, cfg.d_model),
                                                 np.float32)
    pos = np.arange(6, dtype=np.int32)
    for got, want in zip(
            A.qkv_project(cfg, p, torch.tensor(x), torch.tensor(pos)),
            RA.qkv_project(cfg, rp, jnp.asarray(x), jnp.asarray(pos))):
        _close(got, want)


@pytest.mark.parametrize("variant", sorted(VARIANTS))
@pytest.mark.parametrize("kv_chunk", [1024, 7])
def test_prefill_attention_core_matches_reference(variant, kv_chunk):
    """Causal prefill attention, queries at per-row positions, in one KV
    block and in chunks of 7 keys (a short last chunk)."""
    cfg, _, _ = _layer0(variant)
    H, Hkv, hd = cfg.attn_dims
    rng = np.random.default_rng(3)
    q = rng.standard_normal((2, 20, H, hd), np.float32)
    k, v = (rng.standard_normal((2, 20, Hkv, hd), np.float32)
            for _ in range(2))
    pos = np.stack([np.arange(20), np.arange(20) // 2]).astype(np.int32)
    got = A.attention_core(torch.tensor(q), torch.tensor(k), torch.tensor(v),
                           q_positions=torch.tensor(pos), kv_chunk=kv_chunk)
    want = RA.attention_core(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                             q_positions=jnp.asarray(pos), kv_chunk=kv_chunk)
    _close(got, want)


@pytest.mark.parametrize("variant", sorted(VARIANTS))
@pytest.mark.parametrize("ref_flash", [True, False])
def test_decode_attention_matches_reference(variant, ref_flash):
    """One token against a cache (the port: the kernel's plain version
    on the CPU) against both reference paths, its Pallas kernel in
    interpret mode and its jnp core; the new K/V row lands where the
    reference writes it."""
    cfg, p, rp = _layer0(variant)
    _, Hkv, hd = cfg.attn_dims
    rng = np.random.default_rng(4)
    S = 16
    x = rng.standard_normal((3, 1, cfg.d_model), np.float32)
    ck, cv = (rng.standard_normal((3, S, Hkv, hd), np.float32)
              for _ in range(2))
    pos = np.array([0, 7, S - 1], np.int32)
    tk, tv = torch.tensor(ck), torch.tensor(cv)
    out, k2, v2 = A.decode_attention(cfg, p, torch.tensor(x), tk, tv,
                                     torch.tensor(pos))
    assert k2 is tk and v2 is tv                   # written in place
    rout, rk, rv = RA.decode_attention(cfg, rp, jnp.asarray(x),
                                       jnp.asarray(ck), jnp.asarray(cv),
                                       jnp.asarray(pos), use_flash=ref_flash)
    _close(out, rout)
    _close(k2, rk)
    _close(v2, rv)


# ---------------------------------------------------------------- the model

@pytest.mark.parametrize("variant", sorted(VARIANTS))
@pytest.mark.parametrize("masked", [False, True])
def test_prefill_matches_reference(variant, masked):
    cfg, model, params, rmodel, rparams = _pair(variant)
    toks = _tokens(cfg, (3, 12), 5)
    lens = np.array([12, 4, 9], np.int32) if masked else None
    tl = torch.tensor(lens) if masked else None
    logits, cache = model.prefill(params, torch.tensor(toks), cache_len=20,
                                  lengths=tl)
    rlogits, rcache = rmodel.prefill(
        rparams, jnp.asarray(toks), cache_len=20,
        lengths=None if lens is None else jnp.asarray(lens))
    _close(logits, rlogits)
    assert sorted(cache) == sorted(rcache)
    for name in cache:
        assert tuple(cache[name].shape) == rcache[name].shape
        _close(cache[name], rcache[name])
    if masked:                     # pos is a copy, not the caller's tensor
        assert cache["pos"].data_ptr() != tl.data_ptr()


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_prefill_at_admits_into_a_live_cache_like_the_reference(variant):
    cfg, model, params, rmodel, rparams = _pair(variant)
    rng = np.random.default_rng(6)
    rcache = rmodel.init_cache(4, 24)
    rcache = {k: jnp.asarray(rng.standard_normal(v.shape), v.dtype)
              if k != "pos" else jnp.asarray([3, 5, 7, 9], jnp.int32)
              for k, v in rcache.items()}
    cache = bridge.cache_to_torch(jax.device_get(rcache))
    toks = _tokens(cfg, (2, 8), 7)
    lens = np.array([8, 5], np.int32)
    slots = np.array([2, 0], np.int32)
    logits, out = model.prefill_at(params, cache, torch.tensor(toks),
                                   torch.tensor(slots),
                                   lengths=torch.tensor(lens))
    assert out is cache
    before = {k: v.clone() for k, v in cache.items()}
    rlogits, rout = rmodel.prefill_at(rparams, rcache, jnp.asarray(toks),
                                      jnp.asarray(slots),
                                      lengths=jnp.asarray(lens))
    _close(logits, rlogits)
    _close(out["pos"], rout["pos"])
    for name in ("k", "v"):
        # the admitted slots' prompt rows, every other slot whole; the
        # admitted slots' rows past the prompt buffer keep what they
        # held (the reference zeroes them; decode never reads them)
        _close(out[name][:, :, :8], rout[name][:, :, :8])
        _close(out[name][:, [1, 3]], rout[name][:, [1, 3]])
        assert torch.equal(out[name][:, slots, 8:],
                           before[name][:, slots, 8:])
    t = _tokens(cfg, (4, 1), 12)
    logits, out = model.decode_step(params, out, torch.tensor(t))
    rlogits, rout = rmodel.decode_step(rparams, rout, jnp.asarray(t),
                                       use_flash=True)
    _close(logits, rlogits)
    with pytest.raises(ValueError, match="exceeds cache capacity"):
        model.prefill_at(params, cache, torch.zeros(1, 25, dtype=torch.int32),
                         torch.tensor([1]))


@pytest.mark.parametrize("variant", sorted(VARIANTS))
@pytest.mark.parametrize("use_flash", ["auto", False])
def test_decode_steps_match_reference(variant, use_flash):
    """Prefill, then 4 decode steps fed the same tokens: logits and the
    cache after every step, against the reference's Pallas (interpret)
    and jnp decode paths; ``use_flash`` "auto" and False both take CPU
    tensors and the one path."""
    cfg, model, params, rmodel, rparams = _pair(variant)
    toks = _tokens(cfg, (3, 10), 8)
    lens = np.array([10, 3, 6], np.int32)
    _, cache = model.prefill(params, torch.tensor(toks), cache_len=16,
                             lengths=torch.tensor(lens))
    _, rcache = rmodel.prefill(rparams, jnp.asarray(toks), cache_len=16,
                               lengths=jnp.asarray(lens))
    feed = _tokens(cfg, (4, 3, 1), 9)
    for t in feed:
        logits, out = model.decode_step(params, cache, torch.tensor(t),
                                        use_flash=use_flash)
        assert out is cache and logits.shape == (3, 1, cfg.vocab_size)
        rlogits, rcache = rmodel.decode_step(
            rparams, rcache, jnp.asarray(t), use_flash=use_flash == "auto")
        _close(logits, rlogits)
        for name in cache:
            _close(cache[name], rcache[name])


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_decode_past_capacity_clamps_like_the_reference(variant):
    """An idle slot keeps decoding past its capacity: the reference
    clamps the K/V write to row S-1 and attends every row; the port
    writes at min(pos, S-1) and attends S rows. 6 steps from pos S-2
    on an S = 8 cache, against the reference's jnp and flash paths."""
    cfg, model, params, rmodel, rparams = _pair(variant)
    S = 8
    toks = _tokens(cfg, (2, S), 10)
    lens = np.array([S - 2, 3], np.int32)
    _, cache = model.prefill(params, torch.tensor(toks), cache_len=S,
                             lengths=torch.tensor(lens))
    _, rcache = rmodel.prefill(rparams, jnp.asarray(toks), cache_len=S,
                               lengths=jnp.asarray(lens))
    rflash = dict(rcache)
    for t in _tokens(cfg, (6, 2, 1), 11):
        logits, _ = model.decode_step(params, cache, torch.tensor(t))
        rlogits, rcache = rmodel.decode_step(rparams, rcache, jnp.asarray(t))
        flogits, rflash = rmodel.decode_step(rparams, rflash, jnp.asarray(t),
                                             use_flash=True)
        _close(logits, rlogits)
        _close(logits, flogits)
        for name in cache:
            _close(cache[name], rcache[name])
    assert cache["pos"].tolist() == [S + 4, 9]
    assert torch.isfinite(logits).all()


# ------------------------------------------------------------ bf16 path

# bf16 params and cache, as served. The port and the reference compute
# the same bf16 function: qkv_project, rmsnorm and attention_core agree
# exactly, mlp_block within one bf16 ulp (silu and the d_ff sums are
# rounded in another order), the final logits matmul within 2.4e-4.
# Measured over prefill, prefill_at and 6 decode steps: logits <= 0.022
# on values <= 1.52, cache rows <= 0.047 on values <= 3.96. Held at
# four bf16 ulps of the largest magnitude: 2^-5 on logits (< 2), 2^-4
# on cache rows (< 4).
BF16_LOGITS = dict(rtol=0, atol=2 ** -5)
BF16_CACHE = dict(rtol=0, atol=2 ** -4)
_BF16 = {}


def _pair_bf16(variant):
    if variant not in _BF16:
        changes = dict(VARIANTS[variant], dtype="bfloat16")
        rcfg = dataclasses.replace(ref_get_config("smollm-135m").reduced(),
                                   **changes)
        cfg = dataclasses.replace(get_config("smollm-135m").reduced(),
                                  **changes)
        rmodel = ref_build_model(rcfg)
        rparams = rmodel.init(jax.random.key(1))
        model = build_model(cfg)
        params = bridge.lm_params_to_torch(jax.device_get(rparams), model)
        _BF16[variant] = (cfg, model, params, rmodel, rparams)
    return _BF16[variant]


def _greedy_within_tol(logits, rlogits):
    """The port's greedy pick is the reference's, or ties it within the
    logits tolerance in the reference's own logits."""
    got = _np(logits).reshape(-1, logits.shape[-1])
    want = _np(rlogits).reshape(got.shape)
    pick = got.argmax(-1)
    rows = np.arange(len(pick))
    gap = want.max(-1) - want[rows, pick]
    assert (gap <= BF16_LOGITS["atol"]).all(), gap


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_bf16_prefill_prefill_at_and_decode_match_reference(variant):
    """The served precision: bf16 params and cache through prefill,
    prefill_at into a live cache and 6 teacher-forced decode steps
    (the reference's Pallas kernel in interpret mode)."""
    cfg, model, params, rmodel, rparams = _pair_bf16(variant)
    assert params["embed"].dtype == torch.bfloat16
    toks = _tokens(cfg, (3, 10), 5)
    lens = np.array([10, 3, 6], np.int32)
    logits, cache = model.prefill(params, torch.tensor(toks), cache_len=16,
                                  lengths=torch.tensor(lens))
    rlogits, rcache = rmodel.prefill(rparams, jnp.asarray(toks),
                                     cache_len=16, lengths=jnp.asarray(lens))
    assert cache["k"].dtype == torch.bfloat16 and logits.dtype == torch.float32
    _close(logits, rlogits, **BF16_LOGITS)
    _greedy_within_tol(logits, rlogits)
    for name in ("k", "v"):
        _close(cache[name], rcache[name], **BF16_CACHE)

    rng = np.random.default_rng(6)
    rcache = {k: jnp.asarray(rng.standard_normal(v.shape), v.dtype)
              if k != "pos" else jnp.asarray([3, 5, 7, 9], jnp.int32)
              for k, v in rmodel.init_cache(4, 24).items()}
    cache = bridge.cache_to_torch(jax.device_get(rcache))
    toks = _tokens(cfg, (2, 8), 7)
    lens, slots = np.array([8, 5], np.int32), np.array([2, 0], np.int32)
    logits, cache = model.prefill_at(params, cache, torch.tensor(toks),
                                     torch.tensor(slots),
                                     lengths=torch.tensor(lens))
    rlogits, rcache = rmodel.prefill_at(rparams, rcache, jnp.asarray(toks),
                                        jnp.asarray(slots),
                                        lengths=jnp.asarray(lens))
    _close(logits, rlogits, **BF16_LOGITS)
    _greedy_within_tol(logits, rlogits)
    for t in _tokens(cfg, (6, 4, 1), 9):
        logits, cache = model.decode_step(params, cache, torch.tensor(t))
        rlogits, rcache = rmodel.decode_step(rparams, rcache, jnp.asarray(t),
                                             use_flash=True)
        _close(logits, rlogits, **BF16_LOGITS)
        _greedy_within_tol(logits, rlogits)
    pos = cache["pos"].tolist()
    assert pos == np.asarray(rcache["pos"]).tolist()
    for name in ("k", "v"):
        for b in range(4):          # the rows each slot has written
            _close(cache[name][:, b, :pos[b]],
                   rcache[name][:, b, :pos[b]], **BF16_CACHE)


# -------------------------------------------------------- what is refused

@pytest.mark.parametrize("change", [
    {"family": "encdec"}, {"arch": "zamba2-7b", "sliding_window": 64},
    {"sliding_window": 64}, {"attn_logit_softcap": 30.0},
    {"arch": "zamba2-7b", "attn_logit_softcap": 30.0}, {"family": "vlm"},
    {"sliding_window": 64, "use_mla": True},
    {"attn_logit_softcap": 30.0, "use_mla": True}])
def test_unported_features_raise(change):
    """What the port still refuses, and what it no longer refuses. The
    encdec and vlm families build, and the serving engine refuses them
    with the reference's reason. MLA with a sliding window or the logit
    softcap raises wherever a decode cache is made (``init_cache``,
    ``prefill``, the serving engine) and in training: the reference's
    MLA ignores both. A window and the softcap with GQA and in the
    hybrid's shared block, which raised until the ring cache and the
    decode softcap were ported, now build their cache (a window's is a
    ring of ``window`` rows) and serve: prefill and 3 greedy decode
    steps from the reference's params give the reference's logits (its
    jnp decode, which applies the cap) within 1e-5, and training stays
    finite."""
    change = dict(change)
    arch = change.pop("arch", "deepseek-v2-236b" if change.get("use_mla")
                      else "smollm-135m")
    cfg = dataclasses.replace(get_config(arch).reduced(), **change)
    if "family" in change:
        # the encdec and vlm families build (they are ported; an
        # encoder-decoder with an encoder), and the serving engine
        # refuses them with the reference's reason
        if cfg.family == "encdec":
            cfg = dataclasses.replace(cfg, encoder_layers=1, encoder_seq=8)
        model = build_model(cfg)
        params = model.init(torch.Generator().manual_seed(0), "cpu")
        with pytest.raises(ValueError, match=f"got '{cfg.family}'"):
            ServeEngine(model, params, cfg, slots=1, capacity=8)
        return
    tok = torch.zeros(1, 4, dtype=torch.int32)
    if cfg.use_mla:
        model = build_model(cfg)
        params = model.init(torch.Generator().manual_seed(0), "cpu")
        for call in (lambda: model.init_cache(1, 8),
                     lambda: model.prefill(params, tok),
                     lambda: ServeEngine(model, params, cfg, slots=1,
                                         capacity=8)):
            with pytest.raises(NotImplementedError, match="not yet ported"):
                call()
        with pytest.raises(NotImplementedError, match="ignores both"):
            value_and_grad(model, cfg, params, {"tokens": tok})
        return
    rcfg = dataclasses.replace(ref_get_config(arch).reduced(), **change)
    if arch == "zamba2-7b":             # the shared block after layers 0, 2
        cfg = dataclasses.replace(cfg, num_layers=3)
        rcfg = dataclasses.replace(rcfg, num_layers=3)
    rmodel = ref_build_model(rcfg)
    rparams = rmodel.init(jax.random.key(1))
    model = build_model(cfg)
    params = bridge.lm_params_to_torch(jax.device_get(rparams), model)
    cache = model.init_cache(2, 96)
    rcache = rmodel.init_cache(2, 96)
    for name in cache:
        assert tuple(cache[name].shape) == tuple(rcache[name].shape), name
    toks = _tokens(cfg, (2, 80), 11)    # longer than a window of 64
    lens = np.array([80, 37], np.int32)
    logits, cache = model.prefill(params, torch.tensor(toks), cache_len=96,
                                  lengths=torch.tensor(lens))
    if arch == "zamba2-7b" and cfg.attn_logit_softcap:
        # the reference's hybrid prefill drops the cap its chunked
        # prefill (and decode, and training) applies: the port's prefill
        # is held against one whole-prompt chunk
        rlogits, rcache = rmodel.prefill_chunk_at(
            rparams, rcache, jnp.asarray(toks), jnp.arange(2),
            start=jnp.zeros(2, jnp.int32), chunk_lengths=jnp.asarray(lens))
    else:
        rlogits, rcache = rmodel.prefill(rparams, jnp.asarray(toks),
                                         cache_len=96,
                                         lengths=jnp.asarray(lens))
    _close(logits, rlogits)
    for t in _tokens(cfg, (3, 2, 1), 12):
        logits, cache = model.decode_step(params, cache, torch.tensor(t))
        rlogits, rcache = rmodel.decode_step(rparams, rcache, jnp.asarray(t))
        _close(logits, rlogits)
    engine = ServeEngine(model, params, cfg, slots=1, capacity=8)
    assert engine.generate([np.arange(3)], 2)[0].shape == (2,)
    assert engine.logits_finite
    loss, _, _ = value_and_grad(model, cfg, params, {"tokens": tok})
    assert torch.isfinite(loss)


def test_softcap_is_refused_on_the_kernel_path():
    """The reference's flash path drops the softcap its jnp path applies.
    The port refused the cap at decode until it picked a behaviour: the
    jnp path's and training's, s = cap * tanh(s / cap) on each scaled
    score, inside the kernel (its plain version here). One decode step
    of a GQA layer against the reference's jnp decode (``use_flash=
    False``) within 1e-5 — and away from its kernel path's uncapped
    output, which the cap changes at this scale."""
    cfg, p, rp = _layer0("gqa")
    capped = dataclasses.replace(cfg, attn_logit_softcap=2.0)
    rcapped = dataclasses.replace(
        ref_get_config("smollm-135m").reduced(), **GQA,
        attn_logit_softcap=2.0)
    rng = np.random.default_rng(13)
    x = rng.standard_normal((3, 1, cfg.d_model)).astype(np.float32) * 4
    c = rng.standard_normal((3, 16, 3, 32)).astype(np.float32) * 4
    pos = np.array([15, 4, 0], np.int32)
    out, _, _ = A.decode_attention(capped, p, torch.tensor(x),
                                   torch.tensor(c), torch.tensor(c.copy()),
                                   torch.tensor(pos))
    want, _, _ = RA.decode_attention(rcapped, rp, jnp.asarray(x),
                                     jnp.asarray(c), jnp.asarray(c),
                                     jnp.asarray(pos), use_flash=False)
    _close(out, want)
    uncapped, _, _ = RA.decode_attention(rcapped, rp, jnp.asarray(x),
                                         jnp.asarray(c), jnp.asarray(c),
                                         jnp.asarray(pos), use_flash=True)
    assert np.abs(_np(out) - _np(uncapped)).max() > 1e-3


def test_use_flash_is_a_placement_check():
    cfg, model, params, _, _ = _pair("reduced")
    cache = model.init_cache(1, 8)
    tok = torch.zeros(1, 1, dtype=torch.int32)
    with pytest.raises(ValueError, match="needs CUDA"):
        model.decode_step(params, cache, tok, use_flash=True)
    with pytest.raises(ValueError, match="must be"):
        model.decode_step(params, cache, tok, use_flash="yes")


def test_bridge_checks_shapes_and_carries_caches():
    cfg, model, params, rmodel, rparams = _pair("reduced")
    bad = jax.device_get(rparams)
    bad["layers"]["mlp"]["wi"] = bad["layers"]["mlp"]["wi"][:, :, :5]
    with pytest.raises(ValueError, match="mlp/wi"):
        bridge.lm_params_to_torch(bad, model)
    missing = jax.device_get(rparams)
    del missing["final_norm"]
    with pytest.raises(ValueError, match="missing"):
        bridge.lm_params_to_torch(missing, model)
    rcache = jax.device_get(rmodel.init_cache(2, 4))
    cache = bridge.cache_to_torch(rcache)
    assert cache["pos"].dtype == torch.int32
    back = bridge.cache_to_numpy(cache)
    for k in rcache:
        np.testing.assert_array_equal(back[k], rcache[k])
