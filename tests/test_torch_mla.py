"""The port's multi-head latent attention (``repro_torch.models.mla`` and
the MLA branches of ``models/lm.py``) on the CPU against the JAX
package: reduced deepseek-v2-236b in f32, the same seeded numpy inputs,
and the reference's initial params carried across by ``bridge``.

The reduced preset sets ``q_lora_rank`` 0 (queries through ``wq``);
every test also runs a nonzero rank (``Q_LORA``), the full width's path
through ``q_down``, ``q_norm`` and ``q_up``.

Tolerances, each measured here:
  * ``_queries``/``_latents``: within 9.6e-7 absolute (values up to 4.6);
    held at rtol/atol 1e-5.
  * ``mla_block``, stock and through ``flash_vjp`` + ``attn_q_chunk``:
    outputs within 4.8e-7 (values up to 0.9), gradients within 1.5e-6
    of each leaf's largest entry; held at rtol/atol 1e-5 and 1e-5 of the
    largest entry. In bf16 the outputs equal the reference's but for
    rounding in the f32 sums: within one bf16 ulp of values up to 0.9
    (held at rtol/atol 2^-7).
  * ``mla_decode`` (the absorbed form, every product in f32, against the
    reference's einsums): outputs within 3.0e-7, the caches equal; held
    at rtol/atol 1e-5.
  * the LM: logits within 9.5e-6 (values up to 4.1), losses 1.4e-7
    relative, gradients 2.6e-6 of each leaf's largest entry; held at
    rtol/atol 1e-5 for the logits, 1e-6 relative for the loss, 1e-5 of
    the largest entry.
  * prefill and 12 decode steps: logits and cache rows within 5.1e-6,
    held at rtol/atol 1e-5; the decode logits against the full
    forward's, within 1.1e-5 (the absorbed decode sums in another
    order than the expanded block), held at 5e-5; the engine's greedy
    tokens equal.
  * the striped absorbed decode (a serving mesh's, without ranks: one
    thread a stripe): the merged output within 4.8e-7 of ``mla_decode``
    on the whole cache and 1.1e-6 of the reference's (values up to 2.9),
    held at rtol 1e-5 / atol 1e-6 (``STRIPE_TOL``); an empty stripe's
    partial exactly (0, -inf).
"""

import dataclasses
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_get_config
from repro.configs import param_count as ref_param_count
from repro.models import build_model as ref_build_model
from repro.models import mla as rmla
from repro.serve import ServeEngine as RefServeEngine
from repro.train.step import _forward_and_loss as ref_forward_and_loss
from repro_torch import bridge
from repro_torch.configs import get_config, param_count
from repro_torch.distributed import collectives
from repro_torch.distributed.sharding import Stripe
from repro_torch.kernels.flash_decode import merge_stripes
from repro_torch.launch import serve as launch_serve
from repro_torch.launch import train as launch_train
from repro_torch.models import build_model, mla
from repro_torch.serve import ServeEngine
from repro_torch.train.step import value_and_grad
from repro_torch.treepath import path_str, tree_flatten_with_path, tree_leaves
from _torch_threads import one_torch_thread  # noqa: F401
from test_torch_serve import SCHEDULE, _drive

pytestmark = pytest.mark.usefixtures("one_torch_thread")

ARCH = "deepseek-v2-236b"
Q_LORA = 48
RANKS = [0, Q_LORA]
TOL = dict(rtol=1e-5, atol=1e-5)
BF16_TOL = dict(rtol=2 ** -7, atol=2 ** -7)
DECODE_VS_FORWARD = dict(rtol=5e-5, atol=5e-5)
# the striped decode against the whole cache's, f32 (measured 1.1e-6)
STRIPE_TOL = dict(rtol=1e-5, atol=1e-6)
LOSS_RTOL = 1e-6
GRAD_RTOL_OF_MAX = 1e-5
SEQ = 24
_CACHE = {}


def _cfgs(**changes):
    return (dataclasses.replace(ref_get_config(ARCH).reduced(), **changes),
            dataclasses.replace(get_config(ARCH).reduced(), **changes))


def _tokens(cfg, shape=(3, SEQ), seed=0):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, shape).astype(np.int32)


def _np(x):
    return x.detach().float().numpy() if torch.is_tensor(x) \
        else np.asarray(x, np.float32)


def _close(got, want, **tol):
    np.testing.assert_allclose(_np(got), _np(want), **(tol or TOL))


def _grads_close(got_leaves, want_tree):
    want = {path_str(tuple(k.key for k in p)): np.asarray(v) for p, v in
            jax.tree_util.tree_leaves_with_path(want_tree)}
    assert {path_str(p) for p, _ in got_leaves} == set(want)
    for path, g in got_leaves:
        w = want[path_str(path)]
        err = np.abs(_np(g) - w).max()
        assert err <= GRAD_RTOL_OF_MAX * np.abs(w).max(), (path, err)


# ------------------------------------------------------------------ config

def test_deepseek_config_is_the_references_and_counts_its_params():
    """get_config no longer refuses deepseek; the config field for field;
    param_count as the reference's at full size and at the two cuts the
    card runs (training: 2 layers, 16 routed experts; serving: 2 layers,
    all 160); a meta-device init of the training cut draws nothing and
    holds the analytic count plus its norm scales."""
    cfg, rcfg = get_config(ARCH), ref_get_config(ARCH)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(rcfg)
    assert param_count(cfg) == ref_param_count(rcfg)
    train = dataclasses.replace(cfg, num_layers=2, num_experts=16)
    serve = dataclasses.replace(cfg, num_layers=2)
    assert param_count(train)[0] == 2_196_537_344
    assert param_count(serve)[0] == 8_992_784_384
    gen = torch.Generator().manual_seed(0)
    state = gen.get_state()
    params = build_model(train).init(gen, "meta")
    assert torch.equal(gen.get_state(), state)
    n = sum(x.numel() for x in tree_leaves(params))
    L = train.num_layers
    norms = (2 * L + 1) * cfg.d_model + L * (cfg.q_lora_rank
                                             + cfg.kv_lora_rank)
    assert n == param_count(train)[0] + norms
    attn = params["layers"]["attn"]
    assert tuple(attn["q_up"].shape) == (2, 1536, 128 * 192)
    assert tuple(attn["kv_down"].shape) == (2, 5120, 512 + 64)
    assert attn["q_norm"].dtype == attn["kv_norm"].dtype == torch.float32


@pytest.mark.parametrize("q_lora", RANKS)
def test_init_layout_and_distributions(q_lora):
    """The port's own init: the reference's tree, shapes and dtypes, at
    its distributions; one seed, one set of weights."""
    rcfg, cfg = _cfgs(q_lora_rank=q_lora, dtype="bfloat16")
    rparams = jax.eval_shape(ref_build_model(rcfg).init, jax.random.key(0))
    model = build_model(cfg)
    p = model.init(torch.Generator().manual_seed(0), "cpu")
    got = {path_str(k): v for k, v in tree_flatten_with_path(p)[0]}
    want = {path_str(tuple(k.key for k in path)): leaf for path, leaf in
            jax.tree_util.tree_flatten_with_path(rparams)[0]}
    assert set(got) == set(want)
    for k, leaf in want.items():
        assert tuple(got[k].shape) == leaf.shape, k
        assert str(got[k].dtype).split(".")[-1] == str(leaf.dtype), k
    a, d = p["layers"]["attn"], cfg.d_model
    assert ("q_down" in a) == bool(q_lora) and ("wq" in a) == (not q_lora)
    assert abs(a["kv_down"].float().std().item() * d ** 0.5 - 1) < 0.05
    assert abs(a["v_up"].float().std().item()
               * cfg.kv_lora_rank ** 0.5 - 1) < 0.05
    again = model.init(torch.Generator().manual_seed(0), "cpu")
    assert all(torch.equal(x, y) for x, y in zip(tree_leaves(p),
                                                 tree_leaves(again)))


# ------------------------------------------------------------------- block

def _block_inputs(rcfg, seed=0, shape=(2, 16)):
    p = jax.tree_util.tree_map(np.asarray, rmla.init_mla(
        jax.random.key(seed), rcfg, rcfg.d_model, jnp.float32))
    x = np.random.default_rng(seed).standard_normal(
        shape + (rcfg.d_model,)).astype(np.float32)
    return p, x


@pytest.mark.parametrize("q_lora", RANKS)
def test_queries_and_latents_match_the_reference(q_lora):
    rcfg, cfg = _cfgs(q_lora_rank=q_lora)
    p, x = _block_inputs(rcfg, seed=1)
    pos = np.arange(x.shape[1])
    rp, tp = jax.tree_util.tree_map(jnp.asarray, p), bridge.params_to_torch(p)
    got = mla._queries(cfg, tp, torch.from_numpy(x), torch.tensor(pos)) + \
        mla._latents(cfg, tp, torch.from_numpy(x), torch.tensor(pos))
    want = rmla._queries(rcfg, rp, jnp.asarray(x), jnp.asarray(pos)) + \
        rmla._latents(rcfg, rp, jnp.asarray(x), jnp.asarray(pos))
    for g, w in zip(got, want):
        assert tuple(g.shape) == w.shape
        _close(g, w)


LEAN = {"stock": {}, "lean": dict(flash_vjp=True, attn_q_chunk=4)}


@pytest.mark.parametrize("lean", sorted(LEAN))
@pytest.mark.parametrize("q_lora", RANKS)
def test_mla_block_forward_and_gradients_match_the_reference(q_lora, lean):
    """Gradients of sum(out * r) to x and every leaf, f32."""
    rcfg, cfg = _cfgs(q_lora_rank=q_lora, **LEAN[lean])
    p, x = _block_inputs(rcfg, seed=2)
    pos = np.arange(x.shape[1])
    r = np.random.default_rng(3).standard_normal(x.shape).astype(np.float32)

    def ref_loss(p, x):
        out = rmla.mla_block(rcfg, p, x, jnp.asarray(pos))
        return jnp.sum(out * r), out

    (_, rout), (rgp, rgx) = jax.value_and_grad(
        ref_loss, argnums=(0, 1), has_aux=True)(
        jax.tree_util.tree_map(jnp.asarray, p), jnp.asarray(x))
    tp = bridge.params_to_torch(p)
    leaves = [(k, t.requires_grad_(True))
              for k, t in tree_flatten_with_path(tp)[0]]
    tx = torch.from_numpy(x).requires_grad_(True)
    out = mla.mla_block(cfg, tp, tx, torch.tensor(pos))
    _close(out, rout)
    grads = torch.autograd.grad((out * torch.from_numpy(r)).sum(),
                                [tx] + [t for _, t in leaves])
    _close(grads[0], rgx, rtol=0, atol=GRAD_RTOL_OF_MAX * np.abs(
        np.asarray(rgx)).max())
    _grads_close([(k, g) for (k, _), g in zip(leaves, grads[1:])], rgp)


def test_mla_block_in_bf16():
    rcfg, cfg = _cfgs(q_lora_rank=Q_LORA, dtype="bfloat16")
    p, x = _block_inputs(rcfg, seed=4)
    p = {k: np.asarray(jnp.asarray(v, jnp.bfloat16)) if v.ndim == 2 else v
         for k, v in p.items()}
    pos = np.arange(x.shape[1])
    rout = rmla.mla_block(rcfg, jax.tree_util.tree_map(jnp.asarray, p),
                          jnp.asarray(x, jnp.bfloat16), jnp.asarray(pos))
    out = mla.mla_block(cfg, bridge.params_to_torch(p),
                        torch.from_numpy(x).bfloat16(), torch.tensor(pos))
    assert out.dtype == torch.bfloat16
    _close(out, rout, **BF16_TOL)


@pytest.mark.parametrize("q_lora", RANKS)
def test_mla_decode_matches_the_reference_past_capacity(q_lora):
    """The absorbed decode on a live latent cache: one slot mid-cache,
    one at its last row, one past capacity (the reference clamps the
    write to the last row and attends every row)."""
    rcfg, cfg = _cfgs(q_lora_rank=q_lora)
    p, x = _block_inputs(rcfg, seed=5, shape=(3, 1))
    rng = np.random.default_rng(6)
    S = 10
    ckv = rng.standard_normal((3, S, cfg.kv_lora_rank)).astype(np.float32)
    krope = rng.standard_normal((3, S, cfg.qk_rope_dim)).astype(np.float32)
    pos = np.array([4, S - 1, S + 3], np.int32)
    rout, rckv, rkrope = rmla.mla_decode(
        rcfg, jax.tree_util.tree_map(jnp.asarray, p), jnp.asarray(x),
        jnp.asarray(ckv), jnp.asarray(krope), jnp.asarray(pos))
    tckv, tkrope = torch.from_numpy(ckv.copy()), torch.from_numpy(
        krope.copy())
    out, c1, c2 = mla.mla_decode(cfg, bridge.params_to_torch(p),
                                 torch.from_numpy(x), tckv, tkrope,
                                 torch.from_numpy(pos))
    assert c1 is tckv and c2 is tkrope                  # written in place
    _close(out, rout)
    _close(c1, rckv)
    _close(c2, rkrope)
    assert not np.array_equal(_np(c1)[2, S - 1], ckv[2, S - 1])


# ------------------------------------------------------ striped decode

STRIPE_ROWS = 6


class _Stripes:
    """The merge over ``count`` stripes without ranks: each stripe's
    ``mla_decode`` runs in a thread of its own, posts its partial (its
    stripe's index rides in ``Stripe.axis``) and, once every stripe has
    posted, merges all of them in stripe order, as
    ``collectives.merge_stripes`` merges the ranks' partials."""

    def __init__(self, count):
        self.parts = [None] * count
        self.barrier = threading.Barrier(count, timeout=60)

    def merge(self, out, lse, mesh, axis):
        self.parts[axis] = (out.clone(), lse.clone())
        self.barrier.wait()
        return merge_stripes([o for o, _ in self.parts],
                             [x for _, x in self.parts])


def _striped_decode(cfg, p, x, ckv, krope, pos, count, monkeypatch):
    """``mla_decode`` on ``count`` stripes of the caches (views: every
    stripe writes into ``ckv``/``krope``), one thread a stripe; each
    stripe's (out, lse) and every stripe's output."""
    stripes = _Stripes(count)
    monkeypatch.setattr(collectives, "merge_stripes", stripes.merge)
    rows = ckv.shape[1] // count
    outs = [None] * count

    def run(i):
        sl = slice(i * rows, (i + 1) * rows)
        outs[i] = mla.mla_decode(
            cfg, p, x, ckv[:, sl], krope[:, sl], pos,
            stripe=Stripe(i, count, rows, i, None))[0]

    threads = [threading.Thread(target=run, args=(i,)) for i in range(count)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert all(o is not None for o in outs), "a stripe failed"
    return stripes.parts, outs


@pytest.mark.parametrize("count", [2, 3, 4])
@pytest.mark.parametrize("q_lora", RANKS)
def test_striped_absorbed_decode_equals_the_whole_cache(q_lora, count,
                                                        monkeypatch):
    """The latent cache cut into 2, 3 and 4 stripes of STRIPE_ROWS rows:
    each stripe writes the new row only where it holds row min(pos, S-1)
    and attends its own valid rows; the merged output equals
    ``mla_decode`` on the whole cache and the reference's, and the
    caches equal the whole cache's, at lengths (pos + 1) 1, S/2, S and
    S + 7 (past capacity: the write clamps to row S-1). A stripe that
    holds no key of a row gives lse -inf and an output of exactly 0, so
    a row of length 1 merges to stripe 0's output bit for bit."""
    rcfg, cfg = _cfgs(q_lora_rank=q_lora)
    p, x = _block_inputs(rcfg, seed=11, shape=(4, 1))
    S = STRIPE_ROWS * count
    rng = np.random.default_rng(12)
    ckv = rng.standard_normal((4, S, cfg.kv_lora_rank)).astype(np.float32)
    krope = rng.standard_normal((4, S, cfg.qk_rope_dim)).astype(np.float32)
    pos = np.array([0, S // 2 - 1, S - 1, S + 6], np.int32)
    tp = bridge.params_to_torch(p)
    whole = [torch.from_numpy(ckv.copy()), torch.from_numpy(krope.copy())]
    want = mla.mla_decode(cfg, tp, torch.from_numpy(x), *whole,
                          torch.from_numpy(pos))[0]
    rout = rmla.mla_decode(rcfg, jax.tree_util.tree_map(jnp.asarray, p),
                           jnp.asarray(x), jnp.asarray(ckv),
                           jnp.asarray(krope), jnp.asarray(pos))[0]
    striped = [torch.from_numpy(ckv.copy()), torch.from_numpy(krope.copy())]
    parts, outs = _striped_decode(cfg, tp, torch.from_numpy(x), *striped,
                                  torch.from_numpy(pos), count, monkeypatch)
    for got in outs:
        assert torch.equal(got, outs[0])
        _close(got, want, **STRIPE_TOL)
        _close(got, rout, **STRIPE_TOL)
    for a, b in zip(striped, whole):
        assert torch.equal(a, b)
    valid = np.minimum(pos + 1, S)
    for i, (out, lse) in enumerate(parts):
        empty = torch.from_numpy(valid <= i * STRIPE_ROWS)
        assert torch.isneginf(lse[empty]).all()
        assert torch.isfinite(lse[~empty]).all()
        assert (out[empty] == 0).all()
    # row 0 (length 1) lies in stripe 0 alone: the merge is its partial
    merged = merge_stripes([o for o, _ in parts], [x for _, x in parts])
    assert torch.equal(merged[0], parts[0][0][0])


def _masked_softmax_partial(q_lat, q_rope, ckv, krope, lengths, scale):
    """A stripe's partial as a masked softmax takes it (scores set to
    NEG_INF past the length, then the softmax), for the test below: what
    ``latent_attention`` must not be."""
    s = (torch.einsum("bhr,bsr->bhs", q_lat, ckv)
         + torch.einsum("bhe,bse->bhs", q_rope, krope)) * scale
    valid = torch.arange(ckv.shape[1]) < lengths[:, None, None]
    s = torch.where(valid, s, mla.NEG_INF)
    return (torch.einsum("bhs,bsr->bhr", torch.softmax(s, -1), ckv),
            torch.logsumexp(s, -1))


@pytest.mark.parametrize("count", [2, 3, 4])
def test_latent_attention_stripes_merge_to_the_whole_cache(count):
    """``latent_attention`` on each stripe at its length clamp(n - lo, 0,
    rows) and ``merge_stripes``: the whole cache's attention over its
    first min(n, S) rows, for n in 0, 1, S/2, S and S + 7; a row no
    stripe holds a key of (n = 0) merges to exactly 0, with lse -inf in
    every stripe. A masked softmax fails that row: it averages an empty
    stripe's latents."""
    g = torch.Generator().manual_seed(13)
    S, r, e, H = STRIPE_ROWS * count, 16, 8, 3
    lengths = torch.tensor([0, 1, S // 2, S, S + 7])
    B = len(lengths)
    q_lat, q_rope = torch.randn(B, H, r, generator=g), \
        torch.randn(B, H, e, generator=g)
    ckv, krope = torch.randn(B, S, r, generator=g), \
        torch.randn(B, S, e, generator=g)
    scale = 0.3
    n = torch.clamp(lengths, max=S)
    s = (torch.einsum("bhr,bsr->bhs", q_lat, ckv)
         + torch.einsum("bhe,bse->bhs", q_rope, krope)) * scale
    s = torch.where(torch.arange(S) < n[:, None, None], s, -torch.inf)
    want = torch.nan_to_num(torch.einsum("bhs,bsr->bhr",
                                         torch.softmax(s, -1), ckv))

    def merged(partial):
        parts = []
        for i in range(count):
            sl = slice(i * STRIPE_ROWS, (i + 1) * STRIPE_ROWS)
            parts.append(partial(q_lat, q_rope, ckv[:, sl], krope[:, sl],
                                 torch.clamp(n - i * STRIPE_ROWS, 0,
                                             STRIPE_ROWS), scale))
        return parts, merge_stripes([o for o, _ in parts],
                                    [x for _, x in parts])

    parts, got = merged(mla.latent_attention)
    torch.testing.assert_close(got, want, **STRIPE_TOL)
    assert (got[0] == 0).all()
    assert all(torch.isneginf(x[0]).all() for _, x in parts)
    _, naive = merged(_masked_softmax_partial)
    assert not (naive[0] == 0).all()


# ---------------------------------------------------------------------- LM

def _init(q_lora):
    if q_lora not in _CACHE:
        rcfg, _ = _cfgs(q_lora_rank=q_lora)
        _CACHE[q_lora] = jax.tree_util.tree_map(
            np.asarray, ref_build_model(rcfg).init(jax.random.key(2)))
    return _CACHE[q_lora]


@pytest.mark.parametrize("q_lora,lean", [(0, "stock"), (Q_LORA, "lean")])
def test_lm_forward_loss_and_gradients_match_the_reference(q_lora, lean):
    changes = dict(LEAN[lean], q_lora_rank=q_lora)
    if lean == "lean":
        changes.update(loss_chunk=8, remat_block=1)
    rcfg, cfg = _cfgs(**changes)
    toks = _tokens(cfg)
    rmodel = ref_build_model(rcfg)

    def loss_fn(params):
        loss, (logits, aux) = ref_forward_and_loss(
            rmodel, rcfg, params, {"tokens": jnp.asarray(toks)})
        return loss, (logits, aux["aux_loss"])

    (rloss, (rlogits, raux)), rgrads = jax.jit(jax.value_and_grad(
        loss_fn, has_aux=True))(jax.tree_util.tree_map(jnp.asarray,
                                                       _init(q_lora)))
    model = build_model(cfg)
    params = bridge.lm_params_to_torch(_init(q_lora), model)
    loss, grads, (logits, aux) = value_and_grad(
        model, cfg, params, {"tokens": torch.from_numpy(toks)})
    if lean == "stock":
        _close(logits, rlogits)
    assert float(aux["aux_loss"]) > 0
    np.testing.assert_allclose(float(aux["aux_loss"]), float(raux),
                               rtol=LOSS_RTOL)
    assert abs(float(loss) - float(rloss)) <= LOSS_RTOL * abs(float(rloss))
    _grads_close(tree_flatten_with_path(grads)[0], rgrads)


def _lm_pair(q_lora):
    rcfg, cfg = _cfgs(q_lora_rank=q_lora)
    rmodel, model = ref_build_model(rcfg), build_model(cfg)
    return (cfg, model, bridge.lm_params_to_torch(_init(q_lora), model),
            rmodel, jax.tree_util.tree_map(jnp.asarray, _init(q_lora)))


@pytest.mark.parametrize("q_lora", RANKS)
def test_prefill_and_decode_through_the_latent_cache(q_lora):
    """Length-masked prefill into a latent cache, then 12 decode steps:
    logits and cache rows against the reference's after every step, and
    the decode logits against the full forward over each row's prompt
    and the tokens fed so far."""
    cfg, model, params, rmodel, rparams = _lm_pair(q_lora)
    toks = _tokens(cfg, (3, 10), 8)
    lens = np.array([10, 3, 6], np.int32)
    logits, cache = model.prefill(params, torch.tensor(toks), cache_len=24,
                                  lengths=torch.tensor(lens))
    rlogits, rcache = rmodel.prefill(rparams, jnp.asarray(toks),
                                     cache_len=24, lengths=jnp.asarray(lens))
    assert set(cache) == set(rcache) == {"pos", "ckv", "krope"}
    assert tuple(cache["ckv"].shape) == (2, 3, 24, cfg.kv_lora_rank)
    _close(logits, rlogits)
    for name in cache:
        _close(cache[name], rcache[name])
    feed = _tokens(cfg, (12, 3, 1), 9)
    seqs = [list(toks[b, :lens[b]]) for b in range(3)]
    ref_decode = jax.jit(rmodel.decode_step)
    for t in feed:
        logits, cache = model.decode_step(params, cache, torch.tensor(t))
        rlogits, rcache = ref_decode(rparams, rcache, jnp.asarray(t))
        _close(logits, rlogits)
        for name in cache:
            _close(cache[name], rcache[name])
        for b in range(3):
            seqs[b].append(int(t[b, 0]))
    for b in range(3):
        full, _ = model.forward(params, torch.tensor([seqs[b]]))
        _close(logits[b, 0], full[0, -1], **DECODE_VS_FORWARD)


def test_prefill_at_writes_only_the_admitted_slots():
    """Admission of two prompts into a live latent slot cache: the
    admitted slots' rows and pos as the reference's, every other slot's
    state untouched."""
    cfg, model, params, rmodel, rparams = _lm_pair(Q_LORA)
    rng = np.random.default_rng(6)
    rcache = {k: jnp.asarray(rng.standard_normal(v.shape), v.dtype)
              if k != "pos" else jnp.asarray([3, 5, 7, 9], jnp.int32)
              for k, v in rmodel.init_cache(4, 24).items()}
    cache = bridge.cache_to_torch(jax.device_get(rcache))
    before = {k: v.clone() for k, v in cache.items()}
    toks, lens = _tokens(cfg, (2, 8), 7), np.array([8, 5], np.int32)
    slots = np.array([2, 0], np.int32)
    logits, out = model.prefill_at(params, cache, torch.tensor(toks),
                                   torch.tensor(slots),
                                   lengths=torch.tensor(lens))
    rlogits, rout = rmodel.prefill_at(rparams, rcache, jnp.asarray(toks),
                                      jnp.asarray(slots),
                                      lengths=jnp.asarray(lens))
    assert out is cache
    _close(logits, rlogits)
    _close(out["pos"], rout["pos"])
    for name in ("ckv", "krope"):
        _close(out[name][:, :, :8], rout[name][:, :, :8])
        for s in (1, 3):                             # not admitted
            assert torch.equal(out[name][:, s], before[name][:, s])
        assert torch.equal(out[name][:, :, 8:], before[name][:, :, 8:])
    assert out["pos"].tolist() == [5, 5, 8, 9]


def test_engine_greedy_tokens_match_the_reference():
    """Staggered heterogeneous requests through 3 slots (idle slots
    decode with the rest), at the full width's query path: the same
    greedy tokens, finishing on the same ticks."""
    cfg, model, params, rmodel, rparams = _lm_pair(Q_LORA)
    kw = dict(slots=3, capacity=32, prefill_bucket=8)
    got = _drive(ServeEngine(model, params, cfg, **kw), SCHEDULE, cfg)
    want = _drive(RefServeEngine(rmodel, rparams, cfg=None, **kw),
                  SCHEDULE, cfg)
    assert got == want
    assert sorted(got[0]) == list(range(7))


# ------------------------------------------------------------------ launch

@pytest.mark.parametrize("optimizer,extra", [
    ("lars", []), ("lamb", []), ("adamw", []), ("sgd", []),
    ("lars", ["--precision", "bf16", "--opt-state-dtype", "int8",
              "--accum-steps", "2"])])
def test_launch_train_runs_deepseek_reduced_on_the_cpu(optimizer, extra):
    summary = launch_train.main([
        "--arch", ARCH, "--reduced", "--device", "cpu", "--steps", "2",
        "--batch", "4", "--seq", "16", "--optimizer", optimizer,
        "--log-every", "0", "--set", f"q_lora_rank={Q_LORA}"] + extra)
    assert summary["arch"] == ARCH + "-reduced"
    assert len(summary["losses"]) == 2
    assert all(np.isfinite(summary["losses"]))
    assert all(a > 0 for a in summary["aux_losses"])


def test_launch_serve_set_on_the_cpu(capsys):
    """``--set`` applies after ``--reduced``: one layer, a nonzero query
    rank; the report says so and decode launches no flash_decode."""
    rep = launch_serve.main(["--arch", ARCH, "--reduced", "--device", "cpu",
                             "--requests", "4", "--slots", "2", "--set",
                             "num_layers=1", "--set",
                             f"q_lora_rank={Q_LORA}"])
    assert rep["requests"] == 4 and rep["logits_finite"]
    assert rep["num_layers"] == 1 and rep["flash_decode_launches"] == 0
    assert "0 per tick on the card" in capsys.readouterr().out
