"""The port's selective state-space blocks (``repro_torch.models.ssm``)
and the SSM family of ``models/lm.py`` (falcon-mamba-7b, Mamba-1) on the
CPU against the JAX package: the same seeded numpy inputs, reduced
configs in f32, and the reference's params carried across by
``bridge``. The LM checks are functions of the arch, which
tests/test_torch_hybrid.py runs for zamba2-7b.

Within a chunk the port's Mamba-1 scan runs the reference's
``associative_scan`` tree in torch ops, and XLA fuses it its own way;
its backward pass is the port's own (the adjoint recurrence, checked
against finite differences in f64); the SSD einsums contract in another
order; so the sums differ in rounding. Tolerances, each measured here (max abs differences):
  * ``causal_conv1d``, with and without state and lengths: equal bit
    for bit; held at rtol/atol 1e-6. ``_scan`` against
    ``lax.associative_scan``: decays equal, inputs within 4.8e-7; held at
    1e-6.
  * the blocks at chunks 24 and 7: Mamba-1 outputs within 7.7e-7 of
    values up to 0.85, Mamba-2 within 8.1e-6 of values up to 11.5;
    with a carried state and lengths 8.3e-7 and 2.3e-6; gradients
    within 1.4e-6 (Mamba-1) and 3.2e-6 (Mamba-2) of each leaf's largest
    entry. Held at rtol/atol 1e-5, and 1e-5 of the largest entry. The
    large-dt loss within 6.1e-8 relative, held at 1e-5.
  * the LM (2 layers): logits within 4.5e-6 of values up to 4.3, the
    loss within 2.1e-7 relative, gradients within 1.6e-6 of each leaf's
    largest entry; held at rtol/atol 1e-5, 1e-6 and 1e-5 of the largest
    entry. 4 LARS steps: losses within 1.4e-7 relative, held at 1e-6.
  * decode after a prefill of S-1 tokens (against the full forward's
    last logits and the reference's) and 12 more decode steps: within
    5.2e-6; the lengths-masked prefill against each row prefilled alone
    and the reference's: 3.2e-6; ``prefill_at``: 3.9e-6. Held at
    rtol/atol 1e-5. The engine's greedy tokens equal.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core as ref_core
from repro.core import packing as ref_packing
from repro.configs import get_config as ref_get_config
from repro.configs import param_count as ref_param_count
from repro.models import build_model as ref_build_model
from repro.models import ssm as rssm
from repro.serve import ServeEngine as RefServeEngine
from repro.train import TrainPipeline as RefPipeline
from repro.train.step import _forward_and_loss as ref_forward_and_loss
from repro_torch import bridge
from repro_torch.configs import get_config, param_count
from repro_torch.core import lars, packing
from repro_torch.launch import serve as launch_serve
from repro_torch.launch import train as launch_train
from repro_torch.models import build_model, ssm
from repro_torch.serve import ServeEngine
from repro_torch.train import TrainPipeline, train_state_from_params
from repro_torch.train.step import value_and_grad
from repro_torch.treepath import path_str, tree_flatten_with_path, tree_leaves
from _torch_threads import one_torch_thread  # noqa: F401
from test_torch_serve import SCHEDULE, _drive

pytestmark = pytest.mark.usefixtures("one_torch_thread")

ARCH = "falcon-mamba-7b"
VARIANTS = {"mamba1": ("falcon-mamba-7b", ssm.init_mamba1,
                       ssm.mamba1_forward, rssm.init_mamba1,
                       rssm.mamba1_forward),
            "mamba2": ("zamba2-7b", ssm.init_mamba2, ssm.mamba2_forward,
                       rssm.init_mamba2, rssm.mamba2_forward)}
TOL = dict(rtol=1e-5, atol=1e-5)
CONV_TOL = dict(rtol=1e-6, atol=1e-6)
LOSS_RTOL = 1e-6
GRAD_RTOL_OF_MAX = 1e-5
SEQ = 24
_CACHE = {}


def _cfgs(arch=ARCH, **changes):
    return (dataclasses.replace(ref_get_config(arch).reduced(), **changes),
            dataclasses.replace(get_config(arch).reduced(), **changes))


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

def check_config_and_count(arch, full, cut_layers, cut, extra_per_layer,
                           extra):
    """The config field for field; param_count as the reference's, at
    full size and at the card's cut; a meta-device init of the cut draws
    nothing (uniforms included) and holds the analytic count plus the
    leaves it leaves out (norm scales, biases; ``extra_per_layer`` a
    layer, ``extra`` besides)."""
    cfg, rcfg = get_config(arch), ref_get_config(arch)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(rcfg)
    assert param_count(cfg) == ref_param_count(rcfg) == (full, full)
    short = dataclasses.replace(cfg, num_layers=cut_layers)
    assert param_count(short)[0] == cut
    gen = torch.Generator().manual_seed(0)
    state = gen.get_state()
    params = build_model(short).init(gen, "meta")
    assert torch.equal(gen.get_state(), state)
    assert all(x.device.type == "meta" for x in tree_leaves(params))
    n = sum(x.numel() for x in tree_leaves(params))
    assert n == cut + cut_layers * extra_per_layer + extra
    return params


def test_falcon_config_is_the_references_and_counts_its_params():
    cfg = get_config(ARCH)
    din = cfg.ssm_d_inner
    params = check_config_and_count(
        ARCH, 7_271_350_272, 16, 2_217_345_024,
        2 * din + cfg.d_model, cfg.d_model)
    s = params["layers"]["ssm"]
    assert tuple(s["in_proj"].shape) == (16, 4096, 2 * 8192)
    assert tuple(s["x_proj"].shape) == (16, 8192, 256 + 2 * 16)
    assert s["dt_proj"].dtype == s["A_log"].dtype == torch.float32
    assert s["in_proj"].dtype == torch.bfloat16


def check_init_layout(arch, **changes):
    """The port's own init: the reference's tree, shapes and dtypes (bf16
    params), at its distributions; one seed, one set of weights."""
    rcfg, cfg = _cfgs(arch, dtype="bfloat16", **changes)
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
    s = p["layers"]["ssm"]
    dt = torch.nn.functional.softplus(s["dt_bias"])
    assert 0.999e-3 <= dt.min() and dt.max() <= 1.001e-1
    K = cfg.ssm_conv
    assert abs(s["conv_w"].std().item() * K ** 0.5 - 1) < 0.1
    assert abs(s["in_proj"].float().std().item() * cfg.d_model ** 0.5
               - 1) < 0.05
    again = model.init(torch.Generator().manual_seed(0), "cpu")
    assert all(torch.equal(a, b) for a, b in zip(tree_leaves(p),
                                                 tree_leaves(again)))
    return cfg, p


def test_init_layout_and_distributions():
    cfg, p = check_init_layout(ARCH)
    s = p["layers"]["ssm"]
    N, R = cfg.ssm_state, cfg.dt_rank
    assert torch.equal(s["A_log"][0], torch.log(
        torch.arange(1, N + 1.0))[None].expand(cfg.ssm_d_inner, N))
    # fan-in normal at scale R ** 0.5 / R: std 1 / R
    assert abs(s["dt_proj"].std().item() * R - 1) < 0.1


# ------------------------------------------------------------------ blocks

@pytest.mark.parametrize("case", ["plain", "state", "lengths",
                                  "state+lengths"])
def test_causal_conv1d_matches_the_reference(case):
    rng = np.random.default_rng(1)
    B, S, C, K = 3, 9, 16, 4
    x = rng.standard_normal((B, S, C)).astype(np.float32)
    w = rng.standard_normal((K, C)).astype(np.float32)
    b = rng.standard_normal((C,)).astype(np.float32)
    kw, tkw = {}, {}
    if "state" in case:
        st = rng.standard_normal((B, K - 1, C)).astype(np.float32)
        kw["state"], tkw["state"] = jnp.asarray(st), torch.from_numpy(st)
    if "lengths" in case:
        lens = np.array([9, 0, 4], np.int32)
        kw["lengths"], tkw["lengths"] = jnp.asarray(lens), \
            torch.from_numpy(lens)
    ry, rst = rssm.causal_conv1d(jnp.asarray(x), jnp.asarray(w),
                                 jnp.asarray(b), **kw)
    y, st = ssm.causal_conv1d(torch.from_numpy(x), torch.from_numpy(w),
                              torch.from_numpy(b), **tkw)
    _close(y, ry, **CONV_TOL)
    assert tuple(st.shape) == rst.shape == (B, K - 1, C)
    _close(st, rst, **CONV_TOL)


@pytest.mark.parametrize("c", [1, 2, 7, 64])
def test_scan_is_the_references_associative_scan(c):
    """The in-place chunk scan against ``lax.associative_scan`` with the
    reference's combine, at even and odd lengths, on a (B, c, d, N)
    chunk, and against the recurrence run step by step."""
    rng = np.random.default_rng(c)
    d = np.exp(-rng.uniform(0, 2, (2, c, 5, 3))).astype(np.float32)
    u = rng.standard_normal((2, c, 5, 3)).astype(np.float32)
    rd, ru = jax.lax.associative_scan(
        lambda a, b: (a[0] * b[0], b[0] * a[1] + b[1]),
        (jnp.asarray(d), jnp.asarray(u)), axis=1)
    sd, su = torch.from_numpy(d.copy()), torch.from_numpy(u.copy())
    ssm._scan_(sd, su)
    _close(sd, rd, **CONV_TOL)
    _close(su, ru, **CONV_TOL)
    h = np.zeros((2, 5, 3), np.float32)
    for t in range(c):
        h = d[:, t] * h + u[:, t]
    _close(su[:, -1], h, **CONV_TOL)


@pytest.mark.parametrize("L,c,group", [(12, 4, 8), (16, 4, 2), (7, 7, 1)])
def test_selective_scan_gradients_are_exact(monkeypatch, L, c, group):
    """The Mamba-1 scan's own backward pass (the adjoint recurrence as a
    reversed scan, closed-form gradients of the decays and inputs) in
    f64 against finite differences (gradcheck), with the state carried
    across chunks and across groups of chunks; its values against the
    recurrence run step by step."""
    monkeypatch.setattr(ssm, "GROUP", group)
    g = torch.Generator().manual_seed(L)
    B, din, N = 2, 3, 4
    f64 = dict(dtype=torch.float64)
    dt = (torch.rand(B, L, din, generator=g, **f64) * 0.5).requires_grad_()
    x, Bm, Cm = (torch.randn(B, L, n, generator=g, **f64).requires_grad_()
                 for n in (din, N, N))
    A = (-2 * torch.rand(din, N, generator=g, **f64)).requires_grad_()
    h0 = torch.randn(B, din, N, generator=g, **f64).requires_grad_()

    def fn(dt, x, Bm, Cm, A, h0):
        return ssm._stream(ssm._mamba1_group, h0, [dt, x, Bm, Cm], A, c)

    assert torch.autograd.gradcheck(fn, (dt, x, Bm, Cm, A, h0))
    h, ys = h0.detach(), []
    for t in range(L):
        h = torch.exp(dt[:, t, :, None] * A) * h + \
            (dt[:, t] * x[:, t])[..., None] * Bm[:, t, None, :]
        ys.append((h * Cm[:, t, None, :]).sum(-1))
    h_last, y = fn(dt, x, Bm, Cm, A, h0)
    torch.testing.assert_close(y, torch.stack(ys, 1), rtol=1e-12,
                               atol=1e-12)
    torch.testing.assert_close(h_last, h, rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_groups_of_chunks_change_only_rounding(monkeypatch, variant):
    """The streamed scans take GROUP chunks at a time; one chunk a group
    (the reference's streaming) gives the same outputs and gradients up
    to rounding."""
    _, cfg, p, x, fwd, _ = _block(variant, seed=7, shape=(2, 30))
    out = []
    for group in (ssm.GROUP, 1):
        monkeypatch.setattr(ssm, "GROUP", group)
        tp = bridge.params_to_torch(p)
        leaves = [t.requires_grad_(True) for t in tree_leaves(tp)]
        y, _ = fwd(cfg, tp, torch.from_numpy(x), chunk=4)
        out.append([y] + list(torch.autograd.grad(y.square().sum(),
                                                  leaves)))
    for a, b in zip(*out):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5 * float(
            b.detach().abs().max()))


def _block(variant, seed=0, shape=(2, SEQ), **changes):
    arch, _, fwd, rinit, rfwd = VARIANTS[variant]
    rcfg, cfg = _cfgs(arch, **changes)
    p = jax.tree_util.tree_map(np.asarray, rinit(jax.random.key(seed), rcfg,
                                                 jnp.float32))
    x = np.random.default_rng(seed).standard_normal(
        shape + (cfg.d_model,)).astype(np.float32) * 0.5
    return rcfg, cfg, p, x, fwd, rfwd


@pytest.mark.parametrize("chunk", [24, 7])
@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_block_forward_and_gradients_match_the_reference(variant, chunk):
    """Outputs and the gradients of sum(out * r) to x and every leaf, f32,
    at one chunk and at chunk 7 (three chunks, the last padded)."""
    rcfg, cfg, p, x, fwd, rfwd = _block(variant, seed=2)
    r = np.random.default_rng(3).standard_normal(x.shape).astype(np.float32)

    def ref_loss(p, x):
        out, _ = rfwd(rcfg, p, x, chunk=chunk)
        return jnp.sum(out * r), out

    (_, rout), (rgp, rgx) = jax.jit(jax.value_and_grad(
        ref_loss, argnums=(0, 1), has_aux=True))(
        jax.tree_util.tree_map(jnp.asarray, p), jnp.asarray(x))
    tp = bridge.params_to_torch(p)
    leaves = [(k, t.requires_grad_(True))
              for k, t in tree_flatten_with_path(tp)[0]]
    tx = torch.from_numpy(x).requires_grad_(True)
    out, st = fwd(cfg, tp, tx, chunk=chunk)
    assert st is None
    _close(out, rout)
    grads = torch.autograd.grad((out * torch.from_numpy(r)).sum(),
                                [tx] + [t for _, t in leaves])
    _close(grads[0], rgx, rtol=0, atol=GRAD_RTOL_OF_MAX * np.abs(
        np.asarray(rgx)).max())
    _grads_close([(k, g) for (k, _), g in zip(leaves, grads[1:])], rgp)


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_chunk_invariance(variant):
    """The streamed scan does not depend on its chunk size (the
    reference's test, at its tolerance)."""
    _, cfg, p, x, fwd, _ = _block(variant, seed=6)
    tp, tx = bridge.params_to_torch(p), torch.from_numpy(x)
    with torch.no_grad():
        want, _ = fwd(cfg, tp, tx, chunk=24)
        for c in (4, 6, 7):
            got, _ = fwd(cfg, tp, tx, chunk=c)
            torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)


def test_mamba2_large_dt_gives_finite_values_and_gradients():
    """The SSD gate is masked before the exp: with dt ~ 60 the exponent of
    the masked (s > t) weights overflows, and exp(inf) * 0 would be NaN.
    Values and gradients finite, the loss as the reference's."""
    rcfg, cfg, p, x, fwd, rfwd = _block("mamba2", seed=0, shape=(2, 32))
    p = dict(p, dt_bias=np.full_like(p["dt_bias"], 60.0))
    x = x * 0.6
    rloss = jax.jit(lambda p: jnp.sum(jnp.square(
        rfwd(rcfg, p, jnp.asarray(x), chunk=16)[0])))(
        jax.tree_util.tree_map(jnp.asarray, p))
    tp = tree_flatten_with_path(bridge.params_to_torch(p))
    leaves = [t.requires_grad_(True) for _, t in tp[0]]
    from repro_torch.treepath import tree_unflatten
    out, _ = fwd(cfg, tree_unflatten(tp[1], leaves), torch.from_numpy(x),
                 chunk=16)
    loss = out.square().sum()
    grads = torch.autograd.grad(loss, leaves)
    loss = loss.detach()
    assert torch.isfinite(loss)
    assert all(torch.isfinite(g).all() for g in grads)
    np.testing.assert_allclose(float(loss), float(rloss), rtol=1e-5)


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_state_carry_and_lengths_match_the_reference(variant):
    """A carried (conv, h) state and a lengths-masked batch (one row
    empty): outputs and the new states as the reference's; S = 1 takes
    the one-step recurrence."""
    rcfg, cfg, p, x, fwd, rfwd = _block(variant, seed=4, shape=(3, 10))
    rng = np.random.default_rng(5)
    zero = rfwd(rcfg, jax.tree_util.tree_map(jnp.asarray, p),
                jnp.asarray(x[:, :1]),
                state=_zero_state(rcfg, variant, 3))[1]
    state = {k: rng.standard_normal(np.shape(v)).astype(np.float32) * 0.3
             for k, v in zero.items()}
    lens = np.array([10, 0, 6], np.int32)
    rp, tp = jax.tree_util.tree_map(jnp.asarray, p), \
        bridge.params_to_torch(p)
    for xs, lengths in ((x, lens), (x[:, :1], None)):
        rout, rst = rfwd(rcfg, rp, jnp.asarray(xs),
                         state=jax.tree_util.tree_map(jnp.asarray, state),
                         chunk=4, lengths=None if lengths is None
                         else jnp.asarray(lengths))
        with torch.no_grad():
            out, st = fwd(cfg, tp, torch.from_numpy(xs),
                          state={k: torch.from_numpy(v)
                                 for k, v in state.items()},
                          chunk=4, lengths=None if lengths is None
                          else torch.from_numpy(lengths))
        _close(out, rout)
        for k in ("conv", "h"):
            _close(st[k], rst[k])
    # the empty row's state comes back as it went in
    _, st = fwd(cfg, tp, torch.from_numpy(x),
                state={k: torch.from_numpy(v) for k, v in state.items()},
                lengths=torch.from_numpy(lens))
    for k in ("conv", "h"):
        assert torch.equal(st[k][1], torch.from_numpy(state[k][1]))


def _zero_state(rcfg, variant, B):
    din, N = rcfg.ssm_d_inner, rcfg.ssm_state
    if variant == "mamba1":
        return {"conv": jnp.zeros((B, rcfg.ssm_conv - 1, din)),
                "h": jnp.zeros((B, din, N))}
    hd = rcfg.ssm_head_dim
    return {"conv": jnp.zeros((B, rcfg.ssm_conv - 1,
                               din + 2 * rcfg.ssm_groups * N)),
            "h": jnp.zeros((B, din // hd, hd, N))}


# ---------------------------------------------------------------------- LM

def _init(arch, **changes):
    key = (arch, tuple(sorted(changes.items())))
    if key not in _CACHE:
        rcfg, _ = _cfgs(arch, **changes)
        _CACHE[key] = jax.tree_util.tree_map(
            np.asarray, ref_build_model(rcfg).init(jax.random.key(2)))
    return _CACHE[key]


def lm_pair(arch, **changes):
    rcfg, cfg = _cfgs(arch, **changes)
    rmodel, model = ref_build_model(rcfg), build_model(cfg)
    init = _init(arch, **changes)
    return (cfg, model, bridge.lm_params_to_torch(init, model), rmodel,
            jax.tree_util.tree_map(jnp.asarray, init))


def check_lm_forward_and_gradients(arch, lean, **changes):
    """Logits, loss and every leaf's gradient against jax.grad of the
    reference's loss; ``lean``: the chunked loss and two-level remat."""
    if lean:
        changes.update(loss_chunk=8, remat_block=1)
    rcfg, cfg = _cfgs(arch, **changes)
    toks = _tokens(cfg)
    rmodel = ref_build_model(rcfg)

    def loss_fn(params):
        loss, (logits, aux) = ref_forward_and_loss(
            rmodel, rcfg, params, {"tokens": jnp.asarray(toks)})
        return loss, logits

    init = _init(arch, **{k: v for k, v in changes.items()
                          if k not in ("loss_chunk", "remat_block")})
    (rloss, rlogits), rgrads = jax.jit(jax.value_and_grad(
        loss_fn, has_aux=True))(jax.tree_util.tree_map(jnp.asarray, init))
    model = build_model(cfg)
    params = bridge.lm_params_to_torch(init, model)
    loss, grads, (logits, aux) = value_and_grad(
        model, cfg, params, {"tokens": torch.from_numpy(toks)})
    if lean:
        assert logits is None
    else:
        _close(logits, rlogits)
    assert float(aux["aux_loss"]) == 0.0
    assert abs(float(loss) - float(rloss)) <= LOSS_RTOL * abs(float(rloss))
    _grads_close(tree_flatten_with_path(grads)[0], rgrads)


@pytest.mark.parametrize("lean", [False, True])
def test_lm_forward_loss_and_gradients_match_the_reference(lean):
    check_lm_forward_and_gradients(ARCH, lean)


def check_init_cache(arch, **changes):
    """init_cache's leaves, shapes and dtypes as the reference's;
    ``cache_capacity`` looked up by name."""
    rcfg, cfg = _cfgs(arch, dtype="bfloat16", **changes)
    model = build_model(cfg)
    cache = model.init_cache(3, 20)
    want = ref_build_model(rcfg).init_cache(3, 20)
    assert set(cache) == set(want)
    for k, v in want.items():
        assert tuple(cache[k].shape) == v.shape, k
        assert str(cache[k].dtype).split(".")[-1] == str(v.dtype), k
    return model, cache


def test_init_cache_and_capacity_match_the_reference():
    """A pure-SSM cache has no capacity: ``cache_capacity`` is None, as
    the reference's, where the first leaf's third axis is K - 1."""
    model, cache = check_init_cache(ARCH)
    assert set(cache) == {"pos", "conv", "h"}
    assert model.cache_capacity(cache) is None
    assert cache["conv"].shape[2] == model.cfg.ssm_conv - 1


def check_prefill_then_decode(arch, **changes):
    """Prefill S-1 tokens, decode the last: the logits equal the full
    forward's last; the prefill (logits and every leaf of the cache) and
    12 decode steps as the reference's."""
    cfg, model, params, rmodel, rparams = lm_pair(arch, **changes)
    toks = _tokens(cfg, (3, 16), 8)
    full, _ = model.forward(params, torch.from_numpy(toks))
    logits, cache = model.prefill(params, torch.from_numpy(toks[:, :-1]),
                                  cache_len=32)
    last, cache = model.decode_step(params, cache,
                                    torch.from_numpy(toks[:, -1:]))
    _close(last[:, 0], full[:, -1])
    rlogits, rcache = jax.jit(rmodel.prefill, static_argnames="cache_len")(
        rparams, jnp.asarray(toks[:, :-1]), cache_len=32)
    rdecode = jax.jit(rmodel.decode_step)
    rlast, rcache = rdecode(rparams, rcache, jnp.asarray(toks[:, -1:]))
    _close(last, rlast)
    for t in _tokens(cfg, (12, 3, 1), 9):
        last, cache = model.decode_step(params, cache, torch.from_numpy(t))
        rlast, rcache = rdecode(rparams, rcache, jnp.asarray(t))
        _close(last, rlast)
    assert set(cache) == set(rcache)
    pos = cache["pos"].tolist()
    assert pos == np.asarray(rcache["pos"]).tolist() == [28] * 3
    for name in cache:
        if name in ("attn_k", "attn_v"):   # the rows each slot wrote
            _close(cache[name][:, :, :28], rcache[name][:, :, :28])
        else:
            _close(cache[name], rcache[name])
    return cache


def test_decode_after_prefill_equals_the_forward():
    check_prefill_then_decode(ARCH)


def check_lengths_masked_prefill(arch, **changes):
    """A right-padded batch prefilled with ``lengths`` equals each row
    prefilled alone, unpadded (logits and state), and the reference's
    lengths-masked prefill."""
    cfg, model, params, rmodel, rparams = lm_pair(arch, **changes)
    toks = _tokens(cfg, (3, 12), 5)
    lens = np.array([12, 4, 9], np.int32)
    logits, cache = model.prefill(params, torch.from_numpy(toks),
                                  cache_len=16, lengths=torch.from_numpy(lens))
    for b, n in enumerate(lens):
        one, alone = model.prefill(params, torch.from_numpy(toks[b:b + 1, :n]),
                                   cache_len=16)
        _close(logits[b], one[0])
        for name in cache:
            if name == "pos":
                assert int(cache[name][b]) == int(alone[name][0]) == n
            elif name in ("attn_k", "attn_v"):
                _close(cache[name][:, b, :n], alone[name][:, 0, :n])
            else:
                _close(cache[name][:, b], alone[name][:, 0])
    rlogits, rcache = rmodel.prefill(rparams, jnp.asarray(toks), cache_len=16,
                                     lengths=jnp.asarray(lens))
    _close(logits, rlogits)
    for name in cache:
        if name in ("attn_k", "attn_v"):
            _close(cache[name][:, :, :12], rcache[name][:, :, :12])
        else:
            _close(cache[name], rcache[name])


def test_lengths_masked_prefill_equals_per_row_prefill():
    check_lengths_masked_prefill(ARCH)


def check_prefill_at(arch, capacity=24, **changes):
    """Admission of two prompts into a live cache of 4 slots holding
    random state: the admitted slots' recurrent state and rows as the
    reference's, whatever they held before; every other slot's
    ``conv``, ``h``, K/V and ``pos`` bit-identical."""
    cfg, model, params, rmodel, rparams = lm_pair(arch, **changes)
    rng = np.random.default_rng(6)
    rcache = {k: jnp.asarray(rng.standard_normal(v.shape), v.dtype)
              if k != "pos" else jnp.asarray([3, 5, 7, 9], jnp.int32)
              for k, v in rmodel.init_cache(4, capacity).items()}
    cache = bridge.cache_to_torch(jax.device_get(rcache))
    back = bridge.cache_to_numpy(cache)
    for k in rcache:
        np.testing.assert_array_equal(back[k], np.asarray(rcache[k]))
    before = {k: v.clone() for k, v in cache.items()}
    toks, lens = _tokens(cfg, (2, 8), 7), np.array([8, 5], np.int32)
    slots = np.array([2, 0], np.int32)
    logits, out = model.prefill_at(params, cache, torch.from_numpy(toks),
                                   torch.from_numpy(slots),
                                   lengths=torch.from_numpy(lens))
    rlogits, rout = rmodel.prefill_at(rparams, rcache, jnp.asarray(toks),
                                      jnp.asarray(slots),
                                      lengths=jnp.asarray(lens))
    assert out is cache
    _close(logits, rlogits)
    assert out["pos"].tolist() == np.asarray(rout["pos"]).tolist() == \
        [5, 5, 8, 9]
    for name in out:
        if name == "pos":
            continue
        if name in ("conv", "h"):
            _close(out[name][:, slots], rout[name][:, slots])
        else:
            _close(out[name][:, slots, :8], rout[name][:, slots, :8])
            assert torch.equal(out[name][:, :, 8:], before[name][:, :, 8:])
        for s in (1, 3):                                # not admitted
            assert torch.equal(out[name][:, s], before[name][:, s])
    return model, out


def test_prefill_at_writes_the_admitted_slots_state_only():
    model, _ = check_prefill_at(ARCH)
    # no capacity: a prompt longer than the "capacity" 24 is admitted
    cache = model.init_cache(2, 24)
    cfg = model.cfg
    params = bridge.lm_params_to_torch(_init(ARCH), model)
    logits, _ = model.prefill_at(params, cache,
                                 torch.from_numpy(_tokens(cfg, (1, 40))),
                                 torch.tensor([1]))
    assert cache["pos"].tolist() == [0, 40] and torch.isfinite(logits).all()


def check_lars_steps_and_layout(arch, steps=4, **changes):
    """``steps`` LARS steps from one init: the reference's pipeline (its
    jnp engine) and the port's (the plain versions on the CPU), the same
    token batches; the packed layout's segment table the reference's."""
    rcfg, cfg = _cfgs(arch, **changes)
    kw = dict(momentum=0.9, weight_decay=1e-4, trust_coefficient=0.01)
    rpipe = RefPipeline(ref_build_model(rcfg),
                        ref_core.lars(0.05, use_pallas=False, **kw), rcfg,
                        donate=False)
    rstate = rpipe.init_state(jax.random.key(5))
    model = build_model(cfg)
    opt = lars(0.05, **kw)
    state = train_state_from_params(model, opt, bridge.lm_params_to_torch(
        jax.tree_util.tree_map(np.asarray, rstate.params), model))
    ref_layout, layout = rstate.opt_state.layout, state.opt_state.layout
    assert layout.buffer_shape == ref_layout.buffer_shape
    assert layout.num_slices == ref_layout.num_slices
    assert [(s.name, s.shape, s.layers, s.rows, s.row_offset,
             s.slice_offset) for s in layout.segments] == \
        [(s.name, tuple(s.shape), s.layers, s.rows, s.row_offset,
          s.slice_offset) for s in ref_layout.segments]
    assert [s.adapt for s in layout.segments] == \
        [s.adapt for s in ref_layout.segments]
    # the trust-ratio mask: the slices of rank > 1, which it scales
    np.testing.assert_array_equal(packing.adapt_mask(layout).numpy(),
                                  np.asarray(ref_packing.adapt_mask(
                                      ref_layout)))
    pipe = TrainPipeline(model, opt, cfg)
    losses, rlosses = [], []
    for toks in _tokens(cfg, (steps, 4, SEQ), 6):
        state, m = pipe(state, {"tokens": torch.from_numpy(toks)})
        rstate, rm = rpipe(rstate, {"tokens": jnp.asarray(toks)})
        losses.append(float(m["loss"]))
        rlosses.append(float(rm["loss"]))
    np.testing.assert_allclose(losses, rlosses, rtol=LOSS_RTOL)
    return layout


def test_lars_steps_and_packed_layout_match_the_reference():
    layout = check_lars_steps_and_layout(ARCH)
    assert "layers/ssm/in_proj" in [s.name for s in layout.segments]


def check_engine(arch, slots=3, **changes):
    """Staggered heterogeneous requests (idle slots decode with the
    rest, and slots are reused): the same greedy tokens as the
    reference's engine, finishing on the same ticks."""
    cfg, model, params, rmodel, rparams = lm_pair(arch, **changes)
    kw = dict(slots=slots, capacity=32, prefill_bucket=8)
    got = _drive(ServeEngine(model, params, cfg, **kw), SCHEDULE, cfg)
    want = _drive(RefServeEngine(rmodel, rparams, cfg=None, **kw),
                  SCHEDULE, cfg)
    assert got == want
    assert sorted(got[0]) == list(range(7))


def test_engine_greedy_tokens_match_the_reference():
    check_engine(ARCH)


# ------------------------------------------------------------------ launch

LAUNCH_RUNS = [("lars", []), ("lars", ["--precision", "bf16",
                                       "--opt-state-dtype", "int8",
                                       "--accum-steps", "2"])]


@pytest.mark.parametrize("optimizer,extra", LAUNCH_RUNS)
def test_launch_train_runs_falcon_reduced_on_the_cpu(optimizer, extra):
    summary = launch_train.main([
        "--arch", ARCH, "--reduced", "--device", "cpu", "--steps", "2",
        "--batch", "4", "--seq", "16", "--optimizer", optimizer,
        "--log-every", "0"] + extra)
    assert summary["arch"] == ARCH + "-reduced"
    assert len(summary["losses"]) == 2
    assert all(np.isfinite(summary["losses"]))


def test_launch_serve_runs_falcon_reduced_on_the_cpu(capsys):
    rep = launch_serve.main(["--arch", ARCH, "--reduced", "--device", "cpu",
                             "--requests", "4", "--slots", "2"])
    assert rep["requests"] == 4 and rep["logits_finite"]
    assert rep["flash_decode_launches"] == rep["flash_decode_per_tick"] == 0
    assert "0 per tick on the card" in capsys.readouterr().out
