"""The port's encoder-decoder family (``repro_torch.models.encdec``,
whisper-base) on the CPU against the JAX package: reduced whisper in
f32, the reference's params carried across by ``bridge``, the same
seeded numpy tokens and stub frames.

The helpers take the batch's stub input by name (``frames`` here,
``image_embeddings`` for tests/test_torch_vlm.py, which runs them for
paligemma-3b).

Tolerances, each measured here (max abs differences): ``sinusoid``
within an ulp of each angle (its test says why); logits within 7.2e-7
of values up to 1.09 (stock) and 8.9e-7 (``flash_vjp`` with query
chunks), the loss within 1.5e-7 relative, gradients within 4.0e-6 of
each leaf's largest entry (held at rtol/atol 1e-5, 1e-6 relative and
1e-5 of the largest entry); the prefill's logits 6.6e-7 and caches
3.0e-6, decode after prefill against the forward 7.7e-7, 8 decode steps
8.0e-7 (held at rtol/atol 1e-5); 4 LARS steps' losses within 1.5e-7
relative (held at 1e-6); ``DecodeEngine``'s greedy tokens equal.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core as ref_core
from repro.configs import get_config as ref_get_config
from repro.configs import param_count as ref_param_count
from repro.models import build_model as ref_build_model
from repro.models import encdec as rencdec
from repro.serve import DecodeEngine as RefDecodeEngine
from repro.train import TrainPipeline as RefPipeline
from repro.train.step import _forward_and_loss as ref_forward_and_loss
from repro.train.step import make_eval_step as ref_make_eval_step
from repro_torch import bridge
from repro_torch.configs import get_config, param_count
from repro_torch.core import lars
from repro_torch.kernels import flash_decode as fd
from repro_torch.launch import serve as launch_serve
from repro_torch.launch import train as launch_train
from repro_torch.models import build_model, encdec
from repro_torch.serve import DecodeEngine, ServeEngine
from repro_torch.train import (TrainPipeline, make_eval_step,
                               train_state_from_params)
from repro_torch.train.step import value_and_grad
from repro_torch.treepath import path_str, tree_flatten_with_path, tree_leaves
from _torch_threads import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

ARCH = "whisper-base"
TOL = dict(rtol=1e-5, atol=1e-5)
LOSS_RTOL = 1e-6
GRAD_RTOL_OF_MAX = 1e-5
SEQ = 12
LEAN = dict(flash_vjp=True, attn_q_chunk=4)
_CACHE = {}


def cfgs(arch=ARCH, **changes):
    return (dataclasses.replace(ref_get_config(arch).reduced(), **changes),
            dataclasses.replace(get_config(arch).reduced(), **changes))


def stub_name(cfg):
    """The batch's stub input of the family, and its length."""
    if cfg.family == "encdec":
        return "frames", cfg.encoder_seq
    return "image_embeddings", cfg.num_image_tokens


def prefix(cfg):
    """Positions the prompt holds besides its tokens: the vlm family's
    image prefix."""
    return cfg.num_image_tokens if cfg.family == "vlm" else 0


def batch(cfg, B=3, S=SEQ, seed=0):
    """Seeded numpy tokens and stub input (unit normals, scaled)."""
    rng = np.random.default_rng(seed)
    name, n = stub_name(cfg)
    return {"tokens": rng.integers(0, cfg.vocab_size, (B, S)).astype(
        np.int32), name: (rng.standard_normal((B, n, cfg.d_model)) * 0.5
                          ).astype(np.float32)}


def to_jax(b):
    return {k: jnp.asarray(v) for k, v in b.items()}


def to_torch(b):
    return {k: torch.from_numpy(v) for k, v in b.items()}


def _np(x):
    return x.detach().float().numpy() if torch.is_tensor(x) \
        else np.asarray(x, np.float32)


def close(got, want, **tol):
    np.testing.assert_allclose(_np(got), _np(want), **(tol or TOL))


def grads_close(got_leaves, want_tree):
    want = {path_str(tuple(k.key for k in p)): np.asarray(v) for p, v in
            jax.tree_util.tree_leaves_with_path(want_tree)}
    assert {path_str(p) for p, _ in got_leaves} == set(want)
    for path, g in got_leaves:
        w = want[path_str(path)]
        err = np.abs(_np(g) - w).max()
        assert err <= GRAD_RTOL_OF_MAX * np.abs(w).max(), (path, err)


def ref_init(arch, **changes):
    key = (arch, tuple(sorted(changes.items())))
    if key not in _CACHE:
        rcfg, _ = cfgs(arch, **changes)
        _CACHE[key] = jax.tree_util.tree_map(
            np.asarray, ref_build_model(rcfg).init(jax.random.key(2)))
    return _CACHE[key]


def pair(arch, **changes):
    """(cfg, model, params, reference model, reference params): one
    init, the reference's, in both packages."""
    rcfg, cfg = cfgs(arch, **changes)
    model = build_model(cfg)
    init = ref_init(arch, **changes)
    return (cfg, model, bridge.lm_params_to_torch(init, model),
            ref_build_model(rcfg), jax.tree_util.tree_map(jnp.asarray, init))


# ------------------------------------------------------------------ config

def check_config_and_count(arch, count, extra):
    """The config field for field; param_count as the reference's; a
    meta-device init draws nothing and holds the analytic count plus
    the norms' leaves it leaves out (``extra``)."""
    cfg, rcfg = get_config(arch), ref_get_config(arch)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(rcfg)
    assert param_count(cfg) == ref_param_count(rcfg) == (count, count)
    gen = torch.Generator().manual_seed(0)
    state = gen.get_state()
    params = build_model(cfg).init(gen, "meta")
    assert torch.equal(gen.get_state(), state)
    assert all(x.device.type == "meta" for x in tree_leaves(params))
    assert sum(x.numel() for x in tree_leaves(params)) == count + extra
    return cfg, params


def test_whisper_config_is_the_references_and_counts_its_params():
    d = 512
    cfg, params = check_config_and_count(ARCH, 70_595_072,
                                         (6 * 4 + 6 * 6 + 4) * d)
    assert tuple(params["enc_layers"]["attn"]["wq"].shape) == (6, d, d)
    assert tuple(params["dec_layers"]["cross_attn"]["wk"].shape) == (6, d, d)
    assert "unembed" not in params          # tied
    assert params["dec_layers"]["ln_x"]["bias"].dtype == torch.float32


@pytest.mark.parametrize("d", [256, 512, 7])
def test_sinusoid_matches_the_reference(d):
    """The same f32 expression. XLA's and PyTorch's f32 ``exp``, ``sin``
    and ``cos`` are not correctly rounded and differ by an ulp in places,
    so the frequencies may differ by an ulp (2^-24 relative), and the
    angle at position p by p times that: within 2^-22 (1 + p) of the
    reference's (measured 1.2e-4 at p 1499, d 256)."""
    pos = np.arange(1500)
    got = encdec.sinusoid(torch.from_numpy(pos), d)
    want = np.asarray(rencdec.sinusoid(jnp.asarray(pos), d))
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape
    np.testing.assert_array_equal(got[0].numpy(), want[0])
    err = np.abs(got.numpy() - want).max(axis=1)
    assert (err <= 2.0 ** -22 * (1 + pos)).all()


def check_init_layout(arch, **changes):
    """The port's own init: the reference's tree, shapes and dtypes (bf16
    params), its stacked marker, fan-in normal weights; one seed, one set
    of weights."""
    rcfg, cfg = cfgs(arch, dtype="bfloat16", **changes)
    rmodel = ref_build_model(rcfg)
    rparams = jax.eval_shape(rmodel.init, jax.random.key(0))
    model = build_model(cfg)
    p = model.init(torch.Generator().manual_seed(0), "cpu")
    got = {path_str(k): v for k, v in tree_flatten_with_path(p)[0]}
    want = {path_str(tuple(k.key for k in path)): leaf for path, leaf in
            jax.tree_util.tree_flatten_with_path(rparams)[0]}
    assert set(got) == set(want)
    for k, leaf in want.items():
        assert tuple(got[k].shape) == leaf.shape, k
        assert str(got[k].dtype).split(".")[-1] == str(leaf.dtype), k
    rmark = {path_str(tuple(k.key for k in path)): bool(m) for path, m in
             jax.tree_util.tree_flatten_with_path(
                 rmodel.stacked_marker(rparams))[0]}
    mark = {path_str(k): m for k, m in
            tree_flatten_with_path(model.stacked_marker(p))[0]}
    assert mark == rmark
    assert abs(p["embed"].float().std().item() / 0.02 - 1) < 0.05
    again = model.init(torch.Generator().manual_seed(0), "cpu")
    assert all(torch.equal(a, b) for a, b in zip(tree_leaves(p),
                                                 tree_leaves(again)))
    return cfg, p


def test_init_layout_and_distributions():
    cfg, p = check_init_layout(ARCH)
    wq = p["dec_layers"]["cross_attn"]["wq"].float()
    assert abs(wq.std().item() * cfg.d_model ** 0.5 - 1) < 0.05
    assert set(p["enc_layers"]) == {"ln1", "attn", "ln2", "mlp"}
    assert torch.equal(p["enc_norm"]["bias"], torch.zeros(cfg.d_model))


# ---------------------------------------------------------------- forward

def check_forward_loss_and_gradients(arch, lean, **changes):
    """Logits, loss and every leaf's gradient against jax.grad of the
    reference's loss (the train step's ``_forward_and_loss``)."""
    if lean:
        changes.update(LEAN)
    rcfg, cfg = cfgs(arch, **changes)
    b = batch(cfg)
    rmodel = ref_build_model(rcfg)

    def loss_fn(params):
        loss, (logits, aux) = ref_forward_and_loss(rmodel, rcfg, params,
                                                   to_jax(b))
        return loss, logits

    init = ref_init(arch, **{k: v for k, v in changes.items()
                             if k not in LEAN and k != "loss_chunk"})
    (rloss, rlogits), rgrads = jax.jit(jax.value_and_grad(
        loss_fn, has_aux=True))(jax.tree_util.tree_map(jnp.asarray, init))
    model = build_model(cfg)
    params = bridge.lm_params_to_torch(init, model)
    loss, grads, (logits, aux) = value_and_grad(model, cfg, params,
                                                to_torch(b))
    if cfg.loss_chunk:
        assert logits is None
    else:
        close(logits, rlogits)
    assert float(aux["aux_loss"]) == 0.0
    assert abs(float(loss) - float(rloss)) <= LOSS_RTOL * abs(float(rloss))
    grads_close(tree_flatten_with_path(grads)[0], rgrads)
    return logits


@pytest.mark.parametrize("lean", [False, True])
def test_forward_loss_and_gradients_match_the_reference(lean):
    """Stock, and through ``flash_vjp`` with query chunks (4 divides the
    decoder's 12 positions and the encoder's 64)."""
    logits = check_forward_loss_and_gradients(ARCH, lean)
    assert tuple(logits.shape) == (3, SEQ, 512)


def test_encoder_is_bidirectional_and_the_decoder_causal():
    """A change to the last frame moves every encoder output; a change
    to the last token moves no earlier decoder position."""
    cfg, model, params, _, _ = pair(ARCH)
    b = to_torch(batch(cfg, B=1))
    enc = model.encode(params, b["frames"])
    frames = b["frames"].clone()
    frames[:, -1] = torch.randn(cfg.d_model,
                                generator=torch.Generator().manual_seed(1))
    moved = (model.encode(params, frames) - enc).abs().amax(-1)
    assert (moved > 1e-4).all()
    with torch.no_grad():
        logits, _ = model.forward(params, b["tokens"], frames=b["frames"])
        toks = b["tokens"].clone()
        toks[:, -1] = (toks[:, -1] + 1) % cfg.vocab_size
        again, _ = model.forward(params, toks, frames=b["frames"])
    assert torch.equal(logits[:, :-1], again[:, :-1])
    assert not torch.equal(logits[:, -1], again[:, -1])


def test_eval_step_matches_the_reference():
    cfg, model, params, rmodel, rparams = pair(ARCH)
    b = batch(cfg, seed=4)
    got = make_eval_step(model, cfg)(params, to_torch(b))
    want = ref_make_eval_step(rmodel, rmodel.cfg)(rparams, to_jax(b))
    assert abs(float(got["loss"]) - float(want["loss"])) <= \
        LOSS_RTOL * abs(float(want["loss"]))
    assert float(got["accuracy"]) == float(want["accuracy"])


# ------------------------------------------------------------------ serve

def ref_prefill(rmodel, rparams, b, cap):
    kw = {k: jnp.asarray(v) for k, v in b.items() if k != "tokens"}
    return rmodel.prefill(rparams, jnp.asarray(b["tokens"]), cache_len=cap,
                          **kw)


def prefill(model, params, b, cap):
    kw = {k: torch.from_numpy(v) for k, v in b.items() if k != "tokens"}
    return model.prefill(params, torch.from_numpy(b["tokens"]),
                         cache_len=cap, **kw)


def check_prefill_caches(arch, **changes):
    """The prefill's logits and every leaf of its cache as the
    reference's, leaf names, shapes and dtypes included."""
    cfg, model, params, rmodel, rparams = pair(arch, **changes)
    b = batch(cfg, seed=3)
    cap = 20 + prefix(cfg)
    logits, cache = prefill(model, params, b, cap)
    rlogits, rcache = ref_prefill(rmodel, rparams, b, cap)
    close(logits, rlogits)
    assert set(cache) == set(rcache)
    for name, want in rcache.items():
        assert tuple(cache[name].shape) == want.shape, name
        assert str(cache[name].dtype).split(".")[-1] == str(want.dtype)
        close(cache[name], want)
    return cfg, cache


def test_prefill_caches_match_the_reference():
    """And ``init_cache``'s empty cache: the reference's leaves, shapes
    and dtypes."""
    cfg, cache = check_prefill_caches(ARCH)
    rcfg, _ = cfgs(ARCH, dtype="bfloat16")
    empty = build_model(dataclasses.replace(cfg, dtype="bfloat16")
                        ).init_cache(3, 20)
    want = ref_build_model(rcfg).init_cache(3, 20)
    assert set(empty) == set(want)
    for name, w in want.items():
        assert tuple(empty[name].shape) == w.shape, name
        assert str(empty[name].dtype).split(".")[-1] == str(w.dtype), name
    assert cache["pos"].tolist() == [SEQ] * 3
    assert tuple(cache["xk"].shape) == (2, 3, cfg.encoder_seq, 4, 64)
    assert cache["k"][:, :, SEQ:].abs().max() == 0      # capacity 20


def check_decode_after_prefill(arch, steps=8, **changes):
    """Prefill S-1 tokens and decode the last: the full forward's last
    logits; then ``steps`` decode steps as the reference's decode, and
    the caches at the end."""
    cfg, model, params, rmodel, rparams = pair(arch, **changes)
    b = batch(cfg, seed=8)
    name = stub_name(cfg)[0]
    with torch.no_grad():
        full, _ = model.forward(params, torch.from_numpy(b["tokens"]),
                                **{name: torch.from_numpy(b[name])})
    head = dict(b, tokens=b["tokens"][:, :-1])
    cap = SEQ + steps + prefix(cfg)
    _, cache = prefill(model, params, head, cap)
    _, rcache = ref_prefill(rmodel, rparams, head, cap)
    rdecode = jax.jit(rmodel.decode_step)
    feed = [b["tokens"][:, -1:]] + list(batch(cfg, S=steps, seed=9)[
        "tokens"].T[:, :, None])
    for i, t in enumerate(feed):
        last, cache = model.decode_step(params, cache, torch.from_numpy(t))
        rlast, rcache = rdecode(rparams, rcache, jnp.asarray(t))
        if i == 0:
            close(last[:, 0], full[:, -1])
        close(last, rlast)
    assert cache["pos"].tolist() == np.asarray(rcache["pos"]).tolist()
    for name in ("k", "v"):
        close(cache[name], rcache[name])
    return model, cache


def test_decode_after_prefill_equals_the_forward():
    model, cache = check_decode_after_prefill(ARCH)
    assert cache["pos"].tolist() == [SEQ + 8] * 3
    assert model.flash_decode_per_step() == 4       # self + cross, 2 layers


def test_decode_runs_both_attentions_through_flash_decode(monkeypatch):
    """A decode step calls the wrapper twice a layer: the self-attention
    over pos + 1 rows and the cross-attention over every encoder row
    (the plain version here: no launch on the CPU)."""
    cfg, model, params, _, _ = pair(ARCH)
    _, cache = prefill(model, params, batch(cfg), 16)
    calls = []
    inner = fd.flash_decode

    def spy(q4, k, v, lengths, *, scale):
        calls.append((k.shape[1], lengths.tolist()))
        return inner(q4, k, v, lengths, scale=scale)
    monkeypatch.setattr(fd, "flash_decode", spy)
    before = dict(fd.LAUNCHES)
    model.decode_step(params, cache, torch.zeros(3, 1, dtype=torch.int32))
    assert fd.LAUNCHES == before
    assert calls == [(16, [SEQ + 1] * 3), (cfg.encoder_seq,
                                           [cfg.encoder_seq] * 3)] * 2


def check_decode_engine(arch, new=6, **changes):
    """``DecodeEngine``'s greedy tokens as the reference's
    ``DecodeEngine``'s, from the same batch."""
    cfg, model, params, rmodel, rparams = pair(arch, **changes)
    b = batch(cfg, B=4, S=5, seed=11)
    cap = 5 + new + prefix(cfg)
    got = DecodeEngine(model, params, cfg).generate(
        to_torch(b), max_new_tokens=new, cache_len=cap)
    want = RefDecodeEngine(rmodel, rparams, cfg=None).generate(
        to_jax(b), max_new_tokens=new, cache_len=cap)
    assert got.dtype == torch.int32 and tuple(got.shape) == (4, new)
    assert got.tolist() == np.asarray(want).tolist()
    return got


def test_decode_engine_greedy_tokens_match_the_reference():
    check_decode_engine(ARCH)


def test_serve_engine_refuses_encdec_with_the_references_reason():
    cfg, model, params, _, _ = pair(ARCH)
    with pytest.raises(ValueError, match=r"covers .*got 'encdec'"):
        ServeEngine(model, params, cfg, slots=1, capacity=8)
    with pytest.raises(ValueError, match="got 'encdec'"):
        launch_serve.main(["--arch", ARCH, "--reduced", "--device", "cpu"])


def test_bridge_carries_the_encdec_cache_both_ways():
    cfg, model, params, rmodel, rparams = pair(ARCH)
    _, rcache = ref_prefill(rmodel, rparams, batch(cfg), 16)
    cache = bridge.cache_to_torch(jax.device_get(rcache))
    assert set(cache) == {"pos", "k", "v", "xk", "xv"}
    assert cache["pos"].dtype == torch.int32
    back = bridge.cache_to_numpy(cache)
    for k, v in rcache.items():
        np.testing.assert_array_equal(back[k], np.asarray(v))
    p = bridge.params_to_numpy(params)
    for (path, leaf), (_, want) in zip(
            tree_flatten_with_path(p)[0],
            tree_flatten_with_path(ref_init(ARCH))[0]):
        np.testing.assert_array_equal(leaf, want, err_msg=path_str(path))


# ----------------------------------------------------------------- train

def check_lars_steps_and_layout(arch, steps=4, **changes):
    """``steps`` LARS steps from one init: the reference's pipeline (its
    jnp engine) and the port's (the plain versions on the CPU), the same
    batches; the packed layout's segment table the reference's."""
    rcfg, cfg = cfgs(arch, **changes)
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
    assert [(s.name, s.shape, s.layers, s.rows, s.row_offset,
             s.slice_offset, s.adapt) for s in layout.segments] == \
        [(s.name, tuple(s.shape), s.layers, s.rows, s.row_offset,
          s.slice_offset, s.adapt) for s in ref_layout.segments]
    pipe = TrainPipeline(model, opt, cfg)
    losses, rlosses = [], []
    for i in range(steps):
        b = batch(cfg, B=4, seed=20 + i)
        state, m = pipe(state, to_torch(b))
        rstate, rm = rpipe(rstate, to_jax(b))
        losses.append(float(m["loss"]))
        rlosses.append(float(rm["loss"]))
    np.testing.assert_allclose(losses, rlosses, rtol=LOSS_RTOL)
    return layout


def test_lars_steps_and_packed_layout_match_the_reference():
    layout = check_lars_steps_and_layout(ARCH)
    names = [s.name for s in layout.segments]
    assert "enc_layers/attn/wq" in names and \
        "dec_layers/cross_attn/wv" in names


LAUNCH_RUNS = [("lars", []), ("lars", ["--precision", "bf16",
                                       "--opt-state-dtype", "int8",
                                       "--accum-steps", "2"])]


@pytest.mark.parametrize("optimizer,extra", LAUNCH_RUNS)
def test_launch_train_runs_whisper_reduced_on_the_cpu(optimizer, extra):
    summary = launch_train.main([
        "--arch", ARCH, "--reduced", "--device", "cpu", "--steps", "2",
        "--batch", "4", "--seq", "16", "--optimizer", optimizer,
        "--log-every", "0"] + extra)
    assert summary["arch"] == ARCH + "-reduced"
    assert len(summary["losses"]) == 2
    assert all(np.isfinite(summary["losses"]))


def test_lm_batches_carry_the_references_stub_frames():
    cfg = get_config(ARCH).reduced()
    b = next(launch_train.lm_batches(cfg, 2, 8))
    assert set(b) == {"tokens", "frames"}
    assert b["frames"].shape == (2, cfg.encoder_seq, cfg.d_model)
    assert b["frames"].dtype == np.float32 and not b["frames"].any()
