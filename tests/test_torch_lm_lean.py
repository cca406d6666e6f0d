"""The memory-lean LM training path and the dense configs beyond smollm
(qwen3-14b: ``qk_norm``; qwen2-72b: ``qkv_bias``; minitron-8b: the
non-gated squared-ReLU MLP) on the CPU against the JAX package, on the
same seeded numpy inputs and the reference's initial params carried
across by ``bridge`` — the biases and norm scales perturbed from their
zero/one init so that they matter.

Tolerances, each measured here:
  * forward and gradients (``_forward_and_loss`` under ``jax.grad``
    against ``value_and_grad``), for the stock core, ``flash_vjp`` and
    ``flash_vjp`` with ``attn_q_chunk``: logits within 5.5e-6 absolute
    (values up to ~4), losses 1.5e-7 relative, every gradient leaf within
    2.2e-6 of its largest entry. Held as tests/test_torch_lm_train.py
    holds smollm: logits rtol/atol 1e-5, loss 1e-6, 1e-5 of each leaf's
    largest entry.
  * the chunked loss (``loss_chunk`` 1, 4, 7 and the whole sequence)
    against the reference's: losses within 2.2e-7 relative, gradients
    1.9e-6 of each leaf's largest entry; held the same.
  * two-level remat recomputes the same ops: gradients bit-identical to
    the flat per-layer remat's.
  * prefill and decode: logits and cache rows within 4.8e-6 absolute;
    held at the rtol/atol 1e-5 of tests/test_torch_lm.py.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_get_config
from repro.configs import param_count as ref_param_count
from repro.models import build_model as ref_build_model
from repro.train.step import _forward_and_loss as ref_forward_and_loss
from repro_torch import bridge
from repro_torch.configs import get_config
from repro_torch.models import build_model
from repro_torch.train.step import make_eval_step, value_and_grad
from repro_torch.treepath import path_str, tree_flatten_with_path, tree_leaves
from _torch_threads import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

ARCHS = ("qwen3-14b", "qwen2-72b", "minitron-8b")
TOL = dict(rtol=1e-5, atol=1e-5)
LOSS_RTOL = 1e-6
GRAD_RTOL_OF_MAX = 1e-5
SEQ = 32
_PARAMS = {}


def _cfgs(arch, **changes):
    rcfg = dataclasses.replace(ref_get_config(arch).reduced(), **changes)
    cfg = dataclasses.replace(get_config(arch).reduced(), **changes)
    return rcfg, cfg


def _init(arch, num_layers=2):
    """The reference's init (numpy), biases and norm scales perturbed."""
    key = (arch, num_layers)
    if key not in _PARAMS:
        rcfg, _ = _cfgs(arch, num_layers=num_layers)
        params = jax.tree_util.tree_map(
            np.asarray, ref_build_model(rcfg).init(jax.random.key(2)))
        rng = np.random.default_rng(4)
        attn = params["layers"]["attn"]
        for name in ("bq", "bk", "bv", "q_norm", "k_norm"):
            if name in attn:
                attn[name] = (attn[name] + 0.1 * rng.standard_normal(
                    attn[name].shape)).astype(np.float32)
        _PARAMS[key] = params
    return _PARAMS[key]


def _tokens(cfg, shape=(3, SEQ), seed=0):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, shape).astype(np.int32)


def _ref_grads(rcfg, init, toks):
    model = ref_build_model(rcfg)

    def loss_fn(params):
        loss, (logits, _) = ref_forward_and_loss(
            model, rcfg, params, {"tokens": jnp.asarray(toks)})
        return loss, logits

    (loss, logits), grads = jax.jit(jax.value_and_grad(
        loss_fn, has_aux=True))(jax.tree_util.tree_map(jnp.asarray, init))
    return loss, logits, {path_str(tuple(k.key for k in p)): np.asarray(v)
                          for p, v in jax.tree_util.tree_leaves_with_path(
                              grads)}


def _check_grads(grads, ref_grads):
    leaves = tree_flatten_with_path(grads)[0]
    assert {path_str(p) for p, _ in leaves} == set(ref_grads)
    for path, g in leaves:
        want = ref_grads[path_str(path)]
        err = np.abs(g.numpy() - want).max()
        assert err <= GRAD_RTOL_OF_MAX * np.abs(want).max(), (path, err)


def _port(arch, cfg, toks, num_layers=2):
    model = build_model(cfg)
    params = bridge.lm_params_to_torch(_init(arch, num_layers), model)
    return value_and_grad(model, cfg, params,
                          {"tokens": torch.from_numpy(toks)})


# ------------------------------------------------------------------ config

@pytest.mark.parametrize("arch", ARCHS)
def test_configs_are_the_references_and_count_their_params(arch):
    """The registered config field for field, and the full-size param
    count of a meta-device init: the reference's analytic count plus its
    norm scales (two per layer and the final one; qwen3's q/k norms)."""
    cfg, rcfg = get_config(arch), ref_get_config(arch)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(rcfg)
    params = build_model(cfg).init(torch.Generator().manual_seed(0), "meta")
    n = sum(x.numel() for x in tree_leaves(params))
    H, Hkv, hd = cfg.attn_dims
    norms = (2 * cfg.num_layers + 1) * cfg.d_model
    if cfg.qk_norm:
        norms += 2 * cfg.num_layers * hd
    assert n == ref_param_count(rcfg)[0] + norms


# ------------------------------------------------- forward and gradients

LEAN = {"stock": {}, "flash": {"flash_vjp": True},
        "flash_qchunk": {"flash_vjp": True, "attn_q_chunk": 8}}


@pytest.mark.parametrize("arch,lean", [(a, k) for a in ARCHS for k in LEAN
                                       if a == "qwen3-14b"
                                       or k != "flash_qchunk"])
def test_forward_and_gradients_match_the_reference(arch, lean):
    rcfg, cfg = _cfgs(arch, **LEAN[lean])
    toks = _tokens(cfg)
    ref_loss, ref_logits, ref_grads = _ref_grads(rcfg, _init(arch), toks)
    loss, grads, (logits, _) = _port(arch, cfg, toks)
    np.testing.assert_allclose(logits.detach().numpy(),
                               np.asarray(ref_logits), **TOL)
    assert abs(float(loss) - float(ref_loss)) <= \
        LOSS_RTOL * abs(float(ref_loss))
    _check_grads(grads, ref_grads)


@pytest.mark.parametrize("chunk", [1, 4, 7, SEQ])
def test_chunked_loss_matches_the_reference(chunk):
    """loss_chunk against the reference's chunked loss: 31 targets in
    chunks of 1, 4, 7 (a padded last chunk) and the whole sequence; the
    step returns no logits."""
    rcfg, cfg = _cfgs("qwen3-14b", loss_chunk=chunk, flash_vjp=True)
    toks = _tokens(cfg)
    ref_loss, ref_logits, ref_grads = _ref_grads(rcfg, _init("qwen3-14b"),
                                                 toks)
    loss, grads, (logits, _) = _port("qwen3-14b", cfg, toks)
    assert logits is None and ref_logits is None
    assert abs(float(loss) - float(ref_loss)) <= \
        LOSS_RTOL * abs(float(ref_loss))
    _check_grads(grads, ref_grads)


def test_eval_step_takes_the_whole_logits_under_loss_chunk():
    _, cfg = _cfgs("qwen3-14b")
    model = build_model(cfg)
    params = bridge.lm_params_to_torch(_init("qwen3-14b"), model)
    batch = {"tokens": torch.from_numpy(_tokens(cfg))}
    got = make_eval_step(model, dataclasses.replace(cfg, loss_chunk=4))(
        params, batch)
    want = make_eval_step(model, cfg)(params, batch)
    assert float(got["accuracy"]) == float(want["accuracy"])
    assert float(got["loss"]) == float(want["loss"])


@pytest.mark.parametrize("block", [1, 2, 3])
def test_two_level_remat_gives_identical_gradients(block):
    """remat_block 1 and 2 nest per-layer checkpoints in block
    checkpoints over 4 layers; 3 does not divide 4 and takes the flat
    per-layer remat, as the reference. Gradients bit-identical to the
    flat remat's, through the lean attention and loss."""
    lean = dict(flash_vjp=True, attn_q_chunk=8, loss_chunk=8,
                num_layers=4)
    _, flat_cfg = _cfgs("qwen3-14b", **lean)
    _, cfg = _cfgs("qwen3-14b", remat_block=block, **lean)
    toks = _tokens(cfg)
    flat_loss, flat_grads, _ = _port("qwen3-14b", flat_cfg, toks, 4)
    loss, grads, _ = _port("qwen3-14b", cfg, toks, 4)
    assert torch.equal(loss, flat_loss)
    assert all(torch.equal(a, b) for a, b in zip(tree_leaves(grads),
                                                 tree_leaves(flat_grads)))


# ------------------------------------------------------- prefill, decode

@pytest.mark.parametrize("arch", ["qwen3-14b", "qwen2-72b"])
@pytest.mark.parametrize("lean", [False, True])
def test_prefill_and_decode_match_the_reference(arch, lean):
    """Prefill (through flash_vjp and attn_q_chunk when ``lean``, as the
    reference's prefill takes them), then 4 teacher-forced decode steps
    through the flash_decode path: logits and the cache after each."""
    changes = dict(flash_vjp=True, attn_q_chunk=4) if lean else {}
    rcfg, cfg = _cfgs(arch, **changes)
    rmodel, model = ref_build_model(rcfg), build_model(cfg)
    init = _init(arch)
    rparams = jax.tree_util.tree_map(jnp.asarray, init)
    params = bridge.lm_params_to_torch(init, model)
    toks = _tokens(cfg, (3, 12), 8)
    lens = np.array([12, 3, 6], np.int32)
    logits, cache = model.prefill(params, torch.tensor(toks), cache_len=20,
                                  lengths=torch.tensor(lens))
    rlogits, rcache = rmodel.prefill(rparams, jnp.asarray(toks),
                                     cache_len=20, lengths=jnp.asarray(lens))
    np.testing.assert_allclose(logits.numpy(), np.asarray(rlogits), **TOL)
    for t in _tokens(cfg, (4, 3, 1), 9):
        logits, cache = model.decode_step(params, cache, torch.tensor(t))
        rlogits, rcache = rmodel.decode_step(rparams, rcache, jnp.asarray(t),
                                             use_flash=True)
        np.testing.assert_allclose(logits.numpy(), np.asarray(rlogits),
                                   **TOL)
        for name in cache:
            np.testing.assert_allclose(
                cache[name].float().numpy(),
                np.asarray(rcache[name], np.float32), **TOL)
