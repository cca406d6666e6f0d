"""The training side of sliding windows and the logit softcap, and the
encoder's and prefix-LM masks: the port's ``attention_core`` (stock, and
through ``flash_vjp``) with ``window``, ``softcap``, a custom ``scale``,
``causal=False`` and ``prefix_len`` on the CPU against the reference's
``attention_core``, forward and gradients, on the same seeded numpy
inputs; then reduced qwen3-14b's loss and gradients with
``sliding_window`` and ``attn_logit_softcap`` set.

At kv_chunk 4, q_chunk 8 and window 5 the query block at positions
16..23 meets whole KV chunks (keys 0..7) that its window masks, so every
case covers a wholly masked chunk.

Tolerances, each measured here:
  * f32: outputs within 4.2e-7 (values up to 2.0), gradients within
    4.4e-7 of each gradient's largest entry; held at rtol/atol 1e-5 and
    1e-5 of the largest entry.
  * bf16 inputs: outputs equal bit for bit; gradients within 5.4e-4 of
    the largest entry (one bf16 ulp where the f32 sums of the two round
    across a bf16 boundary); held at one bf16 ulp, rtol/atol 2^-7.
  * reduced qwen3 (window 8, softcap 30, seq 32), stock and lean: loss
    within 1e-7 relative, gradients 1.2e-6 of each leaf's largest entry;
    held at 1e-6 and 1e-5.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_get_config
from repro.models import build_model as ref_build_model
from repro.models.attention import attention_core as ref_attention_core
from repro.train.step import _forward_and_loss as ref_forward_and_loss
from repro_torch import bridge
from repro_torch.configs import get_config
from repro_torch.models import attention as A
from repro_torch.models import build_model
from repro_torch.train.step import value_and_grad
from repro_torch.treepath import path_str, tree_flatten_with_path
from _torch_threads import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

OUT_TOL = dict(rtol=1e-5, atol=1e-5)
GRAD_RTOL_OF_MAX = 1e-5
BF16_TOL = dict(rtol=2 ** -7, atol=2 ** -7)
LOSS_RTOL = 1e-6
S = 24
CASES = {"window": dict(window=5), "softcap": dict(softcap=2.0),
         "all_three": dict(window=5, softcap=1.5, scale=0.5),
         # the encoder's and the cross-attention's mask, and the vlm's
         # bidirectional prefix (which reaches past the first query block)
         "encoder": dict(causal=False), "prefix": dict(prefix_len=11),
         "prefix_window": dict(prefix_len=11, window=5)}


def _inputs(B=2, H=4, Hkv=2, D=8, Dv=8, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=s).astype(np.float32) for s in
            ((B, S, H, D), (B, S, Hkv, D), (B, S, Hkv, Dv), (B, S, H, Dv))]


def _np(x):
    return np.asarray(x.detach().float() if torch.is_tensor(x)
                      else np.asarray(x, np.float32), np.float32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("flash_vjp", [False, True])
@pytest.mark.parametrize("case", sorted(CASES))
def test_attention_core_masks_match_the_reference(case, flash_vjp, dtype):
    q, k, v, do = _inputs()
    kw = dict(kv_chunk=4, q_chunk=8, flash_vjp=flash_vjp, **CASES[case])
    jd = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}[dtype]
    td = getattr(torch, dtype)
    out, vjp = jax.vjp(
        lambda q, k, v: ref_attention_core(q, k, v,
                                           q_positions=jnp.arange(S), **kw),
        *(jnp.asarray(x, jd) for x in (q, k, v)))
    grads = vjp(jnp.asarray(do, jd))
    tq, tk, tv = (torch.tensor(x).to(td).requires_grad_() for x in (q, k, v))
    tout = A.attention_core(tq, tk, tv, q_positions=torch.arange(S), **kw)
    tgrads = torch.autograd.grad(tout, (tq, tk, tv), torch.tensor(do).to(td))
    assert tout.dtype == td
    if dtype == "float32":
        np.testing.assert_allclose(_np(tout), _np(out), **OUT_TOL)
        for name, a, b in zip("qkv", tgrads, grads):
            err = np.abs(_np(a) - _np(b)).max()
            assert err <= GRAD_RTOL_OF_MAX * np.abs(_np(b)).max(), name
    else:
        for name, a, b in zip(["out", "dq", "dk", "dv"], (tout,) + tgrads,
                              (out,) + tuple(grads)):
            np.testing.assert_allclose(_np(a), _np(b), err_msg=name,
                                       **BF16_TOL)


@pytest.mark.parametrize("flash_vjp", [False, True])
def test_window_and_softcap_are_the_dense_masked_softmax(flash_vjp):
    """Against a dense numpy softmax over the keys qp - window < kp <=
    qp of capped, scaled scores: the mask and the cap do what they say
    (not only what the reference does)."""
    q, k, v, _ = _inputs(H=2, Hkv=2, seed=3)
    window, cap, scale = 5, 1.5, 0.4
    out = A.attention_core(torch.tensor(q), torch.tensor(k), torch.tensor(v),
                           q_positions=torch.arange(S), window=window,
                           softcap=cap, scale=scale, kv_chunk=4, q_chunk=8,
                           flash_vjp=flash_vjp)
    s = np.einsum("bqhd,bkhd->bhqk", q.astype(np.float64), k) * scale
    s = cap * np.tanh(s / cap)
    qp, kp = np.arange(S)[:, None], np.arange(S)[None, :]
    s = np.where((kp <= qp) & (kp > qp - window), s, -np.inf)
    p = np.exp(s - s.max(-1, keepdims=True))
    want = np.einsum("bhqk,bkhd->bqhd", p / p.sum(-1, keepdims=True), v)
    np.testing.assert_allclose(_np(out), want, rtol=1e-5, atol=1e-5)
    plain = A.attention_core(torch.tensor(q), torch.tensor(k),
                             torch.tensor(v), q_positions=torch.arange(S),
                             kv_chunk=4)
    assert np.abs(_np(plain) - want).max() > 0.1


@pytest.mark.parametrize("lean", [False, True])
def test_reduced_qwen3_loss_and_grads_with_window_and_softcap(lean):
    changes = dict(sliding_window=8, attn_logit_softcap=30.0)
    if lean:
        changes.update(flash_vjp=True, attn_q_chunk=8, loss_chunk=8,
                       remat_block=1)
    rcfg = dataclasses.replace(ref_get_config("qwen3-14b").reduced(),
                               **changes)
    cfg = dataclasses.replace(get_config("qwen3-14b").reduced(), **changes)
    toks = np.random.default_rng(1).integers(0, cfg.vocab_size,
                                             (3, 32)).astype(np.int32)
    rmodel = ref_build_model(rcfg)
    rparams = ref_build_model(rcfg).init(jax.random.key(4))

    def loss_fn(params):
        return ref_forward_and_loss(rmodel, rcfg, params,
                                    {"tokens": jnp.asarray(toks)})[0]

    rloss, rgrads = jax.jit(jax.value_and_grad(loss_fn))(rparams)
    model = build_model(cfg)
    params = bridge.lm_params_to_torch(jax.device_get(rparams), model)
    loss, grads, _ = value_and_grad(model, cfg, params,
                                    {"tokens": torch.from_numpy(toks)})
    assert abs(float(loss) - float(rloss)) <= LOSS_RTOL * abs(float(rloss))
    want = {path_str(tuple(k.key for k in p)): np.asarray(g) for p, g in
            jax.tree_util.tree_leaves_with_path(rgrads)}
    for path, g in tree_flatten_with_path(grads)[0]:
        w = want[path_str(path)]
        err = np.abs(g.numpy() - w).max()
        assert err <= GRAD_RTOL_OF_MAX * np.abs(w).max(), (path, err)
