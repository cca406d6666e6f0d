"""The port's memory-lean attention (``repro_torch.models.flash_attn``)
and the query chunking of ``attention_core`` on the CPU against the JAX
package: the same seeded numpy inputs through the reference's
``flash_attention`` (its custom VJP through ``jax.vjp``) and the port's
``torch.autograd.Function`` (through ``torch.autograd.grad``), with the
same output cotangent.

Tolerances, each measured here:
  * f32: outputs within 2.7e-7 absolute (values of order one), gradients
    within 3.3e-7 of each gradient's largest entry, over the reference's
    six mask cases at kv_chunk 4 and 16, a padded last chunk and
    ``Dv != D`` — the same f32 function with sums in another order. Held
    at the reference's own test's tolerances: outputs rtol/atol 1e-5,
    gradients rtol 2e-4, atol 2e-5.
  * bf16 inputs: outputs and gradients equal bit for bit (the bf16
    operands upcast to f32, whose products are exact, and both sides
    round the f32 results the same way). Held at one bf16 ulp (rtol
    2^-7, atol 1e-6), so that another order of an f32 sum cannot fail
    it where the rounding of a bf16 output falls the other way.
  * ``attention_core(q_chunk=4)``: the reference's, stock or with
    ``flash_vjp``, within 3.6e-7 (values) and 2.8e-7 of the largest
    gradient entry; held at the same 1e-5 / (2e-4, 2e-5).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models.attention import attention_core as ref_attention_core
from repro.models.flash_attn import flash_attention as ref_flash
from repro_torch.models import attention as A
from repro_torch.models.flash_attn import _mm_f32, flash_attention

OUT_TOL = dict(rtol=1e-5, atol=1e-5)
GRAD_TOL = dict(rtol=2e-4, atol=2e-5)
BF16_TOL = dict(rtol=2 ** -7, atol=1e-6)

CASES = [
    dict(),                                   # plain causal
    dict(causal=False),                       # encoder
    dict(window=5),                           # sliding window
    dict(prefix_len=6),                       # prefix-LM
    dict(softcap=4.0),                        # logit softcap
    dict(kv_len=11),                          # static validity
]


def _inputs(B=2, Sq=16, Sk=16, H=4, Hkv=2, D=8, Dv=None, seed=0):
    rng = np.random.default_rng(seed)
    Dv = Dv or D
    q = rng.normal(size=(B, Sq, H, D)).astype(np.float32)
    k = rng.normal(size=(B, Sk, Hkv, D)).astype(np.float32)
    v = rng.normal(size=(B, Sk, Hkv, Dv)).astype(np.float32)
    do = rng.normal(size=(B, Sq, H, Dv)).astype(np.float32)
    return q, k, v, do


def _cfgt(D, **case):
    kw = dict(causal=True, window=0, prefix_len=None, softcap=0.0,
              kv_len=None)
    kw.update(case)
    return (kw["causal"], kw["window"], kw["prefix_len"], D ** -0.5,
            kw["softcap"], kw["kv_len"])


def _np(x):
    return np.asarray(x.detach().float() if torch.is_tensor(x)
                      else np.asarray(x, np.float32), np.float32)


def _vjp_pair(ref_fn, port_fn, q, k, v, do, dtype="float32"):
    """(ref out, ref grads), (port out, port grads) for one cotangent."""
    jd = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}[dtype]
    td = {"float32": torch.float32, "bfloat16": torch.bfloat16}[dtype]
    out, vjp = jax.vjp(ref_fn, *(jnp.asarray(x, jd) for x in (q, k, v)))
    grads = vjp(jnp.asarray(do, jd))
    tq, tk, tv = (torch.tensor(x).to(td).requires_grad_() for x in (q, k, v))
    tout = port_fn(tq, tk, tv)
    tgrads = torch.autograd.grad(tout, (tq, tk, tv), torch.tensor(do).to(td))
    assert tout.dtype == td and all(g.dtype == td for g in tgrads)
    return (out, grads), (tout, tgrads)


def _check(ref, port, out_tol=OUT_TOL, grad_tol=GRAD_TOL):
    (out, grads), (tout, tgrads) = ref, port
    np.testing.assert_allclose(_np(tout), _np(out), **out_tol)
    for name, a, b in zip("qkv", tgrads, grads):
        np.testing.assert_allclose(_np(a), _np(b), err_msg=f"d{name}",
                                   **grad_tol)


def _flash_pair(q, k, v, do, cfgt, kv_chunk, dtype="float32"):
    Sq = q.shape[1]
    return _vjp_pair(
        lambda q, k, v: ref_flash(q, k, v, jnp.arange(Sq), cfgt, kv_chunk),
        lambda q, k, v: flash_attention(q, k, v, torch.arange(Sq), cfgt,
                                        kv_chunk),
        q, k, v, do, dtype)


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("kv_chunk", [4, 16])
def test_flash_matches_reference_values_and_grads(case, kv_chunk):
    q, k, v, do = _inputs()
    _check(*_flash_pair(q, k, v, do, _cfgt(8, **case), kv_chunk))


@pytest.mark.parametrize("case", [dict(), dict(window=5), dict(kv_len=11)])
def test_flash_pads_the_last_chunk(case):
    """Sk % kv_chunk != 0: the keys are padded to whole chunks and the
    pad is masked."""
    q, k, v, do = _inputs(Sq=13, Sk=13)
    _check(*_flash_pair(q, k, v, do, _cfgt(8, **case), 5))


def test_flash_with_dv_not_d():
    q, k, v, do = _inputs(D=12, Dv=8)
    _check(*_flash_pair(q, k, v, do, _cfgt(12), 4))


@pytest.mark.parametrize("case", [dict(), dict(softcap=4.0)])
def test_flash_in_bf16(case):
    q, k, v, do = _inputs(Sk=13, Sq=13)
    _check(*_flash_pair(q, k, v, do, _cfgt(8, **case), 5, "bfloat16"),
           out_tol=BF16_TOL, grad_tol=BF16_TOL)


@pytest.mark.parametrize("flash_vjp", [False, True])
def test_attention_core_q_chunk_matches_reference(flash_vjp):
    q, k, v, do = _inputs(Sq=16, Sk=16, H=6, Hkv=2)
    pos = np.arange(16)
    kw = dict(kv_chunk=8, q_chunk=4, flash_vjp=flash_vjp)
    _check(*_vjp_pair(
        lambda q, k, v: ref_attention_core(q, k, v,
                                           q_positions=jnp.asarray(pos),
                                           **kw),
        lambda q, k, v: A.attention_core(q, k, v,
                                         q_positions=torch.tensor(pos),
                                         **kw),
        q, k, v, do))


def test_q_chunk_only_where_it_divides_the_queries():
    """A q_chunk that does not divide Sq (or is not smaller) leaves the
    attention whole, as the reference's condition does."""
    q, k, v, _ = (torch.tensor(x) for x in _inputs(Sq=12, Sk=12))
    pos = torch.arange(12)
    whole = A.attention_core(q, k, v, q_positions=pos)
    for qc in (5, 12, 24):
        assert torch.equal(A.attention_core(q, k, v, q_positions=pos,
                                            q_chunk=qc), whole)


def test_flash_saves_only_q_k_v_out_m_l():
    """What autograd keeps for the backward pass: the inputs, the
    positions, the output and the (B, Hkv, G, Sq) softmax statistics — no
    (Sq, Sk) score tensor, as the stock core saves."""
    q, k, v, _ = (torch.tensor(x).requires_grad_()
                  for x in _inputs(Sq=16, Sk=16))
    pos = torch.arange(16)
    saved = {}
    for name, fn in (
            ("flash", lambda: flash_attention(q, k, v, pos, _cfgt(8), 4)),
            ("stock", lambda: A.attention_core(q, k, v, q_positions=pos,
                                               kv_chunk=4))):
        shapes = []
        with torch.autograd.graph.saved_tensors_hooks(
                lambda t: shapes.append(tuple(t.shape)) or t,
                lambda t: t):
            fn()
        saved[name] = shapes
    assert sorted(saved["flash"]) == sorted(
        [(2, 16, 4, 8), (2, 16, 2, 8), (2, 16, 2, 8), (16,), (2, 16, 4, 8),
         (2, 2, 2, 16), (2, 2, 2, 16)])
    assert any(s[-2:] == (16, 4) for s in saved["stock"])


def test_mm_f32_upcasts_bf16_operands_on_the_cpu():
    """A product of bf16 operands comes back f32, equal to the product of
    their f32 values (the card's ``out_dtype`` product is held against it
    in tests/test_torch_cuda.py)."""
    g = torch.Generator().manual_seed(0)
    a = torch.randn(3, 5, 64, generator=g).to(torch.bfloat16)
    b = torch.randn(3, 64, 7, generator=g).to(torch.bfloat16)
    out = _mm_f32(a, b)
    assert out.dtype == torch.float32
    assert torch.equal(out, torch.bmm(a.float(), b.float()))
