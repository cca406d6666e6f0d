"""The port's decode attention on the CPU against the JAX package:
``kernels.ref.flash_decode`` against the reference's ``ref.flash_decode``,
and ``kernels.ops.flash_decode`` (on CPU tensors the wrapper runs the
kernel's plain version) against the reference's ``ops.flash_decode``
with the Pallas kernel in interpret mode, as tests/test_kernels.py runs
it, at that file's shapes (MHA, GQA, MQA, G = 5, S < block) in f32 and
bf16, plus lengths 0, 1, S and past S. The CUDA kernel is held against
the plain version on the card in tests/test_torch_cuda.py.

Tolerances (measured here: f32 <= 6e-7 absolute against both): f32 atol
and rtol 1e-5 — the same f32 function, summed in another order. bf16:
both sides compute in f32 and round the output to bf16 once, so an
output may differ by one bf16 ulp: rtol 2^-7, atol 1e-6.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as ref_ops
from repro.kernels import ref as ref_ref
from repro_torch.kernels import flash_decode as fd
from repro_torch.kernels import ops, ref

TOL = {"float32": dict(rtol=1e-5, atol=1e-5),
       "bfloat16": dict(rtol=2 ** -7, atol=1e-6)}
DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}
# tests/test_kernels.py's flash_decode shapes: (B, H, Hkv, S, D, block)
SHAPES = [(2, 8, 8, 256, 64, 128),    # MHA
          (2, 8, 2, 256, 64, 128),    # GQA
          (1, 8, 1, 512, 128, 256),   # MQA
          (3, 10, 2, 384, 64, 128),   # G = 5
          (1, 4, 4, 100, 64, 512)]    # S < block


def _inputs(B, H, Hkv, S, D, dtype, lengths=None, seed=3):
    """The same inputs for both packages: numpy, rounded to ``dtype``."""
    rng = np.random.default_rng(seed)
    jdt, tdt = DTYPES[dtype]
    arrays = [rng.standard_normal(s, np.float32)
              for s in ((B, H, D), (B, S, Hkv, D), (B, S, Hkv, D))]
    arrays = [np.asarray(jnp.asarray(a, jdt).astype(jnp.float32))
              for a in arrays]
    if lengths is None:
        lengths = rng.integers(1, S + 1, (B,))
    lengths = np.asarray(lengths, np.int32)
    j = [jnp.asarray(a, jdt) for a in arrays] + [jnp.asarray(lengths)]
    t = [torch.tensor(a).to(tdt) for a in arrays] + \
        [torch.tensor(lengths)]
    return j, t


def _close(got: torch.Tensor, want, dtype):
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), **TOL[dtype])


@pytest.mark.parametrize("B,H,Hkv,S,D,bs", SHAPES)
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_ref_flash_decode_matches_reference_ref(B, H, Hkv, S, D, bs, dtype):
    (jq, jk, jv, jl), (tq, tk, tv, tl) = _inputs(B, H, Hkv, S, D, dtype)
    got = ref.flash_decode(tq, tk, tv, tl)
    assert got.dtype == tq.dtype and got.shape == (B, H, D)
    _close(got, ref_ref.flash_decode(jq, jk, jv, jl), dtype)


@pytest.mark.parametrize("B,H,Hkv,S,D,bs", SHAPES)
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_ops_flash_decode_matches_pallas_interpret(B, H, Hkv, S, D, bs,
                                                   dtype):
    (jq, jk, jv, jl), (tq, tk, tv, tl) = _inputs(B, H, Hkv, S, D, dtype)
    want = ref_ops.flash_decode(jq, jk, jv, jl, block_size=bs,
                                interpret=True)
    before = dict(fd.LAUNCHES)
    got = ops.flash_decode(tq, tk, tv, tl)
    assert fd.LAUNCHES == before          # CPU tensors: the plain version
    _close(got, want, dtype)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_edge_lengths_match_the_reference(dtype):
    """Lengths 0, 1, S and past S in one batch: the port against the
    reference's Pallas kernel (interpret) and its oracle. A length of 0
    gives zeros, not NaN."""
    B, H, Hkv, S, D = 4, 6, 2, 256, 64
    (jq, jk, jv, jl), (tq, tk, tv, tl) = _inputs(
        B, H, Hkv, S, D, dtype, lengths=[0, 1, S, S + 9])
    got = ops.flash_decode(tq, tk, tv, tl)
    assert torch.equal(got[0], torch.zeros_like(got[0]))
    _close(got, ref_ref.flash_decode(jq, jk, jv, jl), dtype)
    _close(got, ref_ops.flash_decode(jq, jk, jv, jl, block_size=128,
                                     interpret=True), dtype)


def test_grouped_wrapper_is_the_kernel_layout():
    """``flash_decode`` (q4 (B, Hkv, G, D)) on CPU tensors is the plain
    version, and ``ops.flash_decode`` only regroups the heads."""
    _, (tq, tk, tv, tl) = _inputs(2, 6, 3, 40, 16, "float32")
    q4 = tq.reshape(2, 3, 2, 16)
    got = fd.flash_decode(q4, tk, tv, tl, scale=0.25)
    assert got.shape == q4.shape
    assert torch.equal(got, fd.flash_decode_plain(q4, tk, tv, tl,
                                                  scale=0.25))
    assert torch.equal(ops.flash_decode(tq, tk, tv, tl, scale=0.25),
                       got.reshape(2, 6, 16))
    with pytest.raises(ValueError, match="kv heads"):
        ops.flash_decode(tq[:, :5], tk, tv, tl)


def test_reference_kernel_path_pads_the_cache_and_attends_the_pad():
    """A quirk of the reference, recorded: when S is not a multiple of
    its block, ``ops.flash_decode`` pads the cache with zero rows, and a
    length past S (an idle slot past its capacity) then attends those
    pad rows. Its oracle, its jnp decode path and the port attend the
    S rows only."""
    B, H, Hkv, S, D = 1, 2, 1, 600, 64
    (jq, jk, jv, jl), (tq, tk, tv, tl) = _inputs(
        B, H, Hkv, S, D, "float32", lengths=[S + 10])
    padded = np.asarray(ref_ops.flash_decode(jq, jk, jv, jl, block_size=512,
                                             interpret=True))
    oracle = np.asarray(ref_ref.flash_decode(jq, jk, jv, jl))
    got = ops.flash_decode(tq, tk, tv, tl).numpy()
    np.testing.assert_allclose(got, oracle, **TOL["float32"])
    assert np.abs(padded - oracle).max() > 1e-4
