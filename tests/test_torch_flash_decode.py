"""The port's decode attention on the CPU against the JAX package:
``kernels.ref.flash_decode`` against the reference's ``ref.flash_decode``,
and ``kernels.ops.flash_decode`` (on CPU tensors the wrapper runs the
kernel's plain version) against the reference's ``ops.flash_decode``
with the Pallas kernel in interpret mode, as tests/test_kernels.py runs
it, at that file's shapes (MHA, GQA, MQA, G = 5, S < block) and
paligemma's (MQA at G 8, D 256) in f32 and bf16, plus lengths 0, 1, S
and past S. The CUDA kernel is held against the plain version on the
card in tests/test_torch_cuda.py.

Tolerances (measured here: f32 <= 6e-7 absolute against both at D <=
128, 9.6e-7 at D 256): f32 atol and rtol 1e-5 — the same f32 function,
summed in another order. bf16: both sides compute in f32 and round the
output to bf16 once, so an output may differ by one bf16 ulp: rtol
2^-7, atol 1e-6.
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
          (1, 4, 4, 100, 64, 512),    # S < block
          (2, 8, 1, 320, 256, 128)]   # paligemma's MQA: G 8 at D 256


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


# ------------------------------------------- the kernel's split of the keys
#
# flash_decode_split_plain models the CUDA kernel's decomposition: split s
# reduces keys [s * kps, (s + 1) * kps) to (m, l, acc) in f32 and the valid
# splits merge in split order. It is the same f32 function summed in
# another order, so it is held at the tolerances above: f32 1e-5, bf16
# one bf16 ulp (both round one f32 result to bf16 once).

# (G, D, dtype, splits): G 1, 3 and 8; D 8, 64 and 128; one split, two,
# and more splits than the S = 200 keys hold tiles of 16 (40 splits of 5)
SPLIT_CASES = [(1, 8, "float32", 1), (3, 64, "bfloat16", 2),
               (8, 128, "float32", 7), (3, 64, "float32", 40),
               (8, 8, "bfloat16", 40), (1, 128, "bfloat16", 7),
               (3, 128, "bfloat16", 2), (8, 64, "float32", 2),
               (1, 64, "float32", 40), (3, 8, "float32", 7),
               (8, 128, "bfloat16", 1), (1, 8, "bfloat16", 2)]


@pytest.mark.parametrize("G,D,dtype,splits", SPLIT_CASES)
def test_split_plain_matches_the_references(G, D, dtype, splits):
    """Lengths 0, 1, S, S + 7 and each side of the first split boundary,
    with S = 200 not a multiple of the split (ceil(200 / splits) keys):
    the split model against the port's oracle, the reference's oracle and
    the reference's Pallas kernel (interpret, one block of S: no pad)."""
    B, Hkv, S = 7, 2, 200
    kps = -(-S // splits)
    lengths = [0, 1, S, S + 7, max(kps - 1, 0), kps, kps + 1]
    (jq, jk, jv, jl), (tq, tk, tv, tl) = _inputs(B, Hkv * G, Hkv, S, D,
                                                 dtype, lengths=lengths)
    scale = D ** -0.5
    got = fd.flash_decode_split_plain(tq.reshape(B, Hkv, G, D), tk, tv, tl,
                                      scale=scale, splits=splits)
    assert got.dtype == tq.dtype
    got = got.reshape(B, Hkv * G, D)
    assert torch.equal(got[0], torch.zeros_like(got[0]))
    _close(got, ref.flash_decode(tq, tk, tv, tl).float(), dtype)
    _close(got, ref_ref.flash_decode(jq, jk, jv, jl), dtype)
    _close(got, ref_ops.flash_decode(jq, jk, jv, jl, block_size=S,
                                     interpret=True), dtype)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_split_plain_at_the_plans_split(dtype):
    """The split the kernel would run at this shape on a 132-SM card,
    lengths at its boundaries and one either side."""
    B, Hkv, G, S, D = 9, 1, 3, 2048, 64
    splits, kps, _ = fd.split_plan(B, S, Hkv, G, D, 132)
    assert splits > 2
    lengths = [kps - 1, kps, kps + 1, 2 * kps - 1, 2 * kps, S - kps + 1,
               S, 0, 1]
    _, (tq, tk, tv, tl) = _inputs(B, Hkv * G, Hkv, S, D, dtype,
                                  lengths=lengths, seed=5)
    q4 = tq.reshape(B, Hkv, G, D)
    got = fd.flash_decode_split_plain(q4, tk, tv, tl, scale=0.125,
                                      splits=splits, keys_per_split=kps)
    _close(got, fd.flash_decode_plain(q4, tk, tv, tl, scale=0.125).float(),
           dtype)


# (B, S, Hkv, G, D, dtype, SMs): the serve shape, decode_32k, many pairs,
# a short cache, an empty one, odd sizes, and paligemma's D 256 at its
# serve shape and at decode_32k's length
PLAN_SHAPES = [(32, 4096, 3, 3, 64, torch.bfloat16, 132),
               (8, 32768, 8, 5, 128, torch.bfloat16, 132),
               (40, 1024, 8, 5, 128, torch.bfloat16, 132),
               (1056, 4096, 1, 8, 64, torch.bfloat16, 132),
               (2, 100, 1, 1, 8, torch.float32, 132),
               (1, 0, 2, 3, 64, torch.float32, 132),
               (3, 524288, 1, 8, 128, torch.float32, 114),
               (5, 4099, 3, 4, 72, torch.bfloat16, 78),
               (32, 448, 1, 8, 256, torch.bfloat16, 132),
               (8, 32768, 1, 8, 256, torch.bfloat16, 132)]


@pytest.mark.parametrize("B,S,Hkv,G,D,dtype,sms", PLAN_SHAPES)
def test_split_plan_covers_every_key_once(B, S, Hkv, G, D, dtype, sms):
    """Every key of the cache lies in exactly one split, every split
    holds keys, the splits are whole rounds of the CTA's tiles, the grid
    aims at ``ctas_per_sm(D)`` CTAs per SM, and the workspace is small
    against the K/V bytes the pairs read: under 1/16 of them at D <= 128
    (splits of 256 keys or more), under 1/8 past D 128 (splits of 128
    keys: one tile of 16 for each of the wide kernel's 8 warps)."""
    splits, kps, ws = fd.split_plan(B, S, Hkv, G, D, sms)
    pairs = B * Hkv
    assert splits >= 1 and kps % fd.SPLIT_ROUND == 0
    assert splits * kps >= S and (splits - 1) * kps < max(S, 1)
    cover = np.zeros(S, np.int64)
    for s in range(splits):
        cover[s * kps:(s + 1) * kps] += 1
    assert (cover == 1).all()
    assert kps >= min(fd.min_keys_per_split(D), S) or splits == 1
    per_sm = fd.ctas_per_sm(D)
    if pairs >= per_sm * sms:
        assert splits == 1
    else:
        assert pairs * splits <= 2 * per_sm * sms
    assert ws == (pairs, splits, G, D + 2)
    kv_bytes = 2 * pairs * S * D * torch.finfo(dtype).bits // 8
    if S >= fd.min_keys_per_split(D):
        assert 4 * np.prod(ws) * fd.min_keys_per_split(D) // 16 <= kv_bytes


def test_split_plan_reads_shapes_not_lengths():
    """The plan is a function of the shapes and the SM count: choosing
    from the lengths would need them on the host, a sync per call."""
    import inspect
    assert list(inspect.signature(fd.split_plan).parameters) == [
        "B", "S", "Hkv", "G", "D", "sm_count"]
    assert list(inspect.signature(fd.plan).parameters) == ["q4", "k"]


# ------------------------------------------------------- head dim 256

def test_wide_heads_plan_two_waves():
    """Past D 128 the bf16 path runs the wide kernel, one CTA resident
    per SM: the plan aims at WIDE_CTAS_PER_SM per SM there with splits
    down to 128 keys, at CTAS_PER_SM up to D 128. paligemma's serve
    shape: 4 splits of 128 keys, 128 CTAs on 132 SMs; decode_32k's
    length: 17 splits of 1,984 keys over 8 pairs, 136 CTAs."""
    assert [fd.ctas_per_sm(D) for D in (64, 128, 136, 256)] == \
        [fd.CTAS_PER_SM] * 2 + [fd.WIDE_CTAS_PER_SM] * 2
    assert [fd.min_keys_per_split(D) for D in (64, 128, 136, 256)] == \
        [fd.MIN_KEYS_PER_SPLIT] * 2 + [fd.WIDE_MIN_KEYS_PER_SPLIT] * 2
    assert fd.split_plan(32, 448, 1, 8, 256, 132)[:2] == (4, 128)
    assert fd.split_plan(8, 32768, 1, 8, 256, 132)[:2] == (17, 1984)
    assert fd.split_plan(8, 32768, 1, 8, 128, 132)[:2] == (128, 256)


# (B, S, Hkv, G, D, SMs) -> (splits, keys per split): the wide plan at
# paligemma's serve shape, decode_32k's length, the reduced model's
# 8 x 64 tokens, D 136 and 200, a card of 114 SMs, many pairs, and one
# pair over a long cache (WIDE_MAX_SPLITS)
WIDE_PLANS = [((32, 448, 1, 8, 256, 132), (4, 128)),
              ((8, 32768, 1, 8, 256, 132), (17, 1984)),
              ((8, 64, 1, 8, 256, 132), (1, 64)),
              ((3, 130, 1, 8, 136, 132), (2, 128)),
              ((5, 700, 2, 5, 200, 132), (6, 128)),
              ((8, 32768, 1, 8, 256, 114), (15, 2240)),
              ((64, 4096, 1, 8, 256, 132), (3, 1408)),
              ((1, 1 << 20, 1, 8, 256, 132), (132, 8000))]


@pytest.mark.parametrize("shape,want", WIDE_PLANS)
def test_wide_split_plan_numbers(shape, want):
    """The wide plan's splits and keys per split, and its CTAs: one per
    SM or more where the cache has the keys for them."""
    splits, kps, ws = fd.split_plan(*shape)
    assert (splits, kps) == want
    B, S, Hkv, G, D, sms = shape
    assert ws == (B * Hkv, splits, G, D + 2)
    assert splits <= fd.WIDE_MAX_SPLITS
    if S >= fd.WIDE_MIN_KEYS_PER_SPLIT * sms // (B * Hkv):
        assert B * Hkv * splits >= sms


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_head_dim_256_at_the_serve_length_matches_the_reference(dtype):
    """paligemma's serve length (S 448; Hkv 1, G 8, D 256): the kernel's
    split model under the wide plan (4 splits of 128 keys) against the
    reference's Pallas kernel (interpret) and oracle. Lengths stay <= S:
    the reference pads this cache to its 512-key block and a length past
    S would attend the pad (ROADMAP queue 3)."""
    B, Hkv, G, S, D = 4, 1, 8, 448, 256
    splits, kps, _ = fd.split_plan(B, S, Hkv, G, D, 132)
    assert (splits, kps) == (4, 128)
    lengths = [1, kps + 1, 3 * kps - 1, S]
    (jq, jk, jv, jl), (tq, tk, tv, tl) = _inputs(B, Hkv * G, Hkv, S, D,
                                                 dtype, lengths=lengths)
    want = ref_ops.flash_decode(jq, jk, jv, jl, block_size=512,
                                interpret=True)
    split = fd.flash_decode_split_plain(tq.reshape(B, Hkv, G, D), tk, tv,
                                        tl, scale=D ** -0.5, splits=splits,
                                        keys_per_split=kps)
    _close(split.reshape(B, Hkv * G, D), want, dtype)
    _close(split.reshape(B, Hkv * G, D), ref_ref.flash_decode(jq, jk, jv, jl),
           dtype)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_head_dim_256_matches_the_reference(dtype):
    """paligemma's decode (Hkv 1, G 8, D 256): the plain version and the
    kernel's split model at the plan's split against the reference's
    Pallas kernel (interpret) and oracle, lengths 0, 1, S and past S and
    the split boundaries."""
    B, Hkv, G, S, D = 8, 1, 8, 2048, 256
    splits, kps, _ = fd.split_plan(B, S, Hkv, G, D, 132)
    assert splits > 1
    lengths = [0, 1, S, S + 9, kps - 1, kps, kps + 1, S - 1]
    (jq, jk, jv, jl), (tq, tk, tv, tl) = _inputs(B, Hkv * G, Hkv, S, D,
                                                 dtype, lengths=lengths)
    want = ref_ops.flash_decode(jq, jk, jv, jl, block_size=512,
                                interpret=True)
    got = ops.flash_decode(tq, tk, tv, tl)
    assert torch.equal(got[0], torch.zeros_like(got[0]))
    _close(got, want, dtype)
    _close(got, ref_ref.flash_decode(jq, jk, jv, jl), dtype)
    split = fd.flash_decode_split_plain(tq.reshape(B, Hkv, G, D), tk, tv,
                                        tl, scale=D ** -0.5, splits=splits,
                                        keys_per_split=kps)
    _close(split.reshape(B, Hkv * G, D), want, dtype)


def test_the_wrapper_takes_head_dims_up_to_256():
    """The kernel's bound: D a multiple of 8 up to 256 (D 264 raises)."""
    def args(D):
        return (torch.zeros(2, 1, 8, D, dtype=torch.bfloat16),
                torch.zeros(2, 16, 1, D, dtype=torch.bfloat16),
                torch.zeros(2, 16, 1, D, dtype=torch.bfloat16),
                torch.ones(2, dtype=torch.int32))
    assert fd.MAX_HEAD_DIM == 256
    for D in (8, 136, 256):
        fd._check(*args(D))
    for D in (264, 252):
        with pytest.raises(ValueError, match="multiple of 8 up to 256"):
            fd._check(*args(D))
