"""The plain versions of the port's kernels against the JAX package's
Pallas kernels (run with ``interpret=True``, as tests/test_kernels.py
runs them) and its ``kernels/ref.py`` oracles; and the wrappers' CPU
dispatch. The CUDA kernels themselves are held against these plain
versions on the card in tests/test_torch_cuda.py.

Tolerances: row and block sums of squares rtol 1e-6 (512 or 4096 f32
squares summed in another order); the apply pass rtol 1e-6 / atol 1e-7
on the f32 momentum (the same five f32 operations; XLA may contract a
multiply-add). The new weights w' = w - m' cancel near zero, so their
error is held in absolute terms at a few f32 ulp of the unit-scale
weights (atol 1e-6), plus one bf16 ulp (rtol 2^-8) for bf16 weights,
which round from that difference.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import lars_kernels as ref_lk
from repro.kernels import ops as ref_ops
from repro.kernels import ref as ref_ref
from repro_torch.kernels import build, lars_kernels as lk, ops, ref

SUM_RTOL = 1e-6
M_RTOL, M_ATOL = 1e-6, 1e-7
W_ATOL = 1e-6
BF16_RTOL = 2.0 ** -8
DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _buffers(rows, dtype, seed=0):
    """The same inputs for both packages: numpy, rounded to ``dtype``."""
    rng = np.random.default_rng(seed)
    jdt, tdt = DTYPES[dtype]
    w, g, m = (rng.standard_normal((rows, 512), np.float32)
               for _ in range(3))
    lr = (rng.random((rows // 8, 1)) * 0.1).astype(np.float32)
    w = np.asarray(jnp.asarray(w, jdt).astype(jnp.float32))
    g = np.asarray(jnp.asarray(g * 0.01, jdt).astype(jnp.float32))
    j = [jnp.asarray(w, jdt), jnp.asarray(g, jdt), jnp.asarray(m),
         jnp.asarray(lr)]
    t = [torch.tensor(a).to(dt) for a, dt in
         ((w, tdt), (g, tdt), (m, torch.float32), (lr, torch.float32))]
    return j, t


@pytest.mark.parametrize("block_rows", [1, 8])
@pytest.mark.parametrize("rows", [8, 272, 1048])
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_norms_flat_plain_matches_pallas_interpret(rows, dtype, block_rows):
    """Per row (what the CUDA kernel gives) and per 8-row block."""
    (jw, jg, _, _), (tw, tg, _, _) = _buffers(rows, dtype)
    want = ref_lk.norms_flat(jw, jg, block_rows=block_rows, interpret=True)
    before = dict(lk.LAUNCHES)
    for fn in (lk.norms_flat_plain, lk.norms_flat):   # wrapper: plain on CPU
        got = fn(tw, tg, block_rows=block_rows)
        for a, b in zip(got, want):
            assert a.dtype == torch.float32
            assert a.shape == (rows // block_rows,)
            np.testing.assert_allclose(a.numpy(), np.asarray(b),
                                       rtol=SUM_RTOL)
    assert lk.LAUNCHES == before          # no kernel ran


@pytest.mark.parametrize("rows", [8, 272])
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_apply_flat_plain_matches_pallas_interpret(rows, dtype):
    (jw, jg, jm, jlr), (tw, tg, tm, tlr) = _buffers(rows, dtype, seed=1)
    kw = dict(momentum=0.9, weight_decay=1e-4)
    want_w, want_m = ref_lk.apply_flat(jw, jg, jm, jlr, interpret=True,
                                       **kw)
    before = dict(lk.LAUNCHES)
    for fn in (lk.apply_flat_plain, lk.apply_flat):
        got_w, got_m = fn(tw, tg, tm, tlr, **kw)
        assert got_w.dtype == DTYPES[dtype][1]
        assert got_m.dtype == torch.float32
        np.testing.assert_allclose(got_m.numpy(), np.asarray(want_m),
                                   rtol=M_RTOL, atol=M_ATOL)
        np.testing.assert_allclose(
            got_w.float().numpy(), np.asarray(want_w, np.float32),
            rtol=M_RTOL if dtype == "float32" else BF16_RTOL, atol=W_ATOL)
    assert lk.LAUNCHES == before


@pytest.mark.parametrize("shape,stacked", [
    ((128,), False), ((5, 7), False), ((3, 33, 17), True),
    ((1, 100), True), ((600, 40), False)])
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_per_leaf_oracles_and_packed_path_match_reference(shape, stacked,
                                                           dtype):
    """kernels/ref.py against the JAX package's, and the packed passes
    over a one-leaf layout against both."""
    from repro_torch.core import packing
    rng = np.random.default_rng(2)
    jdt, tdt = DTYPES[dtype]
    w, g, m = (np.asarray(jnp.asarray(rng.standard_normal(shape,
                                                          np.float32), jdt)
                          .astype(jnp.float32)) for _ in range(3))
    lr = np.linspace(0.1, 0.3, shape[0]).astype(np.float32) if stacked \
        else np.float32(0.17)
    jw, jg = jnp.asarray(w, jdt), jnp.asarray(g, jdt)
    tw, tg = torch.tensor(w).to(tdt), torch.tensor(g).to(tdt)
    tm = torch.tensor(m)
    layout = packing.build_layout({"x": tw}, {"x": stacked})
    pack = lambda x: packing.pack(layout, {"x": x})  # noqa: E731
    want = ref_ref.lars_norms(jw, jg, stacked=stacked)
    packed = ops.lars_norms_packed(layout, pack(tw), pack(tg))
    for got in (ref.lars_norms(tw, tg, stacked=stacked),
                tuple(x if stacked else x[0] for x in packed)):
        for a, b in zip(got, want):
            np.testing.assert_allclose(a.numpy(), np.asarray(b),
                                       rtol=SUM_RTOL)
    kw = dict(momentum=0.9, weight_decay=1e-4)
    want_w, want_m = ref_ref.lars_apply(jw, jg, jnp.asarray(m),
                                        local_lr=lr, **kw)
    pw, pm = ops.lars_apply_packed(
        layout, pack(tw), pack(tg), pack(tm),
        torch.broadcast_to(torch.tensor(lr).reshape(-1),
                           (layout.num_slices,)), **kw)
    for got_w, got_m in (ref.lars_apply(tw, tg, tm, local_lr=lr, **kw),
                         (packing.unpack(layout, pw)["x"],
                          packing.unpack(layout, pm, torch.float32)["x"])):
        assert got_w.dtype == tdt and got_w.shape == shape
        np.testing.assert_allclose(got_m.numpy(), np.asarray(want_m),
                                   rtol=M_RTOL, atol=M_ATOL)
        np.testing.assert_allclose(
            got_w.float().numpy(), np.asarray(want_w, np.float32),
            rtol=M_RTOL if dtype == "float32" else BF16_RTOL, atol=W_ATOL)


def test_packed_norms_match_reference_ops_on_lenet_layout():
    import jax
    from repro.core import packing as ref_packing
    from repro.models.lenet import LeNet as RefLeNet
    from repro_torch import bridge
    from repro_torch.core import packing
    params = RefLeNet().init(jax.random.key(0))
    marker = jax.tree_util.tree_map(lambda _: False, params)
    rlay = ref_packing.build_layout(params, marker)
    buf = ref_packing.pack(rlay, params)
    want = ref_ops.lars_norms_packed(rlay, buf, buf * 0.5)
    tparams = bridge.params_to_torch(jax.tree_util.tree_map(np.asarray,
                                                            params))
    lay = packing.build_layout(tparams, marker)
    tbuf = torch.from_numpy(np.asarray(buf))
    got = ops.lars_norms_packed(lay, tbuf, tbuf * 0.5)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=SUM_RTOL)


def test_wrappers_reject_mixed_or_unknown_devices():
    t = torch.zeros(8, 512)
    with pytest.raises(ValueError, match="CPU or all on one CUDA"):
        lk.norms_flat(t, t.to("meta"))


def test_check_use_kernels():
    cpu, cuda = torch.device("cpu"), torch.device("cuda")
    for mode, device in (("auto", cpu), ("auto", cuda), (False, cpu),
                         (True, cuda)):
        ops.check_use_kernels(mode, device)
    with pytest.raises(ValueError, match="needs CUDA buffers"):
        ops.check_use_kernels(True, cpu)
    with pytest.raises(ValueError, match="needs CPU buffers"):
        ops.check_use_kernels(False, cuda)
    with pytest.raises(ValueError, match="must be"):
        ops.check_use_kernels("pallas", cpu)


@pytest.mark.parametrize("block_rows", [2, 4, 8])
def test_norms_flat_takes_per_row_partials_only_on_the_card(block_rows):
    """The kernel sums per row: a CUDA call with any other block_rows is
    refused before any launch, as one with a wrong shape is."""
    t = torch.zeros(8, 512)
    with pytest.raises(ValueError, match="block_rows=1"):
        lk._check_buffers(block_rows, t, t, kernel_rows=1)
    assert lk._check_buffers(1, t, t, kernel_rows=1) == (8, 512)


def test_check_buffers_rejects_misaligned_views():
    """The kernels load 16 B at a time: a contiguous view at an odd
    offset is refused before launch, not faulted on inside the kernel."""
    flat = torch.zeros(2 * 8 * 512 + 4)
    lk._check_buffers(8, flat[:8 * 512].view(8, 512))
    lk._check_buffers(8, flat[4:4 + 8 * 512].view(8, 512))
    with pytest.raises(ValueError, match="16-byte"):
        lk._check_buffers(8, flat[1:1 + 8 * 512].view(8, 512))


def test_build_is_keyed_by_source_and_flags(monkeypatch):
    path = build.library_path("lars_kernels")
    assert path.parent == build.BUILD_DIR and path.suffix == ".so"
    assert path == build.library_path("lars_kernels")
    monkeypatch.setitem(build.SOURCES, "lars_kernels", ())
    assert build.library_path("lars_kernels") != path


def test_build_without_nvcc_raises(monkeypatch):
    monkeypatch.setattr(build.shutil, "which", lambda _: None)
    monkeypatch.setattr(build.os.path, "exists", lambda _: False)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        build.nvcc()
