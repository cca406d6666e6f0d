"""The port's packed substrate against ``repro.core.packing``: layouts
equal field by field, packed buffers byte-equal (tolerance: none — pack
is data movement), per-slice reductions within f32 summation order
(rtol 1e-6: sums of at most a few thousand squares, reduced in another
order)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import packing as ref_packing
from repro.models.lenet import LeNet as RefLeNet
from repro_torch import bridge
from repro_torch.core import packing
from repro_torch.treepath import tree_flatten_with_path, tree_map

SUM_RTOL = 1e-6


def _zoo():
    """The stacked shape zoo of tests/test_packing.py (numpy)."""
    rng = np.random.default_rng(0)
    tree = {
        "emb": rng.standard_normal((100, 33), np.float32),
        "layers": {"wq": rng.standard_normal((4, 17, 23), np.float32),
                   "scale": np.ones((4, 17), np.float32)},
        "bias": np.arange(5, dtype=np.float32),
        "half": np.asarray(jnp.asarray(
            rng.standard_normal((9, 130), np.float32) * 0.1, jnp.bfloat16)),
    }
    marker = {"emb": False, "layers": {"wq": True, "scale": True},
              "bias": False, "half": False}
    return tree, marker


def _lenet():
    ref = RefLeNet()
    params = jax.tree_util.tree_map(np.asarray, ref.init(jax.random.key(7)))
    return params, jax.tree_util.tree_map(lambda _: False, params)


CASES = {"lenet": _lenet, "zoo": _zoo}


@pytest.fixture(params=sorted(CASES))
def case(request):
    tree, marker = CASES[request.param]()
    ref_layout = ref_packing.build_layout(
        jax.tree_util.tree_map(jnp.asarray, tree), marker)
    return tree, marker, ref_layout, packing.build_layout(
        bridge.params_to_torch(tree), marker)


def test_layout_matches_reference_field_by_field(case):
    _, _, ref, got = case
    assert ref.shards == 1 and ref.pad_rows == 0
    for f in ("lane", "block_rows", "total_rows", "num_slices",
              "buffer_shape", "num_blocks"):
        assert getattr(got, f) == getattr(ref, f), f
    assert len(got.segments) == len(ref.segments)
    for a, b in zip(got.segments, ref.segments):
        for f in ("name", "shape", "dtype", "stacked", "layers", "rows", "n",
                  "row_offset", "slice_offset", "adapt"):
            assert getattr(a, f) == getattr(b, f), (a.name, f)


def test_lenet_layout_has_the_expected_shape():
    params, marker = _lenet()
    layout = packing.build_layout(bridge.params_to_torch(params), marker)
    assert [s.name for s in layout.segments] == [
        "conv1/b", "conv1/w", "conv2/b", "conv2/w", "fc1/b", "fc1/w",
        "fc2/b", "fc2/w", "fc3/b", "fc3/w"]
    assert layout.buffer_shape == (272, 512) and layout.num_blocks == 34
    assert sum(s.n for s in layout.segments) == 107_786


def test_pack_is_byte_equal_and_roundtrips(case):
    tree, _, ref, got = case
    t_tree = bridge.params_to_torch(tree)
    buf = packing.pack(got, t_tree)
    want = np.asarray(ref_packing.pack(
        ref, jax.tree_util.tree_map(jnp.asarray, tree)))
    assert buf.dtype == torch.float32
    assert buf.numpy().tobytes() == want.tobytes()
    back = packing.unpack(got, buf)
    tree_map(lambda a, b: (a.dtype == b.dtype and torch.equal(a, b))
             or pytest.fail("unpack did not invert pack"), back, t_tree)
    f32 = packing.unpack(got, buf, dtype=torch.float32)
    assert all(x.dtype == torch.float32 for x in
               jax.tree_util.tree_leaves(f32))


def test_static_maps_match_reference(case):
    _, _, ref, got = case
    np.testing.assert_array_equal(packing.row_slice_ids(got).numpy(),
                                  np.asarray(ref_packing.row_slice_ids(ref)))
    np.testing.assert_array_equal(packing.block_slice_ids(got).numpy(),
                                  np.asarray(ref_packing.block_slice_ids(ref)))
    np.testing.assert_array_equal(packing.adapt_mask(got).numpy(),
                                  np.asarray(ref_packing.adapt_mask(ref)))
    per_slice = np.arange(got.num_slices, dtype=np.float32) * 0.5
    np.testing.assert_array_equal(
        packing.rows_expand(got, torch.from_numpy(per_slice)).numpy(),
        np.asarray(ref_packing.rows_expand(ref, jnp.asarray(per_slice))))
    np.testing.assert_array_equal(
        packing.blocks_expand(got, torch.from_numpy(per_slice)).numpy(),
        np.asarray(ref_packing.blocks_expand(ref, jnp.asarray(per_slice))))


def test_per_slice_reductions_match_reference(case):
    tree, _, ref, got = case
    j_tree = jax.tree_util.tree_map(jnp.asarray, tree)
    t_tree = bridge.params_to_torch(tree)
    buf = packing.pack(got, t_tree)
    want = np.asarray(ref_packing.slice_sumsq(ref, ref_packing.pack(ref,
                                                                    j_tree)))
    np.testing.assert_allclose(packing.slice_sumsq(got, buf).numpy(), want,
                               rtol=SUM_RTOL)
    np.testing.assert_allclose(packing.tree_slice_sumsq(got, t_tree).numpy(),
                               np.asarray(ref_packing.tree_slice_sumsq(
                                   ref, j_tree)), rtol=SUM_RTOL)
    wn, gn = packing.slice_norms(got, buf, 2 * buf)
    np.testing.assert_allclose(wn.numpy(), np.sqrt(want), rtol=SUM_RTOL)
    np.testing.assert_allclose(gn.numpy(), 2 * np.sqrt(want), rtol=SUM_RTOL)


def test_row_fold_matches_block_fold(case):
    """fold_rows of per-row partials (what the CUDA norms_flat gives)
    equals fold_blocks of per-block partials, on LeNet's layout and on
    the stacked zoo: rtol 1e-6, the same squares summed in another
    order."""
    tree, _, _, got = case
    buf = packing.pack(got, bridge.params_to_torch(tree))
    for x in (buf, buf * 0.5 + 1.0):
        sq = torch.square(x)
        per_row = sq.sum(dim=1)
        per_block = sq.reshape(got.num_blocks, -1).sum(dim=1)
        np.testing.assert_allclose(
            packing.fold_rows(got, per_row).numpy(),
            packing.fold_blocks(got, per_block).numpy(), rtol=SUM_RTOL)


def test_quantize_to_storage_and_init_master_match_reference():
    tree, marker = _zoo()
    j_tree = jax.tree_util.tree_map(jnp.asarray, tree)
    ref = ref_packing.build_layout(j_tree, marker)
    got = packing.build_layout(bridge.params_to_torch(tree), marker)
    noisy = np.random.default_rng(1).standard_normal(
        got.buffer_shape).astype(np.float32)
    noisy[np.asarray(ref_packing.pack(ref, j_tree)) == 0] = 0.0
    out = packing.quantize_to_storage(got, torch.from_numpy(noisy))
    want = np.asarray(ref_packing.quantize_to_storage(ref,
                                                      jnp.asarray(noisy)))
    assert out.numpy().tobytes() == want.tobytes()
    master = packing.init_master(got, bridge.params_to_torch(tree))
    assert master.numpy().tobytes() == np.asarray(
        ref_packing.init_master(ref, j_tree)).tobytes()
    assert packing.MASTER_SLOT == ref_packing.MASTER_SLOT
    assert packing.WEIGHT_SLOT == ref_packing.WEIGHT_SLOT


def test_check_marker_and_empty_tree_raise():
    tree, marker = _zoo()
    layout = packing.build_layout(bridge.params_to_torch(tree), marker)
    bad = dict(marker, emb=True)
    with pytest.raises(ValueError, match="disagrees"):
        packing.check_marker(layout, tree, bad)
    with pytest.raises(ValueError, match="empty"):
        packing.build_layout({}, {})


def test_flatten_leaves_no_reference_cycle():
    """A leaf is freed when its last reference goes, without the cyclic
    garbage collector: flattening (which every pack, tree_map and
    optimizer step does) must not park leaves in a reference cycle, or
    device memory outlives its step until the collector runs."""
    import gc
    import weakref
    leaf = torch.zeros(3)
    ref = weakref.ref(leaf)
    enabled = gc.isenabled()
    gc.disable()
    try:
        flat, _ = tree_flatten_with_path({"a": {"w": leaf, "b": 1.0},
                                          "c": 2.0})
        assert [p for p, x in flat if x is leaf] == [("a", "w")]
        del flat, leaf
        assert ref() is None
    finally:
        if enabled:
            gc.enable()
