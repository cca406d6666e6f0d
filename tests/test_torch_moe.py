"""The port's MoE family (``repro_torch.models.moe`` and the MoE branches
of ``models/lm.py``) on the CPU against the JAX package, on the same
seeded numpy inputs and the reference's initial params carried across
by ``bridge``.

The reference's own reduced granite routes top-4 of 4 experts and never
drops a token, so the config here is that reduced granite with 8
experts, top-2 and ``capacity_factor`` 0.5: capacity drops slots in
every call, which the tests assert.

Tolerances, each measured here:
  * ``moe_block`` in f32: outputs within 2.1e-6 absolute (values up to
    3.2), the aux loss and ``dropped_frac`` equal: held at rtol/atol
    1e-5 and 1e-6 relative; gradients within 9.1e-7 of each leaf's
    largest entry: held at 1e-5 of it.
  * ``moe_block`` in bf16 is not the reference's bit for bit. XLA's
    ``jax.nn.silu`` rounds the sigmoid to bf16 before its product, and
    torch's ``F.silu`` rounds once. That moves a third to two thirds of
    the outputs, by at most 0.0156 on values up to 3.2; the aux loss
    within 9.4e-8 relative. Held at rtol/atol 2^-5 and 1e-6. With
    products that are exact in bf16 (integer inputs, a relu expert) the
    port equals the reference bit for bit: its combine rounds as the
    reference's does, a token's k contributions added in ascending
    expert order. Added in the reverse order, the same case differs in
    5,012 of 16,384 outputs.
  * the LM (2 layers, stock and through ``flash_vjp`` + ``attn_q_chunk``
    + ``loss_chunk`` + ``remat_block``): logits within 1.3e-6, losses
    7.6e-8 and the aux loss 9.3e-8 relative, gradients 1.9e-6 of each
    leaf's largest entry; held as tests/test_torch_lm_lean.py holds the
    dense LM (rtol/atol 1e-5, 1e-6, 1e-5 of the largest entry), the aux
    loss at 1e-6. 5 LARS steps: losses held at 1e-6 relative.
  * prefill, ``prefill_at`` and 16 decode steps: logits and cache rows
    held at rtol/atol 1e-5; the engine's greedy tokens equal.
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
from repro.models import moe as rmoe
from repro.serve import ServeEngine as RefServeEngine
from repro.train import TrainPipeline as RefPipeline
from repro.train.step import _forward_and_loss as ref_forward_and_loss
from repro_torch import bridge
from repro_torch.configs import get_config, param_count
from repro_torch.core import lars
from repro_torch.launch import serve as launch_serve
from repro_torch.launch import train as launch_train
from repro_torch.models import build_model
from repro_torch.models import lm as lm_module
from repro_torch.models import moe
from repro_torch.serve import ServeEngine
from repro_torch.train import TrainPipeline, train_state_from_params
from repro_torch.train.step import value_and_grad
from repro_torch.treepath import path_str, tree_flatten_with_path, tree_leaves
from _torch_threads import one_torch_thread  # noqa: F401
from test_torch_serve import SCHEDULE, _drive

pytestmark = pytest.mark.usefixtures("one_torch_thread")

ARCH = "granite-moe-3b-a800m"
DROP = dict(num_experts=8, experts_per_token=2, capacity_factor=0.5)
TOL = dict(rtol=1e-5, atol=1e-5)
BF16_TOL = dict(rtol=2 ** -5, atol=2 ** -5)
AUX_RTOL = 1e-6
LOSS_RTOL = 1e-6
GRAD_RTOL_OF_MAX = 1e-5
SEQ = 32
_CACHE = {}


def _cfgs(**changes):
    changes = dict(DROP, **changes)
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


# ------------------------------------------------------------------ config

def test_granite_config_is_the_references_and_counts_its_params():
    """get_config no longer refuses granite; the config field for field;
    param_count as the reference's; and a full-size meta-device init
    (which draws nothing) of the analytic count plus its norm scales."""
    cfg, rcfg = get_config(ARCH), ref_get_config(ARCH)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(rcfg)
    assert param_count(cfg) == ref_param_count(rcfg) == (3_298_693_632,
                                                         882_774_528)
    gen = torch.Generator().manual_seed(0)
    state = gen.get_state()
    params = build_model(cfg).init(gen, "meta")
    assert torch.equal(gen.get_state(), state)
    n = sum(x.numel() for x in tree_leaves(params))
    assert n == param_count(cfg)[0] + (2 * cfg.num_layers + 1) * cfg.d_model
    assert tuple(params["layers"]["moe"]["wi"].shape) == (32, 40, 1536, 512)
    assert params["layers"]["moe"]["router"].dtype == torch.float32


def test_init_layout_and_distributions():
    """The port's own init (with a shared expert): the reference's tree,
    shapes and dtypes, at its distributions; one seed, one set of
    weights."""
    rcfg, cfg = _cfgs(num_shared_experts=1, dtype="bfloat16")
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
    m, d = p["layers"]["moe"], cfg.d_model
    assert abs(m["router"].std().item() * d ** 0.5 / 0.1 - 1) < 0.05
    for name, d_in in (("wi", d), ("wg", d), ("wo", cfg.moe_d_ff)):
        assert abs(m[name].float().std().item() * d_in ** 0.5 - 1) < 0.03
    assert set(m["shared"]) == {"wi", "wg", "wo"}
    assert model.stacked_marker(p)["layers"]["moe"]["wi"] is True
    again = model.init(torch.Generator().manual_seed(0), "cpu")
    assert all(torch.equal(a, b) for a, b in zip(tree_leaves(p),
                                                 tree_leaves(again)))


# --------------------------------------------------------------- moe_block

def _block_inputs(rcfg, dtype, seed=0, shape=(4, 16)):
    jdt = jnp.dtype(dtype)
    p = jax.tree_util.tree_map(np.asarray, rmoe.init_moe(
        jax.random.key(seed), rcfg, rcfg.d_model, jdt))
    x = np.random.default_rng(seed).standard_normal(
        shape + (rcfg.d_model,)).astype(np.float32)
    return p, x


def _both(rcfg, cfg, p, x, dtype):
    rout, raux = rmoe.moe_block(
        rcfg, jax.tree_util.tree_map(jnp.asarray, p),
        jnp.asarray(x).astype(jnp.dtype(dtype)))
    out, aux = moe.moe_block(cfg, bridge.params_to_torch(p),
                             torch.from_numpy(x).to(getattr(torch, dtype)))
    return (out, aux), (rout, raux)


@pytest.mark.parametrize("shared", [0, 1])
@pytest.mark.parametrize("groups", [1, 4])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_moe_block_matches_the_reference(dtype, groups, shared):
    rcfg, cfg = _cfgs(moe_groups=groups, num_shared_experts=shared,
                      dtype=dtype)
    p, x = _block_inputs(rcfg, dtype)
    (out, aux), (rout, raux) = _both(rcfg, cfg, p, x, dtype)
    assert out.dtype == getattr(torch, dtype) and out.shape == x.shape
    _close(out, rout, **(TOL if dtype == "float32" else BF16_TOL))
    assert float(aux["dropped_frac"]) == float(raux["dropped_frac"]) > 0
    np.testing.assert_allclose(float(aux["aux_loss"]),
                               float(raux["aux_loss"]), rtol=AUX_RTOL)


def test_a_bf16_router_is_upcast_as_the_reference():
    """Under a bf16 compute policy every float leaf is bf16, the router
    too: the f32 product upcasts it, as JAX promotes f32 @ bf16."""
    rcfg, cfg = _cfgs(dtype="bfloat16")
    p, x = _block_inputs(rcfg, "bfloat16", seed=5)
    p["router"] = np.asarray(jnp.asarray(p["router"], jnp.bfloat16))
    assert p["router"].dtype.name == "bfloat16"
    (out, aux), (rout, raux) = _both(rcfg, cfg, p, x, "bfloat16")
    _close(out, rout, **BF16_TOL)
    assert float(aux["dropped_frac"]) == float(raux["dropped_frac"]) > 0
    np.testing.assert_allclose(float(aux["aux_loss"]),
                               float(raux["aux_loss"]), rtol=AUX_RTOL)


def test_bf16_combine_is_the_references_bit_for_bit():
    """Integer inputs and a relu expert make every product exact in bf16,
    so only the combine rounds: the port's output equals the
    reference's bit for bit (a token's k contributions are added in
    ascending expert order, each add rounded to bf16)."""
    rcfg, cfg = _cfgs(experts_per_token=4, capacity_factor=1.0, act="relu",
                      dtype="bfloat16")
    d, E, ff = cfg.d_model, cfg.num_experts, cfg.moe_d_ff
    rng = np.random.default_rng(0)

    def sparse(shape, density, scale):
        return (rng.integers(-1, 2, shape) * (rng.random(shape) < density)
                * scale).astype(np.float32)

    p = {"router": (rng.integers(-4, 5, (d, E)) / 8).astype(np.float32),
         "wi": sparse((E, d, ff), 0.1, 1.0),
         "wo": sparse((E, ff, d), 0.05, 0.25)}
    x = sparse((4, 16, d), 0.5, 1.0)
    rp = {k: jnp.asarray(v, jnp.bfloat16 if v.ndim == 3 else jnp.float32)
          for k, v in p.items()}
    rout, raux = rmoe.moe_block(rcfg, rp, jnp.asarray(x, jnp.bfloat16))
    tp = {k: torch.from_numpy(v).to(torch.bfloat16 if v.ndim == 3
                                    else torch.float32)
          for k, v in p.items()}
    out, aux = moe.moe_block(cfg, tp, torch.from_numpy(x).bfloat16())
    assert float(aux["dropped_frac"]) == float(raux["dropped_frac"]) > 0
    assert np.array_equal(_np(out), _np(rout))


@pytest.mark.parametrize("groups,shared", [(1, 0), (4, 1)])
def test_moe_gradients_match_jax_grad(groups, shared):
    """Gradients of sum(out * r) + aux_loss to x and every leaf (router,
    wi, wg, wo; the shared expert's), f32."""
    rcfg, cfg = _cfgs(moe_groups=groups, num_shared_experts=shared,
                      dtype="float32")
    p, x = _block_inputs(rcfg, "float32", seed=1)
    r = np.random.default_rng(2).standard_normal(x.shape).astype(np.float32)

    def ref_loss(p, x):
        out, aux = rmoe.moe_block(rcfg, p, x)
        return jnp.sum(out * r) + aux["aux_loss"]

    rgx, rgp = jax.grad(ref_loss, argnums=(1, 0))(
        jax.tree_util.tree_map(jnp.asarray, p), jnp.asarray(x))
    tp = bridge.params_to_torch(p)
    leaves = [(k, t.requires_grad_(True))
              for k, t in tree_flatten_with_path(tp)[0]]
    tx = torch.from_numpy(x).requires_grad_(True)
    out, aux = moe.moe_block(cfg, tp, tx)
    grads = torch.autograd.grad(
        (out * torch.from_numpy(r)).sum() + aux["aux_loss"],
        [tx] + [t for _, t in leaves])
    got = dict(zip(["x"] + [path_str(k) for k, _ in leaves], grads))
    want = {path_str(tuple(k.key for k in path)): np.asarray(g) for path, g
            in jax.tree_util.tree_leaves_with_path(rgp)}
    want["x"] = np.asarray(rgx)
    assert set(got) == set(want) >= {"x", "router", "wi", "wg", "wo"}
    for name, g in got.items():
        err = np.abs(g.numpy() - want[name]).max()
        assert err <= GRAD_RTOL_OF_MAX * np.abs(want[name]).max(), (name, err)


def test_router_ties_go_to_the_lower_expert_index():
    """A zero router ties every expert, so every token takes experts
    0..k-1 with gates 1/k (jax.lax.top_k's order); a router whose
    columns 2 and 5 are equal ties those two, and expert 2 wins."""
    rcfg, cfg = _cfgs(capacity_factor=4.0, dtype="float32")
    p, x = _block_inputs(rcfg, "float32", seed=3)
    k = cfg.experts_per_token
    p0 = dict(p, router=np.zeros_like(p["router"]))
    (out, aux), (rout, _) = _both(rcfg, cfg, p0, x, "float32")
    assert float(aux["dropped_frac"]) == 0.0
    tp = bridge.params_to_torch(p)
    xt = torch.from_numpy(x)
    want = sum(_expert(cfg, tp, e, xt) for e in range(k)) / k
    _close(out, want)
    _close(out, rout)
    # columns 2 and 5 equal and leading for every token
    router = np.array(p["router"])
    router[:, 5] = router[:, 2] = 0.0
    router[:, [0, 1, 3, 4, 6, 7]] = -50.0 * np.sign(
        x.reshape(-1, cfg.d_model).mean(0))[:, None]
    (out, _), (rout, _) = _both(rcfg, cfg, dict(p, router=router), x,
                                "float32")
    probs = torch.softmax(xt @ torch.from_numpy(router), -1)
    assert bool((probs[..., 2] == probs[..., 5]).all())
    _close(out, rout)


def _expert(cfg, p, e, x):
    h = torch.nn.functional.silu(x @ p["wg"][e]) * (x @ p["wi"][e])
    return h @ p["wo"][e]


def test_capacity_drops_the_later_token_of_two():
    """Two tokens, both routed to expert 0 of 2, top-1, capacity 1: the
    first is kept and the second dropped (its output is zero), as the
    reference's stable sort keeps the lower token index."""
    rcfg, cfg = _cfgs(num_experts=2, experts_per_token=1,
                      capacity_factor=1.0, dtype="float32")
    p, _ = _block_inputs(rcfg, "float32", seed=4)
    x = np.abs(np.random.default_rng(4).standard_normal(
        (1, 2, cfg.d_model))).astype(np.float32)
    router = np.stack([np.ones(cfg.d_model), -np.ones(cfg.d_model)],
                      1).astype(np.float32)
    (out, aux), (rout, raux) = _both(rcfg, cfg, dict(p, router=router), x,
                                     "float32")
    assert float(aux["dropped_frac"]) == float(raux["dropped_frac"]) == 0.5
    tp = bridge.params_to_torch(p)
    _close(out[0, 0], _expert(cfg, tp, 0, torch.from_numpy(x[0, 0])))
    assert bool((out[0, 1] == 0).all())
    _close(out, rout)


def test_moe_groups_must_split_the_tokens():
    _, cfg = _cfgs(moe_groups=3)
    p = moe.init_moe(torch.Generator().manual_seed(0), cfg, cfg.d_model,
                     torch.float32, "cpu")
    with pytest.raises(ValueError, match="moe_groups"):
        moe.moe_block(cfg, p, torch.zeros(2, 4, cfg.d_model))


# every slot's routing where the rows are split over ranks (equal
# blocks, each with the counts of the blocks before it as its offsets):
# measured 6.0e-8 at most between a block's expert outputs and the
# whole batch's rows (the products run on a buffer of the block's slots)
BLOCK_OUT_ATOL = 1e-6


def _global_positions(cfg, r, s, lower=None):
    """Each slot's (kept, position in its group and expert of the whole
    batch), in token-major slot order."""
    pos = s.pos if lower is None else \
        s.pos + lower[r.first:r.first + r.groups].reshape(-1)[s.key]
    back = lambda t: torch.empty_like(t).scatter_(0, s.order, t)  # noqa
    return back(s.keep), back(pos)


@pytest.mark.parametrize("groups,blocks,rows", [
    (1, 2, 8), (1, 4, 8), (2, 2, 8), (2, 4, 8), (4, 2, 8), (4, 3, 6)])
def test_row_blocks_with_global_offsets_route_as_the_whole_batch(
        groups, blocks, rows):
    """The routing ``moe_block`` runs over ``data``, on a hand-made split
    without a process group: the (rows, 8) tokens cut into ``blocks``
    equal row blocks (a dispatch group within a block, spanning blocks,
    or, at 4 groups over 3 blocks, a block that starts mid-group), each
    routed with the slot counts of the blocks before it as its offsets.
    Every slot's kept decision and position are the whole batch's,
    exactly; each block's combined expert outputs are the whole batch's
    rows; the blocks' aux losses average to the whole's and each block's
    ``dropped_frac`` is the whole's."""
    _, cfg = _cfgs(moe_groups=groups)
    p = moe.init_moe(torch.Generator().manual_seed(0), cfg, cfg.d_model,
                     torch.float32, "cpu")
    x = torch.randn(rows, 8, cfg.d_model,
                    generator=torch.Generator().manual_seed(1))
    whole, aux = moe.moe_block(cfg, p, x)
    xt = x.reshape(-1, cfg.d_model)
    n = xt.shape[0] // blocks
    r = moe.route(cfg, p["router"], xt)
    keep, pos = _global_positions(cfg, r, moe.place(cfg, r))
    assert not keep.all()
    parts = [moe.route(cfg, p["router"], xt[i * n:(i + 1) * n],
                       start=i * n, total=xt.shape[0])
             for i in range(blocks)]
    every = sum(q.counts for q in parts)
    assert torch.equal(every, r.counts)
    lower = torch.zeros_like(every)
    got_keep, got_pos, outs, auxes = [], [], [], []
    for i, q in enumerate(parts):
        s = moe.place(cfg, q, lower)
        k, at = _global_positions(cfg, q, s, lower)
        got_keep.append(k)
        got_pos.append(at)
        outs.append(moe._experts(cfg, p, xt[i * n:(i + 1) * n], q, s,
                                 None, compact=True)[0])
        auxes.append(moe.balance(cfg, q, every, blocks))
        lower = lower + q.counts
    assert torch.equal(torch.cat(got_keep), keep)
    assert torch.equal(torch.cat(got_pos), pos)
    torch.testing.assert_close(torch.cat(outs), whole.reshape(xt.shape),
                               rtol=0, atol=BLOCK_OUT_ATOL)
    torch.testing.assert_close(sum(a for a, _ in auxes) / blocks,
                               aux["aux_loss"], rtol=1e-6, atol=0)
    for _, dropped in auxes:
        assert dropped == aux["dropped_frac"]


# ------------------------------------------------------------------- LM

def _init(num_layers=2):
    if num_layers not in _CACHE:
        rcfg, _ = _cfgs(num_layers=num_layers)
        _CACHE[num_layers] = jax.tree_util.tree_map(
            np.asarray, ref_build_model(rcfg).init(jax.random.key(2)))
    return _CACHE[num_layers]


LEAN = {"stock": {},
        "lean": dict(flash_vjp=True, attn_q_chunk=8, loss_chunk=8,
                     remat_block=1)}


@pytest.mark.parametrize("lean", sorted(LEAN))
def test_forward_loss_aux_and_gradients_match_the_reference(lean):
    rcfg, cfg = _cfgs(**LEAN[lean])
    toks = _tokens(cfg)
    rmodel = ref_build_model(rcfg)

    def loss_fn(params):
        loss, (logits, aux) = ref_forward_and_loss(
            rmodel, rcfg, params, {"tokens": jnp.asarray(toks)})
        return loss, (logits, aux["aux_loss"])

    (rloss, (rlogits, raux)), rgrads = jax.jit(jax.value_and_grad(
        loss_fn, has_aux=True))(jax.tree_util.tree_map(jnp.asarray,
                                                       _init()))
    model = build_model(cfg)
    params = bridge.lm_params_to_torch(_init(), model)
    loss, grads, (logits, aux) = value_and_grad(
        model, cfg, params, {"tokens": torch.from_numpy(toks)})
    if lean == "stock":
        _close(logits, rlogits)
    else:
        assert logits is None and rlogits is None
    assert float(aux["aux_loss"]) > 0 and not aux["aux_loss"].requires_grad
    np.testing.assert_allclose(float(aux["aux_loss"]), float(raux),
                               rtol=AUX_RTOL)
    assert abs(float(loss) - float(rloss)) <= LOSS_RTOL * abs(float(rloss))
    want = {path_str(tuple(k.key for k in p)): np.asarray(v) for p, v in
            jax.tree_util.tree_leaves_with_path(rgrads)}
    leaves = tree_flatten_with_path(grads)[0]
    assert {path_str(p) for p, _ in leaves} == set(want)
    for path, g in leaves:
        w = want[path_str(path)]
        err = np.abs(g.numpy() - w).max()
        assert err <= GRAD_RTOL_OF_MAX * np.abs(w).max(), (path, err)


def test_lars_steps_and_packed_layout_match_the_reference():
    """5 LARS steps of the LM from one init: the reference's pipeline
    (its jnp engine) and the port's (the plain versions on the CPU), the
    same token batches; the packed layout's segment table (the 4-D
    expert stacks as per-layer slices) the reference's."""
    rcfg, cfg = _cfgs()
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
    assert "layers/moe/wi" in [s.name for s in layout.segments]
    pipe = TrainPipeline(model, opt, cfg)
    losses, rlosses = [], []
    for toks in _tokens(cfg, (5, 4, SEQ), 6):
        state, m = pipe(state, {"tokens": torch.from_numpy(toks)})
        rstate, rm = rpipe(rstate, {"tokens": jnp.asarray(toks)})
        losses.append(float(m["loss"]))
        rlosses.append(float(rm["loss"]))
        np.testing.assert_allclose(float(m["aux_loss"]),
                                   float(rm["aux_loss"]), rtol=1e-5)
    np.testing.assert_allclose(losses, rlosses, rtol=LOSS_RTOL)


def _lm_pair():
    rcfg, cfg = _cfgs()
    rmodel, model = ref_build_model(rcfg), build_model(cfg)
    return (cfg, model, bridge.lm_params_to_torch(_init(), model), rmodel,
            jax.tree_util.tree_map(jnp.asarray, _init()))


@pytest.fixture
def dropped(monkeypatch):
    """Every ``dropped_frac`` the port's LM computes while the test runs."""
    seen = []

    def recording(cfg, p, x):
        out, aux = moe.moe_block(cfg, p, x)
        seen.append(float(aux["dropped_frac"]))
        return out, aux

    monkeypatch.setattr(lm_module, "moe_block", recording)
    return seen


def test_prefill_and_prefill_at_match_the_reference(dropped):
    """Length-masked prefill (the pad positions routed too, as the
    reference's), then admission of two prompts into a live cache."""
    cfg, model, params, rmodel, rparams = _lm_pair()
    toks = _tokens(cfg, (3, 12), 5)
    lens = np.array([12, 4, 9], np.int32)
    logits, cache = model.prefill(params, torch.tensor(toks), cache_len=20,
                                  lengths=torch.tensor(lens))
    rlogits, rcache = rmodel.prefill(rparams, jnp.asarray(toks),
                                     cache_len=20, lengths=jnp.asarray(lens))
    _close(logits, rlogits)
    for name in cache:
        _close(cache[name], rcache[name])
    rng = np.random.default_rng(6)
    rcache = {k: jnp.asarray(rng.standard_normal(v.shape), v.dtype)
              if k != "pos" else jnp.asarray([3, 5, 7, 9], jnp.int32)
              for k, v in rmodel.init_cache(4, 24).items()}
    cache = bridge.cache_to_torch(jax.device_get(rcache))
    toks, lens = _tokens(cfg, (2, 8), 7), np.array([8, 5], np.int32)
    slots = np.array([2, 0], np.int32)
    logits, out = model.prefill_at(params, cache, torch.tensor(toks),
                                   torch.tensor(slots),
                                   lengths=torch.tensor(lens))
    rlogits, rout = rmodel.prefill_at(rparams, rcache, jnp.asarray(toks),
                                      jnp.asarray(slots),
                                      lengths=jnp.asarray(lens))
    _close(logits, rlogits)
    _close(out["pos"], rout["pos"])
    for name in ("k", "v"):
        _close(out[name][:, :, :8], rout[name][:, :, :8])
    assert min(dropped) > 0


def test_decode_steps_match_the_reference(dropped):
    """Prefill, then 16 decode steps fed the same tokens, the reference
    through its flash-decode path: logits and the cache after every
    step. Every decode step routes the whole batch and drops slots."""
    cfg, model, params, rmodel, rparams = _lm_pair()
    toks = _tokens(cfg, (4, 10), 8)
    lens = np.array([10, 3, 6, 1], np.int32)
    _, cache = model.prefill(params, torch.tensor(toks), cache_len=32,
                             lengths=torch.tensor(lens))
    _, rcache = rmodel.prefill(rparams, jnp.asarray(toks), cache_len=32,
                               lengths=jnp.asarray(lens))
    dropped.clear()
    for t in _tokens(cfg, (16, 4, 1), 9):
        logits, cache = model.decode_step(params, cache, torch.tensor(t))
        rlogits, rcache = rmodel.decode_step(rparams, rcache, jnp.asarray(t),
                                             use_flash=True)
        _close(logits, rlogits)
        for name in cache:
            _close(cache[name], rcache[name])
    assert len(dropped) == 16 * cfg.num_layers and max(dropped) > 0


def test_engine_greedy_tokens_match_the_reference_while_decode_drops(
        dropped):
    """Staggered heterogeneous requests through 4 slots (idle slots
    decode with the rest, as in the reference): the same greedy tokens,
    finishing on the same ticks, while capacity drops slots."""
    cfg, model, params, rmodel, rparams = _lm_pair()
    kw = dict(slots=4, capacity=32, prefill_bucket=8)
    got = _drive(ServeEngine(model, params, cfg, **kw), SCHEDULE, cfg)
    want = _drive(RefServeEngine(rmodel, rparams, cfg=None, **kw),
                  SCHEDULE, cfg)
    assert got == want
    assert sorted(got[0]) == list(range(7))
    assert max(dropped) > 0


# ------------------------------------------------------------------ launch

def test_launch_train_runs_granite_reduced_on_the_cpu():
    summary = launch_train.main([
        "--arch", ARCH, "--reduced", "--device", "cpu", "--steps", "3",
        "--batch", "4", "--seq", "16", "--optimizer", "lars",
        "--log-every", "0"])
    assert summary["arch"] == ARCH + "-reduced"
    assert len(summary["losses"]) == 3
    assert all(np.isfinite(summary["losses"]))
    assert all(a > 0 for a in summary["aux_losses"])


def test_launch_train_runs_granite_on_the_large_batch_path():
    """bf16 compute (the router leaf cast to bf16 too), int8 momentum,
    2 microbatches, with capacity dropping slots."""
    summary = launch_train.main([
        "--arch", ARCH, "--reduced", "--device", "cpu", "--steps", "2",
        "--batch", "4", "--seq", "16", "--optimizer", "lars",
        "--precision", "bf16", "--opt-state-dtype", "int8",
        "--accum-steps", "2", "--log-every", "0"]
        + [a for k, v in DROP.items() for a in ("--set", f"{k}={v}")])
    assert all(np.isfinite(summary["losses"]))
    assert all(a > 0 for a in summary["aux_losses"])


def test_launch_serve_runs_granite_reduced_on_the_cpu():
    rep = launch_serve.main(["--arch", ARCH, "--reduced", "--device", "cpu",
                             "--requests", "4", "--slots", "2"])
    assert rep["requests"] == 4 and rep["logits_finite"]
    assert rep["flash_decode_launches"] == 0
