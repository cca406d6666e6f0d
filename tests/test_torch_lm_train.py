"""The port's dense-LM training path (``LanguageModel.forward``,
``lm_loss``, the dense branch of the train and eval steps, LAMB and
AdamW on the packed engine, and their states across ``bridge`` and npz)
on the CPU against the JAX package, on the same seeded numpy inputs and
the reference's initial params carried across. The model is the
``lm_smoke`` reduction of smollm the golden LM pins train: 2 layers,
d_model 144, 4 heads over 1 kv head, vocab 256.

Tolerances, each measured here:
  * forward and gradients: the logits agree to 1.1e-6 absolute (values
    of order one), the loss to 3.4e-7 relative, and every gradient leaf
    — the tied embedding's included — to 1.4e-6 of its largest entry:
    the same f32 function with sums in another order. Held at 1e-5
    (logits atol/rtol), 1e-6 (loss) and 1e-5 of each leaf's largest
    entry.
  * per-layer remat (``cfg.remat``) recomputes the same ops: gradients
    bit-identical with it on and off.
  * bias corrections ``1 - b**t``: numpy's f32 ``power`` and XLA's
    differ in 291 of 20,000 steps, by at most 2^-24 (one ulp of values
    in [0.5, 1)); held at 2^-24 over the first 4,000 steps.
  * LAMB and AdamW, 3 packed-engine steps against the reference's
    (``use_pallas=False``, op by op): moments bit-identical (f32), int8
    codes and scales equal; weights within 3.0e-8 absolute (2.4e-7 where
    AdamW's int8 weights grow past 100). Held at rtol 1e-6, atol 1e-7.
  * the golden pins ``{lamb,adamw}_lm_b32`` (tests/test_golden.py's
    workload from ``init(jax.random.key(7))`` drawn under legacy
    threefry, as the pins were): losses within 3.6e-7 (lamb) and 6.8e-6
    (adamw) relative, trust ratios 4.4e-7 and 5.4e-5 — at the pins' own
    1e-4 / 1e-3. An LR of 0.011 moves the losses 8.6e-3 (lamb) and
    2.5e-2 (adamw): the pins keep their teeth.
  * LAMB states carry across byte for byte (bridge and npz, both ways).
    A reference checkpoint continued in the port for 2 more steps: with
    f32 slots, losses within 8.6e-8 relative and weights 1.4e-7
    absolute, held at rtol 1e-5 / atol 1e-6 as
    tests/test_torch_checkpoint.py holds LARS. With int8 slots the
    gradients' ~1e-7 difference rounds 235 of 704,512 mu codes and 52 nu
    codes the other way, by one step each; a nu code of 0 against 1
    divides by eps against sqrt(scale), which changes its slice's ||u||
    and so the whole slice's trust-scaled step (1.9e-3 in the
    embedding). Held: losses rtol 1e-5, every code within one step, at
    most 0.1 % of the codes different.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core as ref_core
from repro.checkpoint import restore_train_state as ref_restore
from repro.checkpoint import save_train_state as ref_save
from repro.configs import get_config as ref_get_config
from repro.core.optim_base import adam_moments as ref_adam_moments
from repro.models import build_model as ref_build_model
from repro.train import TrainPipeline as RefPipeline
from repro.train.step import _forward_and_loss as ref_forward_and_loss
from repro.train.step import make_eval_step as ref_make_eval_step
import repro_torch.core as port_core
from repro_torch import bridge
from repro_torch.checkpoint import restore_train_state, save_train_state
from repro_torch.configs import get_config
from repro_torch.core import grad_stats
from repro_torch.core.optim_base import adam_moments
from repro_torch.data import TokenTaskConfig, token_batches
from repro_torch.models import build_model
from repro_torch.train import (TrainPipeline, lm_loss, make_eval_step,
                               train_state_from_params)
from repro_torch.train.step import value_and_grad
from repro_torch.treepath import (path_str, tree_flatten_with_path,
                                  tree_leaves)
from _torch_threads import one_torch_thread  # noqa: F401
from test_golden import (LM_SEQ, LM_VOCAB, RTOLS, TRUST_COEF, TRUST_RTOLS,
                         WEIGHT_DECAY, _compare, _load_golden)

pytestmark = pytest.mark.usefixtures("one_torch_thread")

LOGITS_TOL = dict(rtol=1e-5, atol=1e-5)
LOSS_RTOL = 1e-6
GRAD_RTOL_OF_MAX = 1e-5
ENGINE_TOL = dict(rtol=1e-6, atol=1e-7)
CKPT_RTOL, CKPT_ATOL = 1e-5, 1e-6
SMOKE = dict(max_layers=2, max_d_model=128, max_vocab=LM_VOCAB)
REF_CFG = ref_get_config("smollm-135m").reduced(**SMOKE)
CFG = get_config("smollm-135m").reduced(**SMOKE)
REF_MODEL = ref_build_model(REF_CFG)
MODEL = build_model(CFG)


def _init(seed=3, legacy_threefry=False):
    with jax.threefry_partitionable(not legacy_threefry):
        return jax.tree_util.tree_map(np.asarray,
                                      REF_MODEL.init(jax.random.key(seed)))


def _tokens(shape=(4, 33), seed=0):
    return np.random.default_rng(seed).integers(
        0, CFG.vocab_size, shape).astype(np.int32)


def test_config_is_the_references():
    assert dataclasses.asdict(CFG) == dataclasses.asdict(REF_CFG)
    assert (CFG.num_layers, CFG.d_model, CFG.attn_dims) == (2, 144,
                                                            (4, 1, 36))


def test_forward_loss_and_gradients_match_the_reference():
    init, toks = _init(), _tokens()

    def ref_loss(params):
        loss, (logits, _) = ref_forward_and_loss(
            REF_MODEL, REF_CFG, params, {"tokens": jnp.asarray(toks)})
        return loss, logits

    (ref_l, ref_logits), ref_g = jax.jit(jax.value_and_grad(
        ref_loss, has_aux=True))(jax.tree_util.tree_map(jnp.asarray, init))
    params = bridge.lm_params_to_torch(init, MODEL)
    loss, grads, (logits, aux) = value_and_grad(
        MODEL, CFG, params, {"tokens": torch.from_numpy(toks)})
    np.testing.assert_allclose(logits.detach().numpy(),
                               np.asarray(ref_logits), **LOGITS_TOL)
    assert float(aux["aux_loss"]) == 0.0
    assert abs(float(loss) - float(ref_l)) <= LOSS_RTOL * abs(float(ref_l))
    assert float(lm_loss(logits.detach(), torch.from_numpy(toks))) == \
        float(loss)
    ref_leaves = {path_str(tuple(k.key for k in p)): np.asarray(v)
                  for p, v in jax.tree_util.tree_leaves_with_path(ref_g)}
    leaves = tree_flatten_with_path(grads)[0]
    assert {path_str(p) for p, _ in leaves} == set(ref_leaves)
    for path, g in leaves:
        want = ref_leaves[path_str(path)]
        err = np.abs(g.numpy() - want).max()
        assert err <= GRAD_RTOL_OF_MAX * np.abs(want).max(), (path, err)


def test_forward_returns_hidden_and_refuses_unported_configs():
    params = bridge.lm_params_to_torch(_init(), MODEL)
    toks = torch.from_numpy(_tokens())
    hidden, _ = MODEL.forward(params, toks, return_hidden=True)
    assert hidden.shape == (4, 33, CFG.d_model)
    logits = (hidden @ MODEL.unembed_matrix(params)).float()
    torch.testing.assert_close(logits, MODEL.forward(params, toks)[0],
                               rtol=0, atol=0)
    # the memory-lean knobs (remat_block, attn_q_chunk, flash_vjp,
    # loss_chunk) are ported: tests/test_torch_lm_lean.py holds them
    # against the reference; sliding windows, the softcap and MLA train
    # (tests/test_torch_attention_masks.py, tests/test_torch_mla.py), and
    # so do the ssm and hybrid families (tests/test_torch_ssm.py,
    # tests/test_torch_hybrid.py), and so do the encdec and vlm families
    # (tests/test_torch_encdec.py, tests/test_torch_vlm.py). What their
    # step refuses, as the reference's: a batch without their stub input.
    for family, stub in (("encdec", "frames"), ("vlm", "image_embeddings")):
        model = build_model(dataclasses.replace(CFG, family=family))
        with pytest.raises(KeyError, match=stub):
            value_and_grad(model, model.cfg, params, {"tokens": toks})


def test_remat_gives_identical_gradients():
    params = bridge.lm_params_to_torch(_init(), MODEL)
    batch = {"tokens": torch.from_numpy(_tokens())}
    out = {}
    for remat in (True, False):
        cfg = dataclasses.replace(CFG, remat=remat)
        loss, grads, _ = value_and_grad(build_model(cfg), cfg, params, batch)
        out[remat] = [loss] + tree_leaves(grads)
    assert all(torch.equal(a, b) for a, b in zip(out[True], out[False]))


def test_eval_step_scores_the_next_token_as_the_reference():
    init, toks = _init(), _tokens((6, 17), seed=1)
    want = ref_make_eval_step(REF_MODEL, REF_CFG)(
        jax.tree_util.tree_map(jnp.asarray, init),
        {"tokens": jnp.asarray(toks)})
    got = make_eval_step(MODEL, CFG)(bridge.lm_params_to_torch(init, MODEL),
                                     {"tokens": torch.from_numpy(toks)})
    assert abs(float(got["loss"]) - float(want["loss"])) <= \
        LOSS_RTOL * abs(float(want["loss"]))
    assert float(got["accuracy"]) == float(want["accuracy"])


def test_bias_corrections_match_jnp_power():
    steps = np.arange(4000)
    ref_prepare, _ = ref_adam_moments(0.9, 0.999, 1e-6, 0.0)
    prepare, _ = adam_moments(0.9, 0.999, 1e-6, 0.0)
    want = jax.vmap(ref_prepare)(jnp.asarray(steps, jnp.int32))
    for key in ("c1", "c2"):
        got = np.array([prepare(int(s))[key] for s in steps], np.float32)
        assert got.dtype == np.asarray(want[key]).dtype == np.float32
        assert np.abs(got - np.asarray(want[key])).max() <= 2.0 ** -24, key


def _grads(params, step):
    rng = np.random.default_rng(100 + step)
    return jax.tree_util.tree_map(
        lambda p: (rng.standard_normal(p.shape) * 0.01).astype(np.float32),
        params)


@pytest.mark.parametrize("slot_dtype", ["f32", "int8"])
@pytest.mark.parametrize("name", ["lamb", "adamw"])
def test_update_matches_the_reference_packed_engine(name, slot_dtype):
    kw = dict(weight_decay=1e-4, slot_dtype=slot_dtype)
    ref_opt = getattr(ref_core, name)(0.01, **kw)
    opt = port_core.get_optimizer(name, learning_rate=0.01, **kw)
    init = _init()
    marker = REF_MODEL.stacked_marker(init)
    ref_params, ref_state = init, ref_opt.init(init, stacked=marker)
    params = bridge.params_to_torch(init)
    state = opt.init(params, stacked=MODEL.stacked_marker(params))
    for step in range(3):
        g = _grads(init, step)
        ref_params, ref_state = ref_opt.update(g, ref_state, ref_params,
                                               stacked=marker)
        params, state = opt.update(bridge.params_to_torch(g), state, params)
    assert state.step == int(ref_state.step) == 3
    _, slots = bridge.opt_state_to_numpy(state)
    assert set(slots) == set(ref_state.slots)
    for k, v in slots.items():
        want = np.asarray(ref_state.slots[k])
        assert v.dtype == want.dtype, k
        if k == "packed_weights":
            np.testing.assert_allclose(v, want, **ENGINE_TOL)
        else:
            assert np.array_equal(v, want), k
    for a, b in zip(tree_leaves(params), jax.tree_util.tree_leaves(
            ref_params)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **ENGINE_TOL)


def test_lamb_and_adamw_run_no_hand_kernel():
    """Neither rule has a kernel wrapper (the reference's have no Pallas
    kernel either): LAMB's norms and apply take the plain branch."""
    from repro_torch.kernels import lars_kernels as lk
    params = bridge.params_to_torch(_init())
    lk.reset_launch_counts()
    for name in ("lamb", "adamw"):
        opt = port_core.get_optimizer(name, learning_rate=0.01)
        state = opt.init(params, stacked=MODEL.stacked_marker(params))
        opt.update(bridge.params_to_torch(_grads(_init(), 0)), state, params)
    assert not any(lk.LAUNCHES.values())


def _golden_run(name, lr=0.01):
    """tests/test_golden.py's LM workload through the port's pipeline."""
    opt = port_core.get_optimizer(name, learning_rate=lr,
                                  weight_decay=WEIGHT_DECAY)
    pipe = TrainPipeline(MODEL, opt, CFG, stats_fn=grad_stats.stats_hook(
        eta=TRUST_COEF, weight_decay=WEIGHT_DECAY))
    state = train_state_from_params(MODEL, opt, bridge.lm_params_to_torch(
        _init(7, legacy_threefry=True), MODEL))
    it = token_batches(TokenTaskConfig(vocab_size=LM_VOCAB, seed=0),
                       batch=32, seq_len=LM_SEQ, seed=0)
    losses = []
    for _ in range(20):
        state, metrics = pipe(state, {"tokens": torch.from_numpy(next(it))})
        losses.append(float(metrics["loss"]))
    marker = MODEL.stacked_marker(state.params)
    ranks = {path_str(p): leaf.ndim - (1 if s else 0) for (p, leaf), s in zip(
        tree_flatten_with_path(state.params)[0], tree_leaves(marker))}
    trust = {layer: np.atleast_1d(t["trust_ratio"].double().numpy()).tolist()
             for layer, t in metrics["stats"].items() if ranks[layer] > 1}
    return {"losses": losses, "final_trust": trust}


@pytest.mark.parametrize("name", ["lamb", "adamw"])
def test_port_reproduces_the_lm_golden_pin(name):
    _compare(_golden_run(name), _load_golden("lm", name, 32),
             rtol=RTOLS[("lm", 32)], trust_rtol=TRUST_RTOLS[("lm", 32)],
             label=f"port lm/{name}/b32")


@pytest.mark.parametrize("name", ["lamb", "adamw"])
def test_lr_perturbation_breaks_the_port_lm_pin(name):
    golden = _load_golden("lm", name, 32)
    got = _golden_run(name, lr=0.01 + 1e-3)
    rel = np.abs(np.subtract(got["losses"], golden["losses"])) \
        / np.abs(golden["losses"])
    assert rel.max() > 10 * RTOLS[("lm", 32)], rel.max()
    with pytest.raises(AssertionError):
        _compare(got, golden, rtol=RTOLS[("lm", 32)],
                 trust_rtol=TRUST_RTOLS[("lm", 32)], label="perturbed")


# ------------------------------------------------- state across packages

def _lamb(slot_dtype, ref=False):
    lib = ref_core if ref else port_core
    return lib.lamb(0.01, weight_decay=1e-4, slot_dtype=slot_dtype)


def _token_batches(n):
    it = token_batches(TokenTaskConfig(vocab_size=LM_VOCAB, seed=0),
                       batch=8, seq_len=16, seed=0)
    return [next(it) for _ in range(n)]


def _steps(pipe, state, batches, torch_side=True):
    losses = []
    for b in batches:
        b = {"tokens": torch.from_numpy(b) if torch_side else jnp.asarray(b)}
        state, m = pipe(state, b)
        losses.append(float(m["loss"]))
    return state, losses


@pytest.mark.parametrize("slot_dtype", ["f32", "int8"])
def test_lamb_state_carries_across_bridge_and_npz(tmp_path, slot_dtype):
    batches = _token_batches(4)
    ref_pipe = RefPipeline(REF_MODEL, _lamb(slot_dtype, ref=True), REF_CFG,
                           donate=False)
    ref_state, _ = _steps(ref_pipe, ref_pipe.init_state(jax.random.key(7)),
                          batches[:2], torch_side=False)
    pipe = TrainPipeline(MODEL, _lamb(slot_dtype), CFG)
    fresh = train_state_from_params(MODEL, pipe.optimizer,
                                    bridge.lm_params_to_torch(_init(), MODEL))
    # the reference's in-memory state through bridge ...
    carried = bridge.opt_state_to_torch(
        int(ref_state.opt_state.step),
        jax.tree_util.tree_map(np.asarray, ref_state.opt_state.slots),
        fresh.opt_state.layout)
    # ... and its npz file through the port's restore
    path = str(tmp_path / "ref.npz")
    ref_save(path, ref_state)
    restored = restore_train_state(path, fresh)
    assert restored.opt_state.step == carried.step == 2
    want_slots = {"mu", "nu", "packed_weights"}
    if slot_dtype == "int8":
        want_slots |= {"mu_scale", "nu_scale"}
    assert set(restored.opt_state.slots) == want_slots
    for k, v in restored.opt_state.slots.items():
        assert v.numpy().tobytes() == carried.slots[k].numpy().tobytes(), k
    ref_state, ref_losses = _steps(ref_pipe, ref_state, batches[2:],
                                   torch_side=False)
    state, losses = _steps(pipe, restored, batches[2:])
    np.testing.assert_allclose(losses, ref_losses, rtol=CKPT_RTOL)
    slots = state.opt_state.slots
    if slot_dtype == "f32":
        np.testing.assert_allclose(
            slots["packed_weights"].numpy(),
            np.asarray(ref_state.opt_state.slots["packed_weights"]),
            rtol=0, atol=CKPT_ATOL)
    else:
        for k in ("mu", "nu"):
            diff = np.abs(slots[k].numpy().astype(np.int32)
                          - np.asarray(ref_state.opt_state.slots[k]))
            assert diff.max() <= 1 and (diff > 0).mean() <= 1e-3, k
    # and back: the port's file restores into the reference byte for byte
    save_train_state(str(tmp_path / "port.npz"), state)
    back = ref_restore(str(tmp_path / "port.npz"),
                       ref_pipe.init_state(jax.random.key(0)))
    assert int(back.opt_state.step) == 4
    for k, v in slots.items():
        assert np.asarray(back.opt_state.slots[k]).tobytes() == \
            v.numpy().tobytes(), k
