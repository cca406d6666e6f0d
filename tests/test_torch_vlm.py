"""The port's vlm family (paligemma-3b: the dense stack fed stub image
patch embeddings as a bidirectional prefix) on the CPU against the JAX
package, through the checks of tests/test_torch_encdec.py: reduced
paligemma in f32 (2 layers, 4 query heads on 1 kv head of 64, 16 image
tokens), the reference's params carried across by ``bridge``, and the
same checks at the full width's head shape (8 query heads on 1 kv head
of 256, ``D256``) where decode is concerned.

Tolerances, each measured here (max abs differences; at D 256 in
brackets): logits within 1.9e-6 [2.0e-6] of values up to 1.35 (stock)
and 1.6e-6 [1.8e-6] (``flash_vjp`` with query chunks), the loss within
7.7e-8 relative, gradients within 1.8e-6 [2.3e-6] of each leaf's largest
entry, with or without the chunked loss (held at rtol/atol 1e-5, 1e-6
relative and 1e-5 of the largest entry); the chunked loss against the
whole logits' 7.6e-8 relative, its gradients 9.0e-8 of the largest entry
(held at 1e-6 and 1e-5); the prefill's logits 1.2e-6 [1.8e-6] and caches
4.1e-6 [6.1e-6], decode after prefill against the forward 1.0e-6
[1.4e-6], 8 decode steps 2.0e-6 [2.0e-6] (held at rtol/atol 1e-5); 4
LARS steps' losses within 1.5e-7 relative (held at 1e-6);
``DecodeEngine``'s greedy tokens equal.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.train.losses import lm_loss as ref_lm_loss
from repro.train.step import make_eval_step as ref_make_eval_step
from repro_torch.configs import get_config
from repro_torch.launch import serve as launch_serve
from repro_torch.launch import train as launch_train
from repro_torch.models import build_model
from repro_torch.serve import ServeEngine
from repro_torch.train import make_eval_step
from repro_torch.train.losses import lm_loss
from repro_torch.train.step import value_and_grad
from repro_torch.treepath import tree_leaves
from test_torch_encdec import (LAUNCH_RUNS, LOSS_RTOL, SEQ, batch,
                               check_config_and_count,
                               check_decode_after_prefill,
                               check_decode_engine,
                               check_forward_loss_and_gradients,
                               check_init_layout,
                               check_lars_steps_and_layout,
                               check_prefill_caches, pair, to_jax, to_torch)
from _torch_threads import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

ARCH = "paligemma-3b"
# the full width's attention: MQA, G 8 at head dim 256
D256 = dict(num_heads=8, num_kv_heads=1, head_dim=256)
HEADS = {"reduced": {}, "d256": D256}
N_IMG = 16


def test_paligemma_config_is_the_references_and_counts_its_params():
    d = 2048
    cfg, params = check_config_and_count(ARCH, 2_508_587_008,
                                         (18 * 2 + 1) * d)
    attn = params["layers"]["attn"]
    assert tuple(attn["wq"].shape) == (18, d, 8 * 256)
    assert tuple(attn["wk"].shape) == (18, d, 256)
    assert tuple(params["layers"]["mlp"]["wg"].shape) == (18, d, 16384)
    assert tuple(params["embed"].shape) == (257216, d)
    assert "unembed" not in params          # tied


def test_init_layout_and_distributions():
    cfg, p = check_init_layout(ARCH)
    assert set(p["layers"]) == {"ln1", "ln2", "attn", "mlp"}
    assert set(p["layers"]["mlp"]) == {"wi", "wg", "wo"}     # gated GELU


@pytest.mark.parametrize("lean", [False, True])
def test_forward_loss_and_gradients_match_the_reference(lean):
    """Stock; and through ``flash_vjp`` with query chunks (4 divides the
    16 + 12 positions) and the chunked loss, which slices the prefix off
    the hidden states."""
    extra = {"loss_chunk": 4} if lean else {}
    logits = check_forward_loss_and_gradients(ARCH, lean, **extra)
    if not lean:            # the text positions only
        assert tuple(logits.shape) == (3, SEQ, 512)


def test_the_image_prefix_is_bidirectional_and_the_text_causal():
    """A change to the last image embedding moves the first image
    position's hidden state; a change to the last token moves no
    earlier position, the image prefix included."""
    cfg, model, params, _, _ = pair(ARCH)
    b = to_torch(batch(cfg, B=1))
    img = b["image_embeddings"]

    def hidden(tokens, img):
        with torch.no_grad():
            return model.forward(params, tokens, image_embeddings=img,
                                 return_hidden=True)[0]
    h = hidden(b["tokens"], img)
    assert tuple(h.shape) == (1, N_IMG + SEQ, cfg.d_model)
    img2 = img.clone()
    img2[:, -1] = torch.randn(cfg.d_model,
                              generator=torch.Generator().manual_seed(1))
    assert (hidden(b["tokens"], img2) - h).abs()[0, 0].max() > 1e-4
    toks = b["tokens"].clone()
    toks[:, -1] = (toks[:, -1] + 1) % cfg.vocab_size
    again = hidden(toks, img)
    assert torch.equal(again[:, :-1], h[:, :-1])


def test_prefix_loss_mask_matches_the_reference():
    """``lm_loss``'s ``prefix_len`` masks the first positions' targets,
    as the reference's; the vlm step instead slices the prefix off, and
    the two agree where the prefix is the image."""
    rng = np.random.default_rng(3)
    logits = rng.standard_normal((2, 10, 32)).astype(np.float32)
    toks = rng.integers(0, 32, (2, 10)).astype(np.int32)
    for n in (0, 1, 4):
        got = lm_loss(torch.from_numpy(logits), torch.from_numpy(toks),
                      prefix_len=n)
        want = ref_lm_loss(jnp.asarray(logits), jnp.asarray(toks),
                           prefix_len=n)
        np.testing.assert_allclose(float(got), float(want), rtol=1e-6)
    # a prefix of 4 image positions: tokens at 4.., logits over all 10
    sliced = lm_loss(torch.from_numpy(logits[:, 4:]),
                     torch.from_numpy(toks[:, 4:]))
    masked = lm_loss(torch.from_numpy(logits), torch.from_numpy(toks),
                     prefix_len=4)
    np.testing.assert_allclose(float(sliced), float(masked), rtol=1e-6)


def test_a_zero_image_stub_overflows_the_gradient_at_depth():
    """A quirk of the reference, recorded: with the all-zero image stub
    that its launch.train feeds, the prefix stays zero through every
    layer, rmsnorm's gradient at zero is 1 / sqrt(eps), and the
    prefix's attention compounds it layer over layer: at 18 layers (the
    full depth) the gradient overflows, in the reference and in the
    port alike, while unit-normal image embeddings give finite
    gradients. The loss itself stays finite."""
    import jax
    from repro.models import build_model as ref_build_model
    from repro.train.step import _forward_and_loss as ref_forward_and_loss
    from test_torch_encdec import cfgs
    rcfg, cfg = cfgs(ARCH, num_layers=18)
    b = batch(cfg, B=2)
    zero = dict(b, image_embeddings=np.zeros_like(b["image_embeddings"]))
    rmodel = ref_build_model(rcfg)
    rparams = rmodel.init(jax.random.key(0))
    model = build_model(cfg)
    params = model.init(torch.Generator().manual_seed(0), "cpu")
    for stub, finite in ((zero, False), (b, True)):
        (rloss, _), rgrads = jax.value_and_grad(
            lambda p: ref_forward_and_loss(rmodel, rcfg, p, to_jax(stub)),
            has_aux=True)(rparams)
        loss, grads, _ = value_and_grad(model, cfg, params, to_torch(stub))
        assert np.isfinite(float(rloss)) and torch.isfinite(loss)
        assert all(bool(np.isfinite(np.asarray(g)).all()) for g in
                   jax.tree_util.tree_leaves(rgrads)) == finite
        assert all(bool(torch.isfinite(g).all())
                   for g in tree_leaves(grads)) == finite


def test_chunked_loss_equals_the_whole_logits():
    """``loss_chunk`` (the prefix sliced off the hidden states) against
    the whole logits' loss, and the gradients of both."""
    cfg, model, params, _, _ = pair(ARCH)
    b = to_torch(batch(cfg, seed=5))
    ccfg = dataclasses.replace(cfg, loss_chunk=4)
    loss, grads, _ = value_and_grad(model, cfg, params, b)
    closs, cgrads, (clogits, _) = value_and_grad(build_model(ccfg), ccfg,
                                                 params, b)
    assert clogits is None
    assert abs(float(closs) - float(loss)) <= LOSS_RTOL * abs(float(loss))
    for a, g in zip(tree_leaves(cgrads), tree_leaves(grads)):
        assert (a - g).abs().max() <= 1e-5 * g.abs().max()


def test_eval_step_matches_the_reference():
    cfg, model, params, rmodel, rparams = pair(ARCH)
    b = batch(cfg, seed=4)
    got = make_eval_step(model, cfg)(params, to_torch(b))
    want = ref_make_eval_step(rmodel, rmodel.cfg)(rparams, to_jax(b))
    assert abs(float(got["loss"]) - float(want["loss"])) <= \
        LOSS_RTOL * abs(float(want["loss"]))
    assert float(got["accuracy"]) == float(want["accuracy"])


# ------------------------------------------------------------------ serve

@pytest.mark.parametrize("heads", sorted(HEADS))
def test_prefill_caches_match_the_reference(heads):
    """The cache's ``pos`` counts the image tokens."""
    cfg, cache = check_prefill_caches(ARCH, **HEADS[heads])
    assert cache["pos"].tolist() == [N_IMG + SEQ] * 3
    assert tuple(cache["k"].shape) == (2, 3, 20 + N_IMG, 1,
                                       cfg.head_dim)


@pytest.mark.parametrize("heads", sorted(HEADS))
def test_decode_after_prefill_equals_the_forward(heads):
    model, cache = check_decode_after_prefill(ARCH, **HEADS[heads])
    assert cache["pos"].tolist() == [N_IMG + SEQ + 8] * 3
    assert model.flash_decode_per_step() == 2


@pytest.mark.parametrize("heads", sorted(HEADS))
def test_decode_engine_greedy_tokens_match_the_reference(heads):
    check_decode_engine(ARCH, **HEADS[heads])


def test_what_the_vlm_family_refuses():
    """As the reference: no image embeddings (a forward or prefill needs
    them), ``lengths`` in prefill, slot admission and ``ServeEngine``
    (the reference's engine covers the other LM families)."""
    cfg, model, params, _, _ = pair(ARCH)
    toks = torch.zeros(1, 4, dtype=torch.int32)
    with pytest.raises(ValueError, match="image embeddings"):
        model.forward(params, toks)
    img = torch.zeros(1, N_IMG, cfg.d_model)
    with pytest.raises(ValueError, match="no lengths"):
        model.prefill(params, toks, image_embeddings=img,
                      lengths=torch.tensor([4], dtype=torch.int32))
    with pytest.raises(ValueError, match="does not serve vlm"):
        model.prefill_at(params, model.init_cache(2, 32), toks,
                         torch.tensor([0]))
    with pytest.raises(ValueError, match=r"covers .*got 'vlm'"):
        ServeEngine(model, params, cfg, slots=1, capacity=8)
    with pytest.raises(ValueError, match="got 'vlm'"):
        launch_serve.main(["--arch", ARCH, "--reduced", "--device", "cpu"])


# ----------------------------------------------------------------- train

def test_lars_steps_and_packed_layout_match_the_reference():
    layout = check_lars_steps_and_layout(ARCH)
    assert "layers/mlp/wg" in [s.name for s in layout.segments]


@pytest.mark.parametrize("optimizer,extra", LAUNCH_RUNS)
def test_launch_train_runs_paligemma_reduced_on_the_cpu(optimizer, extra):
    summary = launch_train.main([
        "--arch", ARCH, "--reduced", "--device", "cpu", "--steps", "2",
        "--batch", "4", "--seq", "16", "--optimizer", optimizer,
        "--log-every", "0", "--set", "loss_chunk=8"] + extra)
    assert summary["arch"] == ARCH + "-reduced"
    assert len(summary["losses"]) == 2
    assert all(np.isfinite(summary["losses"]))


def test_lm_batches_carry_the_references_stub_image():
    cfg = get_config(ARCH).reduced()
    b = next(launch_train.lm_batches(cfg, 2, 8))
    assert set(b) == {"tokens", "image_embeddings"}
    assert b["image_embeddings"].shape == (2, N_IMG, cfg.d_model)
    assert not b["image_embeddings"].any()
