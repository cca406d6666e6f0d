"""The port's LeNet, loss and metrics against the JAX package's, from the
reference's init carried across. Tolerances: logits and loss rtol 1e-5,
atol 1e-5 — f32 convs and matmuls summed in another order (XLA:CPU vs
PyTorch's CPU kernels) differ by a few ulp of the accumulated values;
gradients atol 1e-5 relative to their scale, for the same reason through
one more layer of sums."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models.lenet import LeNet as RefLeNet
from repro.train.losses import classification_loss as ref_loss
from repro.train.metrics import accuracy as ref_accuracy
from repro_torch import bridge
from repro_torch.configs import get_config
from repro_torch.models import build_model
from repro_torch.models.lenet import LeNet
from repro_torch.train.losses import classification_loss
from repro_torch.train.metrics import accuracy
from repro_torch.train.step import value_and_grad

RTOL = 1e-5
ATOL = 1e-5


def _inputs(batch=8, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.random((batch, 28, 28, 1), np.float32)
    y = rng.integers(0, 10, batch).astype(np.int32)
    return x, y


def _ref_params(seed=7):
    return RefLeNet().init(jax.random.key(seed))


def test_logits_loss_and_accuracy_match_reference():
    x, y = _inputs()
    ref_p = _ref_params()
    ref_logits, _ = RefLeNet().forward(ref_p, jnp.asarray(x))
    params = bridge.params_to_torch(jax.tree_util.tree_map(np.asarray,
                                                           ref_p))
    logits, aux = LeNet().forward(params, torch.from_numpy(x))
    np.testing.assert_allclose(logits.numpy(), np.asarray(ref_logits),
                               rtol=RTOL, atol=ATOL)
    assert float(aux["aux_loss"]) == 0.0
    np.testing.assert_allclose(
        float(classification_loss(logits, torch.from_numpy(y))),
        float(ref_loss(ref_logits, jnp.asarray(y))), rtol=RTOL)
    assert float(accuracy(logits, torch.from_numpy(y))) == \
        float(ref_accuracy(ref_logits, jnp.asarray(y)))


def test_per_leaf_gradients_match_jax_grad():
    x, y = _inputs(batch=16, seed=1)
    ref_p = _ref_params(3)
    model = RefLeNet()

    def loss_fn(p):
        return ref_loss(model.forward(p, jnp.asarray(x))[0], jnp.asarray(y))

    ref_g = jax.grad(loss_fn)(ref_p)
    params = bridge.params_to_torch(jax.tree_util.tree_map(np.asarray,
                                                           ref_p))
    cfg = get_config("lenet-mnist")
    loss, grads, _ = value_and_grad(
        build_model(cfg), cfg, params,
        {"x": torch.from_numpy(x), "y": torch.from_numpy(y)})
    np.testing.assert_allclose(float(loss), float(loss_fn(ref_p)), rtol=RTOL)
    for layer in ref_g:
        for leaf in ref_g[layer]:
            want = np.asarray(ref_g[layer][leaf])
            got = grads[layer][leaf].numpy()
            assert got.shape == want.shape
            np.testing.assert_allclose(
                got, want, rtol=RTOL, atol=ATOL * np.abs(want).max(),
                err_msg=f"{layer}/{leaf}")


def test_init_shapes_scale_and_determinism():
    gen = lambda: torch.Generator().manual_seed(0)  # noqa: E731
    model = LeNet()
    p = model.init(gen(), "cpu")
    ref_shapes = jax.tree_util.tree_map(lambda a: tuple(a.shape),
                                        _ref_params())
    got_shapes = {k: {kk: tuple(v.shape) for kk, v in d.items()}
                  for k, d in p.items()}
    assert got_shapes == ref_shapes
    # He-normal: std sqrt(2 / fan_in) (fc1: 784 inputs, 94,080 draws)
    np.testing.assert_allclose(float(p["fc1"]["w"].std()),
                               (2.0 / 784) ** 0.5, rtol=0.02)
    assert float(p["fc1"]["b"].abs().sum()) == 0.0
    assert torch.equal(model.init(gen(), "cpu")["conv2"]["w"],
                       p["conv2"]["w"])
    assert model.stacked_marker(p) == {k: {kk: False for kk in d}
                                       for k, d in p.items()}


def test_only_the_cnn_family_is_ported():
    """Every family is ported now: ``build_model`` dispatches on the
    family as the reference's does (cnn, encdec, else the LM), and the LM
    refuses a family it does not know."""
    import dataclasses
    from repro_torch.models import EncDecModel, LanguageModel
    cfg = dataclasses.replace(get_config("lenet-mnist"), family="encdec")
    assert isinstance(build_model(cfg), EncDecModel)
    assert isinstance(build_model(dataclasses.replace(cfg, family="vlm")),
                      LanguageModel)
    with pytest.raises(ValueError, match="unknown model family 'rnn'"):
        build_model(dataclasses.replace(cfg, family="rnn"))
