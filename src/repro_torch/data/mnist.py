"""Procedural MNIST-like dataset: the port's copy of ``repro/data/mnist.py``
(pure numpy, byte-equal output for every seed).

We render the ten digit glyphs from a 7x5 seed font, upsample to 20x20,
and apply per-example augmentations (sub-pixel shift, scale jitter, shear,
stroke-intensity jitter, additive Gaussian noise) so that the dataset has
a real train/test generalization gap. The *protocol* of the paper
(batch-size sweep x {SGD, LARS} x {test acc, train acc, generalization
error}) runs unchanged on top; absolute accuracies differ from real MNIST
and are reported as such in EXPERIMENTS.md.

Everything is deterministic given the seed, and pure numpy (host-side
data pipeline; the device never sees the generator).
"""

from __future__ import annotations

import numpy as np

# 7x5 seed-font bitmaps for digits 0-9 (classic LCD-ish font).
_GLYPHS_ROWS = {
    0: ["01110", "10001", "10011", "10101", "11001", "10001", "01110"],
    1: ["00100", "01100", "00100", "00100", "00100", "00100", "01110"],
    2: ["01110", "10001", "00001", "00010", "00100", "01000", "11111"],
    3: ["11111", "00010", "00100", "00010", "00001", "10001", "01110"],
    4: ["00010", "00110", "01010", "10010", "11111", "00010", "00010"],
    5: ["11111", "10000", "11110", "00001", "00001", "10001", "01110"],
    6: ["00110", "01000", "10000", "11110", "10001", "10001", "01110"],
    7: ["11111", "00001", "00010", "00100", "01000", "01000", "01000"],
    8: ["01110", "10001", "10001", "01110", "10001", "10001", "01110"],
    9: ["01110", "10001", "10001", "01111", "00001", "00010", "01100"],
}


def _glyph(d: int) -> np.ndarray:
    return np.array([[int(c) for c in row] for row in _GLYPHS_ROWS[d]],
                    dtype=np.float32)


def _bilinear_resize(img: np.ndarray, out_h: int, out_w: int) -> np.ndarray:
    h, w = img.shape
    ys = np.linspace(0, h - 1, out_h)
    xs = np.linspace(0, w - 1, out_w)
    y0 = np.floor(ys).astype(int)
    x0 = np.floor(xs).astype(int)
    y1 = np.minimum(y0 + 1, h - 1)
    x1 = np.minimum(x0 + 1, w - 1)
    wy = (ys - y0)[:, None]
    wx = (xs - x0)[None, :]
    a = img[np.ix_(y0, x0)]
    b = img[np.ix_(y0, x1)]
    c = img[np.ix_(y1, x0)]
    d = img[np.ix_(y1, x1)]
    return (a * (1 - wy) * (1 - wx) + b * (1 - wy) * wx
            + c * wy * (1 - wx) + d * wy * wx)


def _render(digit: int, rng: np.random.Generator, side: int = 28
            ) -> np.ndarray:
    """One augmented 28x28 example of ``digit`` in [0, 1]."""
    g = _glyph(digit)
    # scale jitter: glyph body occupies 16..22 px
    body = int(rng.integers(16, 23))
    img = _bilinear_resize(g, body, int(body * 5 / 7) + 1)
    # shear jitter: shift each row horizontally by a linear ramp
    shear = rng.uniform(-0.15, 0.15)
    h, w = img.shape
    sheared = np.zeros((h, w + h), np.float32)
    for r in range(h):
        off = int(round(shear * r)) + h // 2
        sheared[r, off:off + w] = img[r]
    col_mass = sheared.sum(0) > 1e-6
    if col_mass.any():
        lo, hi = np.argmax(col_mass), len(col_mass) - np.argmax(col_mass[::-1])
        sheared = sheared[:, lo:hi]
    img = sheared
    h, w = img.shape
    canvas = np.zeros((side, side), np.float32)
    dy = int(rng.integers(0, side - h + 1))
    dx = int(rng.integers(0, side - w + 1))
    canvas[dy:dy + h, dx:dx + w] = img
    canvas *= rng.uniform(0.7, 1.0)                    # stroke intensity
    canvas += rng.normal(0.0, 0.18, canvas.shape)      # sensor noise
    return np.clip(canvas, 0.0, 1.0).astype(np.float32)


def synthetic_mnist(n_train: int = 8192, n_test: int = 2048, *,
                    seed: int = 0, side: int = 28
                    ) -> tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Returns (x_train (N,28,28,1), y_train, x_test, y_test)."""
    rng = np.random.default_rng(seed)

    def make(n, rng):
        ys = rng.integers(0, 10, size=n)
        xs = np.stack([_render(int(d), rng, side) for d in ys])
        return xs[..., None], ys.astype(np.int32)

    x_tr, y_tr = make(n_train, np.random.default_rng(seed))
    x_te, y_te = make(n_test, np.random.default_rng(seed + 1))
    return x_tr, y_tr, x_te, y_te
