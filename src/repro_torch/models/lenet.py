"""The paper's CNN (§3.1, Fig. 1): LeNet-style —
conv 6@5x5 (zero pad) -> maxpool 2x2 -> conv 16@5x5 (zero pad) ->
maxpool 2x2 -> FC 120 -> FC 84 -> FC 10, ReLU everywhere, softmax head.

Port of ``repro/models/lenet.py``. The public functions keep the JAX
package's layouts — NHWC images, HWIO conv weights, ``(in, out)`` dense
weights — so params carry across leaf for leaf. Inside, the convs run
in PyTorch's NCHW/OIHW, and the activations are permuted back to NHWC
before the flatten: ``fc1``'s rows are in ``(h, w, c)`` order.
"""

from __future__ import annotations

from typing import Any

import torch
import torch.nn.functional as F

Pytree = Any


def conv2d(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor
           ) -> torch.Tensor:
    """'SAME' stride-1 conv. x (B,C,H,W) NCHW, w (kh,kw,Cin,Cout) HWIO."""
    kh, kw = w.shape[0], w.shape[1]
    return F.conv2d(x, w.permute(3, 2, 0, 1), b,
                    padding=(kh // 2, kw // 2))


def maxpool2x2(x: torch.Tensor) -> torch.Tensor:
    """VALID 2x2 window, stride 2 (28 -> 14 -> 7)."""
    return F.max_pool2d(x, kernel_size=2, stride=2)


class LeNet:
    def __init__(self, cfg=None, *, image_size: int = 28, channels: int = 1,
                 num_classes: int = 10):
        self.cfg = cfg
        self.image_size = image_size
        self.channels = channels
        self.num_classes = num_classes
        side = image_size // 4      # after two 2x2 pools
        self.flat_dim = side * side * 16

    def init(self, generator: torch.Generator,
             device: torch.device | str) -> Pytree:
        """He-normal weights, zero biases. Drawn on the CPU from
        ``generator`` (a CPU generator) in a fixed order and then moved,
        so one seed gives the same init on every device."""

        def he(shape, fan_in):
            w = torch.randn(shape, generator=generator, dtype=torch.float32)
            return (w * (2.0 / fan_in) ** 0.5).to(device)

        def zeros(n):
            return torch.zeros((n,), dtype=torch.float32, device=device)

        c = self.channels
        return {
            "conv1": {"w": he((5, 5, c, 6), 25 * c), "b": zeros(6)},
            "conv2": {"w": he((5, 5, 6, 16), 25 * 6), "b": zeros(16)},
            "fc1": {"w": he((self.flat_dim, 120), self.flat_dim),
                    "b": zeros(120)},
            "fc2": {"w": he((120, 84), 120), "b": zeros(84)},
            "fc3": {"w": he((84, self.num_classes), 84),
                    "b": zeros(self.num_classes)},
        }

    def stacked_marker(self, params: Pytree) -> Pytree:
        return {k: {kk: False for kk in v} for k, v in params.items()}

    def forward(self, params, images: torch.Tensor
                ) -> tuple[torch.Tensor, dict]:
        """images (B, H, W, C) -> (logits (B, 10), aux)."""
        x = images.permute(0, 3, 1, 2)
        x = maxpool2x2(F.relu(conv2d(x, params["conv1"]["w"],
                                     params["conv1"]["b"])))
        x = maxpool2x2(F.relu(conv2d(x, params["conv2"]["w"],
                                     params["conv2"]["b"])))
        x = x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)   # (h, w, c)
        x = F.relu(x @ params["fc1"]["w"] + params["fc1"]["b"])
        x = F.relu(x @ params["fc2"]["w"] + params["fc2"]["b"])
        logits = x @ params["fc3"]["w"] + params["fc3"]["b"]
        return logits, {"aux_loss": torch.zeros((), dtype=torch.float32,
                                                device=logits.device)}
