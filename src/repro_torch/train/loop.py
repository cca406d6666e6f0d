"""Host-side training loop (port of ``repro/train/loop.py``): stream
batches through the step, collect metrics, evaluate at the end.

Losses stay on the device until a log step or the end of the loop, so
the host does not wait on the device every step.
"""

from __future__ import annotations

import time
from typing import Any, Callable, Iterator, Optional

import numpy as np
import torch


def train_loop(step_fn: Callable, state, batches: Iterator,
               num_steps: int, *, log_every: int = 0,
               eval_fn: Optional[Callable] = None,
               eval_batches: Optional[list] = None) -> tuple[Any, list[dict]]:
    """Run ``num_steps`` steps. Returns (final state, history).

    ``history`` holds one entry per logged step, then
    ``{"losses": [...], "aux_losses": [...], "train_s": t}`` (every
    step's loss and auxiliary loss, and the wall time of the steps up to
    the device finishing them), then the eval entry when ``eval_fn`` is
    given.
    """
    history: list[dict] = []
    losses, aux_losses = [], []
    t0 = time.perf_counter()
    for i in range(num_steps):
        batch = next(batches)
        state, metrics = step_fn(state, batch)
        losses.append(metrics["loss"])
        aux_losses.append(metrics["aux_loss"])
        if log_every and (i % log_every == 0 or i == num_steps - 1):
            m = {k: float(v) for k, v in metrics.items()}
            m["wall_s"] = time.perf_counter() - t0
            history.append(m)
            print(f"  step {i:5d}  loss {m['loss']:.4f}  "
                  f"({m['wall_s']:.1f}s)", flush=True)
    if losses and losses[0].is_cuda:       # wait for the last update too
        torch.cuda.synchronize(losses[0].device)
    history.append({"losses": torch.stack(losses).tolist() if losses else [],
                    "aux_losses": (torch.stack(aux_losses).tolist()
                                   if aux_losses else []),
                    "train_s": time.perf_counter() - t0})
    if eval_fn is not None and eval_batches:
        accs, ev_losses = [], []
        for eb in eval_batches:
            em = eval_fn(state.params, eb)
            accs.append(float(em["accuracy"]))
            ev_losses.append(float(em["loss"]))
        history.append({"eval_accuracy": float(np.mean(accs)),
                        "eval_loss": float(np.mean(ev_losses))})
    return state, history
