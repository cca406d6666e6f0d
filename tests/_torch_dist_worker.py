"""Multi-process runs of the port over ``torch.distributed`` (gloo, CPU
ranks) for the data-parallel, ZeRO, tensor-parallel and serving-mesh
tests.

``spawn(scenario, world, tmp, **kwargs)`` starts ``world`` fresh Python
processes running this file, one rank each; they rendezvous through a
``file://`` store under ``tmp`` (no TCP port to collide across the
suite's parallel workers), run one torch thread each, call
``SCENARIOS[scenario](**kwargs)`` and pickle its result back. A rank
that fails raises in the parent with its output; every spawn has a join
timeout, so a deadlocked collective fails the test instead of hanging
the suite.

This module imports torch, numpy and ``repro_torch`` only: the ranks
never import JAX. The tests compute the reference's side in the parent
and hand the ranks plain numpy (e.g. the reference's LeNet init).
"""

from __future__ import annotations

import os
import pickle
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
JOIN_S = 120


def spawn(scenario: str, world: int, tmp, timeout: float = JOIN_S,
          **kwargs) -> list:
    """Run ``scenario`` on ``world`` ranks; each rank's result, by rank."""
    tmp = Path(tmp)
    tmp.mkdir(parents=True, exist_ok=True)
    with open(tmp / "args.pkl", "wb") as f:
        pickle.dump(kwargs, f)
    env = dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=os.pathsep.join(
        [str(ROOT / "src"), str(ROOT / "tests")]
        + [p for p in os.environ.get("PYTHONPATH", "").split(os.pathsep)
           if p]))
    procs = []
    for rank in range(world):
        log = open(tmp / f"rank{rank}.log", "w")
        procs.append((subprocess.Popen(
            [sys.executable, __file__, scenario, str(rank), str(world),
             str(tmp)], env=env, stdout=log, stderr=subprocess.STDOUT),
            log))
    deadline = time.monotonic() + timeout
    failed = []
    try:
        for rank, (p, _) in enumerate(procs):
            try:
                rc = p.wait(timeout=max(deadline - time.monotonic(), 1))
            except subprocess.TimeoutExpired:
                failed.append(f"rank {rank}: no exit in {timeout} s")
                break
            if rc:
                failed.append(f"rank {rank}: exit {rc}")
    finally:
        for p, log in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
            log.close()
    if failed:
        logs = "\n".join(f"--- rank {r}\n" + (tmp / f"rank{r}.log")
                         .read_text()[-4000:] for r in range(world))
        raise AssertionError(f"{scenario} on {world} ranks: "
                             f"{'; '.join(failed)}\n{logs}")
    out = []
    for rank in range(world):
        with open(tmp / f"out{rank}.pkl", "rb") as f:
            out.append(pickle.load(f))
    return out


# ------------------------------------------------------------- helpers

def _np(t):
    from repro_torch.bridge import tensor_to_numpy
    return tensor_to_numpy(t)


def _tree_np(tree):
    from repro_torch.treepath import tree_map
    return tree_map(_np, tree)


def _lenet(init=None):
    """LeNet's model and cfg, and its params: the given numpy tree, or
    the port's init from seed 0."""
    import torch
    from repro_torch import bridge
    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    cfg = get_config("lenet-mnist")
    model = build_model(cfg)
    params = bridge.params_to_torch(init) if init is not None else \
        model.init(torch.Generator().manual_seed(0), "cpu")
    return cfg, model, params


def _optimizer(name: str, lr: float, **kw):
    from repro_torch.core import lars, sgd
    common = dict(momentum=0.9, weight_decay=1e-4)
    if name == "sgd":
        return sgd(lr, **common)
    return lars(lr, trust_coefficient=0.01, **common,
                slot_dtype="int8" if name == "lars_int8" else "f32", **kw)


def _whole_slots(pipe, state) -> dict:
    """The state's slots gathered to whole padded buffers (collective)."""
    from repro_torch.bridge import opt_state_to_numpy
    with pipe.mesh_context():
        return opt_state_to_numpy(state.opt_state)[1]


def _mnist_batches(n_train: int, batch: int, seed: int = 0):
    from repro_torch.data import batch_iterator, synthetic_mnist
    x, y, _, _ = synthetic_mnist(n_train, 8, seed=0)
    return batch_iterator(x, y, batch=batch, seed=seed)


# ------------------------------------------------------------ scenarios

def zero_vs_replicated(*, slot_dtypes=("f32", "int8"), steps: int = 6,
                       batch: int = 64, accum: tuple = (1, 2),
                       ckpt_dir: str = "", moe: dict | None = None) -> dict:
    """LeNet on a (world, 1) mesh: ZeRO and replicated data parallelism
    from one init on the same global batches, f32 and int8 slots, with
    and without accumulation. Per run: losses, final params, the gathered
    slots, this rank's slot shapes and bytes, and the mean gradient of
    the last step and the params it started from (through
    ``stats_fn``). With ``moe`` ({"runs", "inits", "tokens"}), each of
    its runs through :func:`tp_run` on the same mesh, under ``"moe"``."""
    import torch
    from repro_torch.checkpoint import save_train_state
    from repro_torch.launch.mesh import mesh_from_spec, world
    from repro_torch.train import TrainPipeline
    rank, size = world()
    mesh = mesh_from_spec(f"{size}x1", device="cpu")
    cfg, model, _ = _lenet()
    out = {}
    for slot_dtype in slot_dtypes:
        for k in accum:
            for zero in (True, False):
                seen = {}

                def grab(params, grads, stacked):
                    seen["grads"] = _tree_np(grads)
                    seen["pre_params"] = _tree_np(params)
                    return {}

                pipe = TrainPipeline(
                    model, _optimizer("lars_int8" if slot_dtype == "int8"
                                      else "lars", 0.05), cfg,
                    mesh=mesh, zero=zero, accum_steps=k, stats_fn=grab)
                state = pipe.init_state(torch.Generator().manual_seed(3))
                it = _mnist_batches(256, batch)
                losses = []
                for _ in range(steps):
                    b = {n: torch.from_numpy(v) for n, v in next(it).items()}
                    state, m = pipe(state, b)
                    losses.append(float(m["loss"]))
                tag = f"{slot_dtype}-a{k}-{'zero' if zero else 'repl'}"
                local = {n: (tuple(v.shape), v.numel() * v.element_size())
                         for n, v in state.opt_state.slots.items()}
                if ckpt_dir:
                    with pipe.mesh_context():
                        save_train_state(os.path.join(ckpt_dir,
                                                      tag + ".npz"), state)
                out[tag] = {"losses": losses,
                            "params": _tree_np(state.params),
                            "slots": _whole_slots(pipe, state),
                            "local": local,
                            "layout": (state.opt_state.layout.total_rows,
                                       state.opt_state.layout.base_rows,
                                       state.opt_state.layout.shards),
                            "grads": seen["grads"],
                            "pre_params": seen["pre_params"]}
    # a tree-layout state (packed=False): one all-reduce of every leaf
    pipe = TrainPipeline(model, _optimizer("lars", 0.05), cfg, mesh=mesh,
                         packed=False)
    state = pipe.init_state(torch.Generator().manual_seed(3))
    it = _mnist_batches(256, batch)
    losses = []
    for _ in range(steps):
        state, m = pipe(state, {n: torch.from_numpy(v)
                                for n, v in next(it).items()})
        losses.append(float(m["loss"]))
    out["tree"] = {"losses": losses, "layout": state.opt_state.layout}
    if moe:
        out["moe"] = {run["tag"]: tp_run(run, moe["inits"][run["model"]],
                                         moe["tokens"], mesh)
                      for run in moe["runs"]}
    return out


def golden(*, init, runs, steps: int = 20, lr: float = 0.05) -> dict:
    """The LeNet golden workloads (tests/test_golden.py's: synthetic
    MNIST(256, 8, seed 0), batch_iterator seed 0) with ``zero=True`` on
    a (world, 1) mesh from the reference's init: the losses, and the
    final trust table as tests/test_torch_golden.py takes it."""
    import torch
    from repro_torch.core import trust_ratio as tr
    from repro_torch.launch.mesh import mesh_from_spec, world
    from repro_torch.train import TrainPipeline, train_state_from_params
    from repro_torch.train.step import value_and_grad
    _, size = world()
    mesh = mesh_from_spec(f"{size}x1", device="cpu")
    cfg, model, params = _lenet(init)
    out = {}
    for name, batch in runs:
        pipe = TrainPipeline(model, _optimizer(name, lr), cfg, mesh=mesh,
                             zero=True)
        with pipe.mesh_context():
            state = train_state_from_params(model, pipe.optimizer, params,
                                            zero_shards=size)
        it = _mnist_batches(256, batch)
        losses, trust = [], {}
        for i in range(steps):
            b = {k: torch.from_numpy(v) for k, v in next(it).items()}
            if i == steps - 1:
                _, grads, _ = value_and_grad(model, cfg, state.params, b)
                for layer, leaves in state.params.items():
                    w, g = leaves["w"], grads[layer]["w"]
                    ratio = tr.lars_trust_ratio(*tr.layer_norms(w, g, False),
                                                eta=0.01, weight_decay=1e-4)
                    trust[f"{layer}/w"] = [float(ratio)]
            state, m = pipe(state, b)
            losses.append(float(m["loss"]))
        out[f"{name}-b{batch}"] = {"losses": losses, "final_trust": trust,
                                   "rows": tuple(state.opt_state.slots[
                                       "momentum"].shape)}
    return out


def fuse_rules(*, steps: int = 10) -> dict:
    """``fuse_update=True`` on a (world, 1) mesh runs (ZeRO, 4 microbatches)
    and tracks the unfused replicated step, as the reference's
    ``_fused_zero_check``; on a (world/2, 2) mesh it raises ValueError,
    and ``"auto"`` trains LeNet there unfused (``model_parallel``: the
    losses and a digest of the final params, beside the same run on a
    (world/2, 1) mesh of the leading ranks)."""
    import torch
    from repro_torch.data import synthetic_mnist
    from repro_torch.launch.mesh import mesh_from_spec, world
    from repro_torch.train import TrainPipeline
    from repro_torch.treepath import tree_leaves
    _, size = world()
    mesh = mesh_from_spec(f"{size}x1", device="cpu")
    cfg, model, _ = _lenet()
    x, y, _, _ = synthetic_mnist(256, 8, seed=0)
    losses = {}
    for name, kw in [("zero_fused", dict(zero=True, fuse_update=True)),
                     ("replicated", dict(zero=False, fuse_update=False))]:
        pipe = TrainPipeline(model, _optimizer("lars", 0.05), cfg,
                             accum_steps=4, mesh=mesh, donate=False, **kw)
        state = pipe.init_state(torch.Generator().manual_seed(7))
        run = []
        for i in range(steps):
            lo = (i * 128) % 256
            state, m = pipe(state, {"x": torch.from_numpy(x[lo:lo + 128]),
                                    "y": torch.from_numpy(y[lo:lo + 128])})
            run.append(float(m["loss"]))
        losses[name] = run
    mp = mesh_from_spec(f"{size // 2}x2", device="cpu")
    half = mesh_from_spec(f"{size // 2}x1", device="cpu")
    raised, runs = {}, {}
    for fuse in (True, "auto"):
        try:
            TrainPipeline(model, _optimizer("lars", 0.05), cfg,
                          accum_steps=2, mesh=mp, fuse_update=fuse)
            raised[str(fuse)] = None
        except (ValueError, NotImplementedError) as e:
            raised[str(fuse)] = (type(e).__name__, str(e))
    for name, mesh in ((f"{size // 2}x2", mp), (f"{size // 2}x1", half)):
        if mesh is None:                    # a rank past the (W/2, 1) mesh
            continue
        pipe = TrainPipeline(model, _optimizer("lars", 0.05), cfg,
                             accum_steps=2, mesh=mesh)
        state = pipe.init_state(torch.Generator().manual_seed(7))
        run = []
        for i in range(5):
            lo = (i * 128) % 256
            state, m = pipe(state, {"x": torch.from_numpy(x[lo:lo + 128]),
                                    "y": torch.from_numpy(y[lo:lo + 128])})
            run.append(float(m["loss"]))
        runs[name] = {"losses": run, "params": [
            _np(t).tobytes() for t in tree_leaves(state.params)]}
    return {"losses": losses, "raised": raised, "model_parallel": runs}


def zero_smoke(*, out_dir: str, abort_after: int = 0, resume: bool = False,
               epochs: int = 1, n_train: int = 256) -> dict:
    """A cut of the registered ``zero_smoke`` grid (a (world, 1) mesh,
    1 epoch, ``n_train``) through GridRunner on CPU ranks; with
    ``abort_after`` the run is killed after that many recorded steps
    (the runner's test hook), with ``resume`` it continues."""
    from repro_torch.experiments import GridRunner, get_grid
    from repro_torch.experiments.runner import ABORT_ENV
    from repro_torch.launch.mesh import world
    _, size = world()
    grid = get_grid("zero_smoke", mesh=f"{size}x1", epochs=epochs,
                    n_train=n_train)
    if abort_after:
        os.environ[ABORT_ENV] = str(abort_after)
    runner = GridRunner(grid, out_dir, checkpoint_every=1, log=None,
                        device="cpu")
    try:
        manifest = runner.run(resume=resume)
        return {"interrupted": False, "cells": sorted(manifest["cells"])}
    except KeyboardInterrupt:
        return {"interrupted": True}


def tp_run(run: dict, init, tokens, mesh=None, ckpt_dir: str = "") -> dict:
    """One tensor-parallelism run (``tests/test_torch_tensor_parallel.
    py``): a reduced dense LM from the reference's ``init`` (numpy; the
    port's seed-0 init with ``run["port_init"]``) for
    ``run["steps"]`` LARS steps on ``tokens`` through TrainPipeline on
    ``mesh`` (``None``: the port alone, no process group). ``run`` names
    the arch and the pipeline's options. Returns the losses, the whole
    final params (gathered; on model rank 0 of data row 0 only), a digest
    of every replicated leaf, the trust ratios the update applied on the
    last step (``lars_trust_ratio`` recorded) and the LARS kernel
    wrappers called each step with their buffers' rows. For the moe
    family also each step's aux loss, the first MoE call's
    ``dropped_frac`` and input (the global batch's first layer) and every
    routing's kept (token, expert) slots, (n, E) bool, in call order
    (``routes``)."""
    import dataclasses
    import hashlib
    import torch
    from repro_torch import bridge
    from repro_torch.configs import get_config
    from repro_torch.core import lars
    from repro_torch.core import trust_ratio as tr
    from repro_torch.kernels import lars_kernels as lk
    from repro_torch.models import build_model
    from repro_torch.models import lm as lm_module
    from repro_torch.models import moe as moe_module
    from repro_torch.train import TrainPipeline, train_state_from_params
    from repro_torch.treepath import tree_flatten_with_path, tree_leaves
    cfg = dataclasses.replace(get_config(run["arch"]).reduced(),
                              **run.get("changes", {}))
    model = build_model(cfg)
    opt = lars(run.get("lr", 0.05), trust_coefficient=0.01,
               slot_dtype=run.get("slots", "f32"))
    zero = run.get("zero", False) and mesh is not None
    pipe = TrainPipeline(model, opt, cfg, accum_steps=run.get("accum", 2),
                         precision=run.get("precision", "f32"), mesh=mesh,
                         zero=zero, packed=run.get("packed", True),
                         donate=False)
    with pipe.mesh_context():
        state = train_state_from_params(
            model, opt, model.init(torch.Generator().manual_seed(0), "cpu")
            if run.get("port_init") else
            bridge.lm_params_to_torch(init, model),
            precision=pipe.precision, packed=pipe.packed,
            zero_shards=pipe._zero_shards, mesh=mesh)
    if ckpt_dir:
        pipe.save(os.path.join(ckpt_dir, run["tag"] + "-init.npz"), state)
    # the bridge's cut of the reference's init is the state's blocks
    bridged = None
    if mesh is not None and not run.get("port_init") \
            and pipe.precision.compute_dtype is None:
        bridged = all(torch.equal(a, b) for a, b in zip(
            tree_leaves(bridge.params_to_mesh(init, model, mesh)),
            tree_leaves(state.params)))
    seen, ratios = [], []
    kernels = ("norms_flat", "apply_flat", "apply_flat_q8")
    saved = {k: getattr(lk, k) for k in kernels}
    saved_trust = tr.lars_trust_ratio

    def trust(*a, **kw):
        out = saved_trust(*a, **kw)
        ratios.append(out.detach().reshape(-1).numpy().copy())
        return out

    for k, inner in saved.items():
        def wrapped(w2, *a, _k=k, _f=inner, **kw):
            seen[-1].append((_k, int(w2.shape[0])))
            return _f(w2, *a, **kw)
        setattr(lk, k, wrapped)
    tr.lars_trust_ratio = trust
    first_moe: dict = {}
    saved_moe = lm_module.moe_block

    def moe_block(cfg_, p, x, **kw):
        out, aux = saved_moe(cfg_, p, x, **kw)
        if not first_moe:
            first_moe.update(dropped=float(aux["dropped_frac"]), x=_np(x))
        return out, aux

    routes: list = []
    saved_place = moe_module.place

    def place(cfg_, r, lower=None):
        s = saved_place(cfg_, r, lower)
        keep = torch.empty_like(s.keep).scatter_(0, s.order, s.keep)
        routes.append(torch.zeros(r.expert_ids.shape[0], cfg_.num_experts,
                                  dtype=torch.bool).scatter_(
            1, r.expert_ids.long(), keep.reshape(r.expert_ids.shape)
        ).numpy())
        return s

    lm_module.moe_block = moe_block
    moe_module.place = place
    losses, aux_losses = [], []
    try:
        for _ in range(run.get("steps", 2)):
            seen.append([])
            ratios.clear()
            state, m = pipe(state, {"tokens": torch.from_numpy(tokens)})
            losses.append(float(m["loss"]))
            aux_losses.append(float(m["aux_loss"]))
    finally:
        for k, fn in saved.items():
            setattr(lk, k, fn)
        tr.lars_trust_ratio = saved_trust
        lm_module.moe_block = saved_moe
        moe_module.place = saved_place
    shardings = pipe.param_shardings
    split = {} if shardings is None else {
        p: sh.split for p, sh in tree_flatten_with_path(shardings)[0]}
    replicated = {"/".join(p): hashlib.sha256(_np(x).tobytes()).hexdigest()
                  for p, x in tree_flatten_with_path(state.params)[0]
                  if not split.get(p)}
    whole = _tree_np(state.params) if shardings is None else \
        bridge.params_from_mesh(state.params, model, mesh)
    restored = None
    if ckpt_dir:
        path = os.path.join(ckpt_dir, run["tag"] + ".npz")
        pipe.save(path, state)
        back = pipe.restore(path, pipe.init_state(
            torch.Generator().manual_seed(1), "cpu"))
        restored = back.opt_state.step == state.opt_state.step and all(
            torch.equal(a, b) for a, b in zip(
                tree_leaves({"p": back.params, "s": back.opt_state.slots}),
                tree_leaves({"p": state.params,
                             "s": state.opt_state.slots})))
    first = mesh is None or mesh.rank == 0
    return {"losses": losses, "params": whole if first else None,
            "aux_losses": aux_losses, "dropped": first_moe.get("dropped"),
            "routes": routes,
            "moe_x": first_moe.get("x") if mesh is None else None,
            "replicated": replicated, "ratios": list(ratios),
            "kernels": seen,
            "local": {"/".join(p): tuple(x.shape) for p, x in
                      tree_flatten_with_path(state.params)[0]},
            "rows": None if state.opt_state.layout is None else
            int(state.opt_state.slots["momentum"].shape[0]),
            "restored": restored, "bridged": bridged}


def _rel(got, want) -> float:
    """max |got - want| over max |want|."""
    return float((got - want).abs().max() / want.abs().max())


def tp_units(mesh) -> dict:
    """Tensor parallelism's pieces alone against the plain functions on
    this rank, as max gaps relative to the plain result's largest
    magnitude: the vocab-parallel NLL (value and gradient) and attention
    blocks, GQA and MLA, whose heads the model axis does not split evenly
    (output, the input's gradient and every param's gathered gradient),
    and MLA's decode at such heads (output)."""
    import dataclasses
    import torch
    from repro_torch.configs import get_config
    from repro_torch.distributed import collectives as C
    from repro_torch.distributed.sharding import (Stripe, gather_params,
                                                  param_shardings,
                                                  shard_params)
    from repro_torch.models import attention as A
    from repro_torch.models import mla
    from repro_torch.train.losses import softmax_cross_entropy
    from repro_torch.treepath import tree_leaves
    g = torch.Generator().manual_seed(5)
    out = {}
    logits = torch.randn(2, 6, 16, generator=g) * 3
    labels = torch.randint(0, 16, (2, 6), generator=g)
    whole = logits.clone().requires_grad_(True)
    plain = softmax_cross_entropy(whole, labels)
    plain.backward()
    local = C.split_dim(logits, mesh, -1).clone().requires_grad_(True)
    vp = softmax_cross_entropy(local, labels, tp=mesh)
    vp.backward()
    out["nll"] = (_rel(vp, plain), _rel(local.grad, C.split_dim(
        whole.grad, mesh, -1)))
    # 3 heads over 2 ranks (every head computed whole, q/k norms and
    # biases too); 6 heads on 3 KV heads (this rank's heads, the KV heads
    # gathered and taken one per query head); MLA's 3 heads over 2 ranks
    # with a query rank (q_up, k_up, v_up and wo split mid-head) and
    # without one at a value width of 15 (wq and k_up split, v_up and wo
    # whole: their 45 rows do not divide)
    base = get_config("qwen3-14b").reduced()
    deepseek = get_config("deepseek-v2-236b").reduced()
    for name, base_cfg, init, block, ch in (
            ("heads_3", base, A.init_attention, A.attention_block,
             dict(num_heads=3, num_kv_heads=3, qkv_bias=True)),
            ("heads_6_kv_3", base, A.init_attention, A.attention_block,
             dict(num_heads=6, num_kv_heads=3, head_dim=16)),
            ("mla_heads_3", deepseek, mla.init_mla, mla.mla_block,
             dict(num_heads=3, q_lora_rank=48)),
            ("mla_heads_3_vd_15", deepseek, mla.init_mla, mla.mla_block,
             dict(num_heads=3, v_head_dim=15))):
        cfg = dataclasses.replace(base_cfg, **ch)
        p = init(torch.Generator().manual_seed(6), cfg, cfg.d_model,
                 torch.float32, "cpu")
        if cfg.qkv_bias:
            p = {k: v + 0.1 * torch.randn(v.shape, generator=g)
                 if k.startswith("b") else v for k, v in p.items()}
        sh = param_shardings(cfg, p, mesh)
        x = torch.randn(2, 5, cfg.d_model, generator=g)
        cot = torch.randn(2, 5, cfg.d_model, generator=g)
        pos = torch.arange(5)
        pw = {k: v.clone().requires_grad_(True) for k, v in p.items()}
        xw = x.clone().requires_grad_(True)
        y = block(cfg, pw, xw, pos)
        (y * cot).sum().backward()
        pl = {k: v.clone().requires_grad_(True)
              for k, v in shard_params(p, sh).items()}
        xl = x.clone().requires_grad_(True)
        yl = block(cfg, pl, xl, pos, tp=mesh)
        (yl * cot).sum().backward()
        grads = gather_params({k: v.grad for k, v in pl.items()}, sh)
        out[name] = {
            "out": _rel(yl, y),
            "x_grad": _rel(xl.grad, xw.grad),
            "param_grads": max(_rel(a, b.grad) for a, b in
                               zip(tree_leaves(grads), tree_leaves(pw))),
            "split": sorted(k for k, v in pl.items()
                            if v.shape != p[k].shape)}
    # MLA's absorbed decode at 3 heads (every head on every rank, each
    # rank its share of wo, the shares summed): on the whole latent cache
    # and on the rank's stripe of it (rows over model, the partials
    # merged), at lengths 1, S/2 + 1 and past capacity, against the plain
    # decode on the whole cache
    cfg = dataclasses.replace(deepseek, num_heads=3, q_lora_rank=48)
    p = mla.init_mla(torch.Generator().manual_seed(7), cfg, cfg.d_model,
                     torch.float32, "cpu")
    pl = shard_params(p, param_shardings(cfg, p, mesh))
    W, S = mesh.shape["model"], 8
    rows, at = S // W, mesh.coords["model"]
    x = torch.randn(3, 1, cfg.d_model, generator=g)
    ckv = torch.randn(3, S, cfg.kv_lora_rank, generator=g)
    krope = torch.randn(3, S, cfg.qk_rope_dim, generator=g)
    pos = torch.tensor([0, S // 2, S + 2], dtype=torch.int32)
    want = mla.mla_decode(cfg, p, x, ckv.clone(), krope.clone(), pos)[0]
    whole = mla.mla_decode(cfg, pl, x, ckv.clone(), krope.clone(), pos,
                           tp=mesh)[0]
    sl = slice(at * rows, (at + 1) * rows)
    striped = mla.mla_decode(cfg, pl, x, ckv[:, sl].clone(),
                             krope[:, sl].clone(), pos, tp=mesh,
                             stripe=Stripe(at, W, rows, "model", mesh))[0]
    out["mla_decode_heads_3"] = {
        "whole": _rel(whole, want), "striped": _rel(striped, want),
        "split": sorted(k for k in p if pl[k].shape != p[k].shape)}
    return out


def tensor_parallel(*, runs, inits, tokens, ckpt_dir: str = "",
                    units: bool = False) -> dict:
    """Every run of ``runs`` on its mesh (``run["mesh"]``, ``DxM`` over
    the leading ranks; the meshes built once each, in order, on every
    rank), from ``inits[run["model"]]`` (``run["arch"]`` without a
    ``model``): :func:`tp_run`'s result by tag
    (nothing for a rank past a run's mesh); with ``units``,
    :func:`tp_units` on a ``1xW`` mesh under ``"units"``."""
    from repro_torch.launch.mesh import mesh_from_spec, world
    meshes, out = {}, {}
    if units:
        out["units"] = tp_units(mesh_from_spec(f"1x{world()[1]}",
                                               device="cpu"))
    for run in runs:
        if run["mesh"] not in meshes:
            meshes[run["mesh"]] = mesh_from_spec(run["mesh"], device="cpu")
        mesh = meshes[run["mesh"]]
        if mesh is not None:
            out[run["tag"]] = tp_run(run, inits[run.get("model",
                                                        run["arch"])],
                                     tokens, mesh,
                                     ckpt_dir if run.get("ckpt") else "")
    return out


def serve_run(run: dict, init, prompts, mesh=None) -> dict:
    """One serving run (``tests/test_torch_serve_mesh.py``): a reduced LM
    (``run["arch"]`` with ``run["changes"]``) from the reference's
    ``init`` (numpy; the port's seed-1 init where it is None) served by
    ``ServeEngine(mesh=mesh, **run["engine"])`` (``mesh`` None: the port
    alone) on ``prompts``, ``run["new"]`` tokens each, the request of
    prompt i at tier ``run["tiers"][i]`` (0 without). Returns the tokens
    by rid, the finish order, the decode ticks, ``decode_step`` calls
    and ``flash_decode`` wrapper calls, whether the ranks' scheduler
    digests agree, the stripe and the local leaf shapes. With
    ``run["refuse"]`` the engine's construction must raise
    ``NotImplementedError``: its message (None where it did not)."""
    import dataclasses
    import numpy as np
    import torch
    from repro_torch import bridge
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.models import build_model
    from repro_torch.serve import SamplerConfig, ServeEngine
    from repro_torch.serve.scheduler import Request, TierSLO
    cfg = dataclasses.replace(get_config(run["arch"]).reduced(),
                              **run.get("changes", {}))
    model = build_model(cfg)
    params = model.init(torch.Generator().manual_seed(1), "cpu") \
        if init is None else bridge.lm_params_to_torch(init, model)
    kw = dict(run.get("engine", {}))
    if "sampler" in kw:
        kw["sampler"] = SamplerConfig(**kw["sampler"])
    if "slos" in kw:
        kw["slos"] = {t: TierSLO(*v) for t, v in kw["slos"].items()}
    if run.get("refuse"):
        try:
            ServeEngine(model, params, cfg, mesh=mesh, **kw)
        except NotImplementedError as e:
            return {"refused": str(e)}
        return {"refused": None}
    calls = [0]
    inner = ops.flash_decode

    def counted(*a, **k):
        calls[0] += 1
        return inner(*a, **k)

    ops.flash_decode = counted
    try:
        engine = ServeEngine(model, params, cfg, mesh=mesh, **kw)
        tiers = run.get("tiers") or [0] * len(prompts)
        finished = engine.run([
            Request(rid=i, tokens=np.asarray(p), max_new_tokens=run["new"],
                    tier=t) for i, (p, t) in enumerate(zip(prompts, tiers))])
    finally:
        ops.flash_decode = inner
    stripe = getattr(engine.cache.data, "stripe", None)
    return {"tokens": {f.request.rid: f.tokens.tolist() for f in finished},
            "order": [f.request.rid for f in finished],
            "decode_steps": engine.stats["decode_steps"],
            "decode_calls": engine.stats["decode_calls"],
            "wrapper_calls": calls[0],
            "agree": engine.ranks_agree(),
            "stripe": None if stripe is None else tuple(stripe[:4]),
            "slot_block": (engine.cache.slot_block.start,
                           engine.cache.slot_block.stop),
            "local": {k: tuple(v.shape) for k, v in
                      engine.cache.data.items()},
            "capacity": model.cache_capacity(engine.cache.data)}


def serve_mesh(*, runs, inits, prompts, cli=None) -> dict:
    """Every run of ``runs`` on its mesh (``run["mesh"]``, over the
    leading ranks; each mesh built once, in order, on every rank):
    :func:`serve_run`'s result by tag (nothing for a rank past a run's
    mesh); with ``cli``, ``launch.serve.main(cli)`` (its ``--mesh``
    included) under ``"cli"``: rank 0's report's tokens by rid, every
    rank's digest agreement."""
    from repro_torch.launch import serve as launch_serve
    from repro_torch.launch.mesh import mesh_from_spec
    meshes, out = {}, {}
    for run in runs:
        if run["mesh"] not in meshes:
            meshes[run["mesh"]] = mesh_from_spec(run["mesh"], device="cpu")
        mesh = meshes[run["mesh"]]
        if mesh is not None:
            out[run["tag"]] = serve_run(run, inits.get(run["model"]),
                                        prompts[run["model"]], mesh)
    if cli:
        rep = launch_serve.main(cli)
        out["cli"] = {"tokens": {f.request.rid: f.tokens.tolist()
                                 for f in rep.get("finished", [])},
                      "agree": rep.get("ranks_agree"),
                      "mesh": rep.get("mesh")}
    return out


SCENARIOS = {f.__name__: f for f in (zero_vs_replicated, golden, fuse_rules,
                                      zero_smoke, tensor_parallel,
                                      serve_mesh)}


def _main(scenario: str, rank: int, size: int, tmp: str) -> None:
    import torch
    import torch.distributed as dist
    torch.set_num_threads(1)
    with open(os.path.join(tmp, "args.pkl"), "rb") as f:
        kwargs = pickle.load(f)
    dist.init_process_group("gloo", init_method=f"file://{tmp}/rendezvous",
                            rank=rank, world_size=size)
    try:
        result = SCENARIOS[scenario](**kwargs)
    finally:
        dist.destroy_process_group()
    with open(os.path.join(tmp, f"out{rank}.pkl"), "wb") as f:
        pickle.dump(result, f)


if __name__ == "__main__":
    _main(sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), sys.argv[4])
