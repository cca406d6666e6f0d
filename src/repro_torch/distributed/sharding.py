"""Logical sharding rules: param tree -> PartitionSpec tree (port of
``repro/distributed/sharding.py``, whole).

Scheme (the reference's): a 2-D ``(data, model)`` mesh, optionally a
leading ``pod`` axis. Megatron-style tensor parallelism over ``model``
(attention heads / FFN hidden / vocab / experts / SSM channels) combined
with FSDP-style parameter sharding over ``data`` on the remaining large
axis. Rules are matched on the leaf's path (module key + leaf name),
falling back to replication; every leaf under a scan-stacked collection
("layers" / "enc_layers" / "dec_layers") gets a leading ``None`` for the
layer axis.

The rule tables and the spec functions are the reference's, leaf for
leaf, so the port's specs compare one to one with its ``PartitionSpec``s.
A spec here is :class:`PartitionSpec`: a tuple with one entry per
dimension, each ``None``, an axis name or a tuple of names. The mesh
argument is anything with ``shape`` (axis -> size) and ``axis_names``:
the port's :class:`~repro_torch.launch.mesh.Mesh`, or a stand-in for a
mesh no process group has (the tests' 16 x 16).

What the port executes: on a data-parallel mesh (``model`` axis 1)
every param is whole on every rank (the ``data`` entry of an FSDP param
spec is the reference's; ZeRO shards the optimizer slots instead), a
batch is cut into row blocks by :func:`batch_pspecs` (for the moe
family under accumulation, each microbatch's block: :func:`shard_rows`'
``blocks``), and :func:`named` / :func:`tree_named` turn a spec into a
:class:`LeafSharding` — which block of each dim this rank holds. On a
``model`` axis above 1 it also executes the ``model`` entries of the
dense family's param specs (Megatron tensor parallelism), of MLA's
(``q_up``/``wq``, ``k_up`` and ``v_up`` by columns and ``wo`` by rows:
the heads; ``q_down``, ``kv_down`` and their norms whole), of the moe
family's (expert parallelism: ``_MOE`` splits the experts, ``_MOE_TP``
each expert's ff where ``model`` does not divide the experts; the
router and the norms whole) and LeNet's (all replicated). Where
:func:`_divisible` drops a split, the leaf is whole on every rank.
:func:`model_pspecs` keeps a param spec's ``model`` entries and drops
its ``data`` ones (FSDP's, queue 1 item 4b-ii: params stay whole over
``data``); :func:`param_shardings` turns them into one
:class:`LeafSharding` a leaf, :func:`shard_params` cuts a whole params
tree to this rank's blocks and :func:`gather_params` gathers them back.
The ssm, hybrid, encdec and vlm families raise on a ``model`` axis above
1 (:func:`check_model_parallel`, naming queue 1 item 4b-ii).

The serving mesh executes :func:`serve_param_pspecs` (pure tensor
parallelism, :func:`serve_param_shardings`) and :func:`cache_pspecs`
(:class:`CacheSharding`): each rank holds its block of the slots (over
``data``) and its stripe of the sequence (over ``model``, or over
``("data", "model")`` where ``data`` does not divide the slots), as
:class:`Stripe` tells the decode attention.
"""

from __future__ import annotations

from typing import Any, NamedTuple, Optional

from repro_torch.distributed import collectives
from repro_torch.treepath import (tree_flatten_with_path, tree_map,
                                  tree_unflatten)

Pytree = Any

STACKED_KEYS = ("layers", "enc_layers", "dec_layers")


class PartitionSpec(tuple):
    """One entry per dimension: ``None``, an axis name, or a tuple of
    names. ``P("data", None)``. A one-name tuple is stored as the name,
    as JAX's ``PartitionSpec`` stores it."""

    def __new__(cls, *entries):
        return super().__new__(cls, (
            e[0] if isinstance(e, tuple) and len(e) == 1 else e
            for e in entries))

    def __repr__(self) -> str:
        return f"P{tuple.__repr__(self)}"


P = PartitionSpec

# (module-context, leaf-name) -> spec for the trailing (own) dims.
# "@model" / "@data" mark mesh axes; None = replicated dim.
_ATTN = {
    "wq": ("@data", "@model"), "wk": ("@data", "@model"),
    "wv": ("@data", "@model"), "wo": ("@model", "@data"),
    "bq": ("@model",), "bk": ("@model",), "bv": ("@model",),
    "q_norm": (None,), "k_norm": (None,),
    # --- MLA ---
    "q_down": ("@data", None), "q_up": ("@data", "@model"),
    "kv_down": ("@data", None), "kv_norm": (None,),
    "k_up": ("@data", "@model"), "v_up": ("@data", "@model"),
}
_MLP = {
    "wi": ("@data", "@model"), "wg": ("@data", "@model"),
    "wo": ("@model", "@data"),
}
_MOE = {
    "router": (None, None),                       # (d, E) small, replicated
    "wi": ("@model", "@data", None),              # (E, d, ff): experts on TP
    "wg": ("@model", "@data", None),
    "wo": ("@model", None, "@data"),
}
# expert count not divisible by the model axis (granite: 40 experts on a
# 16-way axis) -> expert-INTERNAL tensor parallelism instead
_MOE_TP = {
    "router": (None, None),
    "wi": (None, "@data", "@model"),
    "wg": (None, "@data", "@model"),
    "wo": (None, "@model", "@data"),
}
_SSM = {
    "in_proj": ("@data", "@model"),
    "out_proj": ("@model", "@data"),
    "x_proj": ("@model", None),                   # (din, R+2N) row-parallel
    "dt_proj": (None, "@model"),                  # (R, din)
    "conv_w": (None, "@model"),                   # (K, channels)
    "conv_b": ("@model",),
    "dt_bias": ("@model",),
    "A_log": None,                                # mamba1 (din,N) / mamba2 (heads,)
    "D": ("@model",),
    "norm_scale": ("@model",),
}
_TOP = {
    # vocab-parallel only (see the reference)
    "embed": ("@model", None),
    "unembed": (None, "@model"),
}


def _resolve(entry, shape) -> PartitionSpec:
    if entry is None:
        return P(*([None] * len(shape)))
    assert len(entry) == len(shape), (entry, shape)
    return P(*[e[1:] if isinstance(e, str) and e.startswith("@") else e
               for e in entry])


def _leaf_spec(path, shape, family: str, moe_tp: bool = False
               ) -> PartitionSpec:
    keys = [str(k) for k in path]
    name = keys[-1] if keys else ""
    stacked = any(k in STACKED_KEYS for k in keys)
    own = tuple(shape[1:]) if stacked else tuple(shape)

    spec: Optional[PartitionSpec] = None
    ctx = set(keys)
    moe_rules = _MOE_TP if moe_tp else _MOE
    if name in ("embed", "unembed") and len(own) == 2:
        spec = _resolve(_TOP[name], own)
    elif "ssm" in ctx and name in _SSM:
        ent = _SSM[name]
        if name == "A_log":
            # mamba1: (din, N) -> shard din; mamba2: (heads,) -> replicate
            ent = ("@model", None) if len(own) == 2 else (None,)
        if name == "conv_b" and len(own) == 1:
            ent = ("@model",)
        spec = _resolve(ent, own)
    elif "moe" in ctx and name in moe_rules and "shared" not in ctx:
        spec = _resolve(moe_rules[name], own)
    elif ("mlp" in ctx or "shared" in ctx) and name in _MLP:
        spec = _resolve(_MLP[name], own)
    elif name in _ATTN and len(own) == len(_ATTN[name]):
        spec = _resolve(_ATTN[name], own)
    elif name in ("scale", "bias"):                     # norms
        spec = P(*([None] * len(own)))
    elif len(own) == 2 and name in ("wi", "wg", "wo"):  # bare mlp
        spec = _resolve(_MLP[name], own)
    if spec is None:
        spec = P(*([None] * len(own)))                  # replicate fallback

    if stacked:
        return P(None, *spec)
    return spec


def _divisible(spec: PartitionSpec, shape, mesh) -> PartitionSpec:
    """Drop sharded axes that don't divide their dim (e.g. whisper's
    vocab 51865 on a 16-way model axis falls back to replicated)."""
    if mesh is None:
        return spec
    out = []
    for dim, ax in zip(shape, tuple(spec) + (None,) * (len(shape)
                                                       - len(spec))):
        if ax is None:
            out.append(None)
            continue
        names = (ax,) if isinstance(ax, str) else tuple(ax)
        size = 1
        for n in names:
            size *= mesh.shape[n]
        out.append(ax if dim % size == 0 else None)
    return P(*out)


def _map_with_path(fn, tree: Pytree) -> Pytree:
    leaves, treedef = tree_flatten_with_path(tree)
    return tree_unflatten(treedef, [fn(p, leaf) for p, leaf in leaves])


def param_pspecs(cfg, params_shapes: Pytree, mesh=None) -> Pytree:
    """Shape tree (tensors, meta tensors, anything with ``.shape``) ->
    PartitionSpecs."""
    if cfg.family == "cnn":                             # LeNet: replicated
        return _map_with_path(lambda p, x: P(), params_shapes)
    moe_tp = bool(cfg.num_experts) and mesh is not None \
        and cfg.num_experts % mesh.shape["model"] != 0
    return _map_with_path(
        lambda path, leaf: _divisible(
            _leaf_spec(path, tuple(leaf.shape), cfg.family, moe_tp),
            tuple(leaf.shape), mesh),
        params_shapes)


def serve_param_pspecs(cfg, params_shapes: Pytree, mesh=None,
                       hbm_budget: float = 12e9) -> Pytree:
    """Serving-mode param specs: pure tensor parallelism. When the TP-only
    per-device footprint fits the HBM budget, drop the ``data`` axis from
    every param spec; models too big for pure TP keep the training
    sharding (the reference's rule)."""
    specs = param_pspecs(cfg, params_shapes, mesh)
    if mesh is None:
        return specs
    total = 0
    for _, leaf in tree_flatten_with_path(params_shapes)[0]:
        n = 1
        for d in leaf.shape:
            n *= int(d)
        total += n * leaf.dtype.itemsize
    if total / mesh.shape["model"] > hbm_budget:
        return specs

    def strip(spec: PartitionSpec) -> PartitionSpec:
        out = []
        for ax in spec:
            if ax == "data":
                out.append(None)
            elif isinstance(ax, tuple):
                kept = tuple(a for a in ax if a != "data")
                out.append(kept if kept else None)
            else:
                out.append(ax)
        return P(*out)

    return _map_with_path(lambda p, s: strip(s), specs)


def state_pspecs(cfg, state_shapes, mesh=None) -> Any:
    """TrainState(params, OptState(step, slots)) -> matching spec tree.

    Tree-layout opt states: slot trees mirror params leaf for leaf, so
    they inherit the param specs (the int8 scale trees stay replicated).
    Flat-packed states: each slot is one superbuffer, replicated, unless
    the layout is ZeRO-sharded (``layout.shards > 1``) over a mesh whose
    ``data`` axis splits its rows on block boundaries: then every packed
    slot is ``P("data", None)`` — which is what the port's ZeRO state
    holds, each rank its own block of rows.
    """
    from repro_torch.core.optim_base import SCALE_SUFFIX, OptState
    from repro_torch.train.state import TrainState
    pspecs = param_pspecs(cfg, state_shapes.params, mesh)
    opt = state_shapes.opt_state
    if getattr(opt, "layout", None) is not None:
        layout = opt.layout
        if getattr(layout, "shards", 1) > 1 and mesh is not None \
                and "data" in mesh.axis_names \
                and layout.total_rows % (mesh.shape["data"]
                                         * layout.block_rows) == 0:
            slot_specs = {k: P("data", None) for k in opt.slots}
        else:
            slot_specs = {k: P(None, None) for k in opt.slots}
        opt_spec = OptState(step=P(), slots=slot_specs, layout=opt.layout)
    else:
        replicated = _map_with_path(lambda p, s: P(), pspecs)
        slot_specs = {k: (replicated if k.endswith(SCALE_SUFFIX)
                          else pspecs) for k in opt.slots}
        opt_spec = OptState(step=P(), slots=slot_specs)
    return TrainState(params=pspecs, opt_state=opt_spec)


# ----------------------------------------------------------------- batches

def _batch_axes(mesh) -> tuple[str, ...]:
    return tuple(a for a in ("pod", "data") if a in mesh.axis_names)


def batch_pspecs(cfg, mesh, *, batch: int) -> dict[str, PartitionSpec]:
    """Input-batch PartitionSpecs for a train/prefill step: rows over the
    batch axes where they divide ``batch``, else replicated."""
    ba = _batch_axes(mesh)
    bsz = 1
    for a in ba:
        bsz *= mesh.shape[a]
    b_ax = ba if batch % bsz == 0 else None
    if cfg.family == "cnn":
        return {"x": P(b_ax, None, None, None), "y": P(b_ax)}
    specs = {"tokens": P(b_ax, None)}
    if cfg.family == "encdec":
        specs["frames"] = P(b_ax, None, None)
    if cfg.family == "vlm":
        specs["image_embeddings"] = P(b_ax, None, None)
    return specs


# ------------------------------------------------------------------ caches

def cache_pspecs(cfg, mesh, cache_shapes: Pytree, *, batch: int) -> Pytree:
    """Decode-cache PartitionSpecs (the reference's): sequence axes over
    ``model`` (split-KV), batch over (pod, data) when divisible; for a
    batch the batch axes do not divide, the sequence also takes
    ``data``. SSM states shard d_inner over ``model``."""
    ba = _batch_axes(mesh)
    bsz = 1
    for a in ba:
        bsz *= mesh.shape[a]
    b_ax: Any = ba if batch % bsz == 0 else None
    seq_ax: Any = "model" if b_ax is not None else ("data", "model")

    def spec(path, leaf):
        name = str(path[-1])
        nd = len(leaf.shape)
        if name == "pos":
            return P(b_ax)
        if name in ("k", "v", "attn_k", "attn_v"):     # (L,B,S,Hkv,hd)
            return P(None, b_ax, seq_ax, None, None)
        if name in ("xk", "xv"):                       # (L,B,S_enc,Hkv,hd)
            return P(None, b_ax, None, None, None)
        if name in ("ckv", "krope"):                   # (L,B,S,r)
            return P(None, b_ax, seq_ax, None)
        if name == "conv":                             # (L,B,K-1,C)
            return P(None, b_ax, None, "model")
        if name == "h":                                # mamba1 (L,B,din,N)
            if nd == 4:                                # / mamba2
                return P(None, b_ax, "model", None)
            return P(None, b_ax, "model", None, None)  # (L,B,heads,hd,N)
        return P(*([None] * nd))

    return _map_with_path(
        lambda path, leaf: _divisible(spec(path, leaf), tuple(leaf.shape),
                                      mesh),
        cache_shapes)


# ----------------------------------------------------------------- helpers

class LeafSharding:
    """What a spec means for one rank of a mesh: the block of every dim
    it holds (``block(dim, n)``; ``rows(n)`` for dim 0), or all of a dim
    the spec does not split or splits over axes of one rank. The port's
    counterpart of the reference's ``NamedSharding``: :meth:`shard` cuts a
    whole tensor to this rank's block, :meth:`gather` all-gathers the
    blocks back (a collective over each splitting axis), and
    :meth:`whole_shape` is the shape of the whole."""

    def __init__(self, mesh, spec: PartitionSpec):
        self.mesh, self.spec = mesh, P(*spec)
        self.parts = tuple(_axis_size(mesh, ax) for ax in self.spec)
        self.index = tuple(_axis_index(mesh, ax) for ax in self.spec)

    @property
    def sharded(self) -> bool:
        """Dim 0 is split over the batch axes (one part on a one-rank
        axis: the ranks' gradients are still reduced over it)."""
        return len(self.spec) > 0 and self.spec[0] is not None

    @property
    def split(self) -> bool:
        """Some dim is cut into more than one part."""
        return any(p > 1 for p in self.parts)

    def block(self, dim: int, n: int) -> slice:
        parts = self.parts[dim] if dim < len(self.parts) else 1
        if n % parts:
            raise ValueError(f"{n} rows do not split into {parts}")
        step = n // parts
        i = self.index[dim] if dim < len(self.index) else 0
        return slice(i * step, (i + 1) * step)

    def rows(self, n: int) -> slice:
        return self.block(0, n)

    def shard(self, x):
        """This rank's block of ``x`` (a view, or ``x`` itself)."""
        if not self.split:
            return x
        return x[tuple(self.block(d, n) for d, n in enumerate(
            x.shape[:len(self.parts)]))]

    def whole_shape(self, shape) -> tuple:
        return tuple(n * (self.parts[d] if d < len(self.parts) else 1)
                     for d, n in enumerate(shape))

    def gather(self, x):
        """The whole tensor from this rank's block: one all-gather over
        each axis that splits a dim (the last-named axis first, so a dim
        split over several axes comes back in row-major order)."""
        for d, ax in enumerate(self.spec):
            if self.parts[d] == 1:
                continue
            names = (ax,) if isinstance(ax, str) else tuple(ax)
            for n in reversed(names):
                x = collectives.all_gather_dim(x, self.mesh, d, n)
        return x

    def __repr__(self) -> str:
        return (f"LeafSharding({self.spec}, block {self.index} of "
                f"{self.parts})")


def _axis_size(mesh, ax) -> int:
    if ax is None:
        return 1
    names = (ax,) if isinstance(ax, str) else tuple(ax)
    size = 1
    for n in names:
        size *= mesh.shape[n]
    return size


def _axis_index(mesh, ax) -> int:
    """This rank's part of a dim split over ``ax`` (row-major over a
    tuple of axes)."""
    if ax is None:
        return 0
    names = (ax,) if isinstance(ax, str) else tuple(ax)
    index = 0
    for n in names:
        index = index * mesh.shape[n] + mesh.coords[n]
    return index


def named(mesh, spec: PartitionSpec) -> LeafSharding:
    return LeafSharding(mesh, spec)


def tree_named(mesh, specs: Pytree) -> Pytree:
    if isinstance(specs, PartitionSpec):
        return named(mesh, specs)
    return {k: tree_named(mesh, v) for k, v in specs.items()}


class LocalBatch(dict):
    """This rank's part of a global batch: its rows where the batch is
    split over the batch axes (``sharded``: the ranks' gradients differ
    and are reduced), the whole batch where it is replicated.
    ``global_rows`` is the global batch size; ``blocks`` the number of
    equal row blocks (microbatches) of which the rank holds a block each
    (:func:`shard_rows`)."""

    def __init__(self, items, *, global_rows: int, sharded: bool,
                 blocks: int = 1):
        super().__init__(items)
        self.global_rows = global_rows
        self.sharded = sharded
        self.blocks = blocks


def shard_rows(batch: dict, shardings: dict, blocks: int = 1
               ) -> LocalBatch:
    """A global batch dict -> this rank's :class:`LocalBatch` under
    ``tree_named(mesh, batch_pspecs(...))``. With ``blocks`` = k > 1 (a
    split batch) the rows are cut into k equal blocks first, and the rank
    holds its block of each, in order: its i-th 1/k of its rows is its
    block of the global batch's i-th 1/k (microbatch i), where without
    ``blocks`` it would be a block of its own contiguous rows."""
    first = next(iter(batch.values()))
    split = {shardings[k].sharded for k in batch}
    if len(split) > 1:
        raise ValueError("a batch's leaves must all split or all be "
                         "replicated")
    sharded = split.pop()
    rows = int(first.shape[0])
    if blocks == 1 or not sharded:
        return LocalBatch({k: shardings[k].shard(v)
                           for k, v in batch.items()},
                          global_rows=rows, sharded=sharded)
    if rows % blocks:
        raise ValueError(f"{rows} rows do not split into {blocks} blocks")

    def cut(v, sh):
        per = v.reshape((blocks, rows // blocks) + tuple(v.shape[1:]))
        mine = per[:, sh.rows(rows // blocks)]
        return mine.reshape((-1,) + tuple(v.shape[1:]))
    return LocalBatch({k: cut(v, shardings[k]) for k, v in batch.items()},
                      global_rows=rows, sharded=True, blocks=blocks)


# ------------------------------------------------------ tensor parallelism

# families whose params the port splits over a model axis above 1: the
# dense family and the moe family (expert parallelism), with GQA or MLA
# attention (split by heads), and LeNet (every spec replicated)
TP_FAMILIES = ("cnn", "dense", "moe")


def check_model_parallel(cfg, mesh) -> None:
    """Raise ``NotImplementedError`` where ``mesh``'s ``model`` axis has
    more than one rank and ``cfg`` is not of a family the port splits."""
    if mesh is None or mesh.shape.get("model", 1) == 1:
        return
    if cfg.family not in TP_FAMILIES:
        raise NotImplementedError(
            f"tensor parallelism over 'model' ({mesh.shape['model']} "
            f"ranks) is ported for the dense and moe families (GQA or "
            f"MLA attention); {cfg.name} ({cfg.family}) is ROADMAP.md "
            "queue 1 item 4b-ii, not yet ported to repro_torch")


def _model_only(spec: PartitionSpec) -> PartitionSpec:
    out = []
    for ax in spec:
        names = () if ax is None else (
            (ax,) if isinstance(ax, str) else tuple(ax))
        out.append("model" if "model" in names else None)
    return P(*out)


def model_pspecs(cfg, params_shapes: Pytree, mesh) -> Pytree:
    """:func:`param_pspecs` with only the ``model`` entries kept: the
    splits the port executes."""
    return _map_with_path(lambda p, s: _model_only(s),
                          param_pspecs(cfg, params_shapes, mesh))


def param_shardings(cfg, params_shapes: Pytree, mesh) -> Pytree:
    """One :class:`LeafSharding` a leaf of the WHOLE params'
    ``params_shapes`` (a meta init serves)."""
    return _map_with_path(lambda p, s: LeafSharding(mesh, s),
                          model_pspecs(cfg, params_shapes, mesh))


def scale_sharding(sh: LeafSharding, ndim: int) -> LeafSharding:
    """The sharding of a tree-state int8 scale beside a leaf of
    ``ndim`` dims sharded by ``sh``: one scale per leading index (split
    where dim 0 is), or a vector's own shape."""
    if ndim <= 1:
        return sh
    return LeafSharding(sh.mesh, P(sh.spec[0], *([None] * (ndim - 1))))


def shard_leaf(x, sh: LeafSharding):
    """This rank's block of a whole leaf, as a tensor of its own (the
    whole can be freed); a replicated leaf as it is."""
    return sh.shard(x).clone() if sh.split else x


def gather_leaf(x, sh: LeafSharding):
    """The whole leaf from this rank's block (a collective where the
    leaf is split)."""
    return sh.gather(x) if sh.split else x


def shard_params(tree: Pytree, shardings: Pytree) -> Pytree:
    return tree_map(shard_leaf, tree, shardings)


def gather_params(tree: Pytree, shardings: Pytree) -> Pytree:
    return tree_map(gather_leaf, tree, shardings)


# --------------------------------------------------------- the serving mesh

def serve_param_shardings(cfg, params_shapes: Pytree, mesh) -> Pytree:
    """One :class:`LeafSharding` a leaf of the whole params for serving:
    :func:`serve_param_pspecs`' ``model`` entries (it keeps no ``data``
    entry where the tensor-parallel footprint fits; where it does not,
    the port still holds params whole over ``data``, as in training)."""
    return _map_with_path(lambda p, s: LeafSharding(mesh, _model_only(s)),
                          serve_param_pspecs(cfg, params_shapes, mesh))


# cache leaves with a sequence axis (dim 2): K/V, the hybrid's shared
# block's K/V, MLA's latents
SEQ_LEAVES = ("k", "v", "attn_k", "attn_v", "ckv", "krope")


class Stripe(NamedTuple):
    """This rank's stripe of a decode cache's sequence axis: rows
    ``[index * rows, (index + 1) * rows)`` of the whole, the ``index``-th
    of ``count`` stripes split over ``axis`` of ``mesh`` (the axes whose
    ranks merge their partial attention)."""

    index: int
    count: int
    rows: int
    axis: Any
    mesh: Any


class LocalCache(dict):
    """This rank's leaves of a decode cache under a serving mesh: the
    dict the models read and write in place, its ``stripe`` (None
    where the rank holds the whole sequence) and ``data``: the mesh
    whose ``data`` axis splits its slots (None where the rank holds
    every slot)."""

    def __init__(self, items, *, stripe: Optional[Stripe] = None,
                 data=None):
        super().__init__(items)
        self.stripe = stripe
        self.data = data


class CacheSharding:
    """:func:`cache_pspecs` executed for one rank: ``specs`` (the
    reference's PartitionSpecs), ``shardings`` (a :class:`LeafSharding`
    a leaf), each leaf's local shape (:meth:`local_shape`), this data
    rank's block of the slots (``slot_block``, all of them where the
    slots are not split) and this rank's :class:`Stripe` (None where the
    sequence is whole: a capacity the stripes do not divide is
    replicated, as the reference's ``_divisible`` leaves it).

    ``shapes``: {leaf: whole shape} of the cache (``pos`` included)."""

    def __init__(self, cfg, mesh, shapes: dict, *, slots: int):
        import torch
        self.mesh = mesh
        self.whole = {k: tuple(v) for k, v in shapes.items()}
        meta = {k: torch.empty(v, device="meta")
                for k, v in self.whole.items()}
        self.specs = cache_pspecs(cfg, mesh, meta, batch=slots)
        self.shardings = tree_named(mesh, self.specs)
        self.slot_block = self.shardings["pos"].rows(slots)
        self.stripe: Optional[Stripe] = None
        for name in SEQ_LEAVES:
            if name in self.specs and self.shardings[name].parts[2] > 1:
                sh = self.shardings[name]
                self.stripe = Stripe(sh.index[2], sh.parts[2],
                                     self.whole[name][2] // sh.parts[2],
                                     sh.spec[2], mesh)
                break

    @property
    def slots_split(self) -> bool:
        """Whether the ranks of ``data`` hold different slots."""
        return self.shardings["pos"].parts[0] > 1

    def local_shape(self, name: str) -> tuple:
        sh = self.shardings[name]
        return tuple(n // (sh.parts[d] if d < len(sh.parts) else 1)
                     for d, n in enumerate(self.whole[name]))

