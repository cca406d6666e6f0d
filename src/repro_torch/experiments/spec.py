"""Declarative experiment grids for the paper's LARS-vs-SGD study and
its LM-family extension: the port's copy of ``repro/experiments/spec.py``
(pure Python; the same grids, cell ids, cell seeds and fingerprints).

A :class:`GridSpec` is the full experimental protocol as data: the axes
(optimizer x global batch x precision x accum_steps x lr-policy x
lr-schedule x seed), the shared tuning budget (one set of
hyperparameters for every cell — the controlled-comparison discipline of
Nado et al., 2102.06356), the dataset sizes, and the epoch budget.
``cells()`` expands the product into :class:`CellSpec` rows in a
deterministic order, and every cell derives its OWN rng seed from a
stable hash of its coordinates (CRC32 of the same key string as the
reference), so

* two runs of the same grid are bit-reproducible cell by cell;
* adding a batch size to the grid does not reshuffle the seeds of the
  cells that were already there.

Two families are declared (``family="cnn"``: the paper's LeNet/MNIST
study, metric test accuracy; ``family="lm"``: token-LM cells, metric
eval perplexity); the port's runner takes the cnn family. The
``lr_schedule`` axis (``inverse_time`` — paper Table 1; ``poly``;
``poly_warmup`` — the You et al. warmup + polynomial decay) threads
:func:`repro_torch.core.schedules.large_batch_lr` through cells.

One deliberate difference from the reference: :attr:`GridSpec.
report_file` names ``EXPERIMENTS_torch_<study>.json``, so a run of the
port never overwrites the reference's committed reports.
"""

from __future__ import annotations

import dataclasses
import itertools
import zlib
from typing import Optional

# Paper Table 1 defaults (shared by every cell of every named grid).
INIT_LR = 0.01
LR_DECAY = 1e-4
WEIGHT_DECAY = 1e-4
MOMENTUM = 0.9
TRUST_COEF = 0.001
# Adam-family cells (lamb/adamw) run their own base LR: one momentum-SGD
# LR for Adam-style direction updates would leave half the grid
# untrained and the comparison vacuous (the Nado et al. point — each
# optimizer family gets a tuned base, the SCHEDULE and scaling policy
# stay shared).
ADAM_INIT_LR = 0.01

LR_SCHEDULES = ("inverse_time", "poly", "poly_warmup")


@dataclasses.dataclass(frozen=True)
class CellSpec:
    """One point of the experiment grid (fully self-describing)."""

    grid: str
    arch: str
    optimizer: str           # "sgd" | "lars" | "lamb" | "adamw"
    batch: int               # GLOBAL batch size
    accum_steps: int         # microbatches accumulated per update
    precision: str           # "f32" | "bf16"
    lr_policy: str           # batch-size LR scaling: none | linear | sqrt
    base_lr: float
    base_batch: int
    epochs: int
    n_train: int
    seed: int                # replicate id (the grid's seeds axis)
    momentum: float = MOMENTUM
    weight_decay: float = WEIGHT_DECAY
    trust_coef: float = TRUST_COEF
    lr_decay: float = LR_DECAY
    # --- LR schedule shape (the warmup-ablation axis) ---
    lr_schedule: str = "inverse_time"   # inverse_time | poly | poly_warmup
    warmup_frac: float = 0.1            # fraction of steps warmed up
    adam_base_lr: float = ADAM_INIT_LR  # lamb/adamw base LR
    # optimizer-state storage dtype ("f32" | "int8"): int8 stores the
    # momentum/moment slots as int8 codes + per-group f32 scales — the
    # int8-vs-f32 parity axis of the quantized-state study
    opt_state_dtype: str = "f32"
    # per-optimizer base-LR overrides ((name, lr) pairs): trust-ratio
    # optimizers take RELATIVE per-layer steps, so one base can't serve
    # both them and their generic counterparts — each optimizer gets a
    # tuned base, the schedule and scaling policy stay shared
    base_lr_overrides: tuple = ()
    # --- family + LM model/data coordinates (family="cnn": unused) ---
    family: str = "cnn"                 # "cnn" | "lm"
    seq_len: int = 0                    # LM: training sequence length
    vocab_size: int = 0                 # LM: data + reduced-model vocab
    model_layers: int = 0               # LM: reduced() max_layers
    model_d_model: int = 0              # LM: reduced() max_d_model
    # --- execution placement (the ZeRO study's axis) ---
    # device mesh the cell's TrainPipeline runs under, as a
    # launch.mesh.mesh_from_spec string ("" = no mesh / single device;
    # "8x1" = 8-way data parallel; "auto" = all local devices)
    mesh: str = ""
    # ZeRO: row-shard the packed optimizer slots across the mesh's data
    # axis (requires mesh). Excluded from cell_seed like the
    # lr_schedule-family tags, so a zero cell shares init + data stream
    # with its replicated twin and placement is the ONLY varying
    # ingredient.
    zero: bool = False
    # --- PBT mutable-hyperparam coordinates (experiments/controller) ---
    # The population controller tunes the family base LR and the trust
    # coefficient MID-RUN: a mutation sets mut_base_lr / mut_trust_coef
    # (0.0 = unset, the grid's static values apply) and bumps
    # ``generation``. All three are lineage tags — cell_id carries the
    # generation suffix so mutated rows are distinguishable, cell_seed
    # EXCLUDES them (a mutated cell continues its lineage's init + data
    # stream; the hyperparameters are the only varying ingredient).
    generation: int = 0
    mut_base_lr: float = 0.0
    mut_trust_coef: float = 0.0

    @property
    def lineage_root(self) -> str:
        """The cell id WITHOUT the PBT generation suffix — the stable
        run-directory key a population member keeps across mutations."""
        base = (f"{self.optimizer}-b{self.batch}-{self.precision}"
                f"-a{self.accum_steps}-{self.lr_policy}-s{self.seed}")
        if self.lr_schedule != "inverse_time":
            base += f"-{self.lr_schedule}"
        if self.opt_state_dtype != "f32":
            base += f"-{self.opt_state_dtype}"
        if self.mesh:
            base += f"-m{self.mesh}"
        if self.zero:
            base += "-zero"
        return base

    @property
    def cell_id(self) -> str:
        """Stable directory/manifest key, e.g. ``lars-b2048-f32-a1-none-s0``
        (non-default lr schedules append their tag so ablation cells get
        distinct directories; PBT lineages append their generation)."""
        base = self.lineage_root
        if self.generation:
            base += f"-g{self.generation}"
        return base

    def cell_seed(self) -> int:
        """Deterministic rng seed from the cell's coordinates (CRC32 of
        the id string — stable across processes and grid edits, unlike
        Python's salted ``hash``). The lr-schedule, opt-state-dtype and
        mesh/zero placement tags are deliberately EXCLUDED:
        warmup-ablation cells share init + data stream so the schedule
        is the only varying ingredient, int8-vs-f32 parity cells
        likewise differ ONLY in the slot storage dtype, and a
        ZeRO-sharded cell trains the same trajectory as its replicated
        twin (placement must not change the numbers it is compared
        against)."""
        key = (f"{self.grid}/{self.optimizer}-b{self.batch}"
               f"-{self.precision}-a{self.accum_steps}-{self.lr_policy}"
               f"-s{self.seed}")
        return zlib.crc32(key.encode()) & 0x7FFFFFFF

    @property
    def steps(self) -> int:
        """Fixed-epoch budget (paper protocol): steps shrink as the
        batch grows — the large-batch regime the study probes."""
        import math
        return max(1, math.ceil(self.epochs * self.n_train / self.batch))

    @property
    def cell_base_lr(self) -> float:
        """The optimizer-family base LR this cell scales from. A PBT
        mutation (mut_base_lr > 0) overrides every static source."""
        if self.mut_base_lr:
            return float(self.mut_base_lr)
        for name, lr in self.base_lr_overrides:
            if name == self.optimizer:
                return float(lr)
        if self.optimizer in ("lamb", "adamw"):
            return self.adam_base_lr
        return self.base_lr

    @property
    def cell_trust_coef(self) -> float:
        """The effective trust coefficient (PBT mutation wins)."""
        return float(self.mut_trust_coef or self.trust_coef)

    def perturbed(self, *, base_lr: float,
                  trust_coef: Optional[float] = None) -> "CellSpec":
        """The next generation of this lineage: explicit mutated
        hyperparameters, generation bumped. Seed-relevant coordinates
        are untouched, so the mutant continues the same data stream."""
        return dataclasses.replace(
            self, generation=self.generation + 1,
            mut_base_lr=float(base_lr),
            mut_trust_coef=(float(trust_coef) if trust_coef is not None
                            else self.mut_trust_coef))

    def make_lr_schedule(self):
        """The cell's LR schedule: batch-size scaling of the family base
        LR under the grid's lr_policy, shaped by the lr_schedule axis.
        ``poly``/``poly_warmup`` go through
        :func:`repro_torch.core.schedules.large_batch_lr` (the You et al.
        warmup + poly-decay recipe); ``inverse_time`` is paper Table 1.
        """
        from repro_torch.core import schedules
        from repro_torch.core.scaling import scaled_lr
        if self.lr_schedule == "inverse_time":
            lr0 = scaled_lr(self.cell_base_lr, self.base_batch, self.batch,
                            self.lr_policy)
            return schedules.inverse_time_decay(lr0, self.lr_decay)
        if self.lr_schedule not in LR_SCHEDULES:
            raise ValueError(f"unknown lr_schedule {self.lr_schedule!r}; "
                             f"have {LR_SCHEDULES}")
        warmup = 0
        if self.lr_schedule == "poly_warmup":
            warmup = max(1, round(self.warmup_frac * self.steps))
        return schedules.large_batch_lr(
            self.cell_base_lr, self.base_batch, self.batch, self.steps,
            warmup_steps=warmup, policy=self.lr_policy)

    def build_optimizer(self):
        """The cell's optimizer with its scheduled LR."""
        from repro_torch.core import get_optimizer
        lr = self.make_lr_schedule()
        if self.optimizer == "sgd":
            return get_optimizer("sgd", learning_rate=lr,
                                 momentum=self.momentum,
                                 weight_decay=self.weight_decay,
                                 slot_dtype=self.opt_state_dtype)
        if self.optimizer == "lars":
            return get_optimizer("lars", learning_rate=lr,
                                 momentum=self.momentum,
                                 weight_decay=self.weight_decay,
                                 trust_coefficient=self.cell_trust_coef,
                                 slot_dtype=self.opt_state_dtype)
        if self.optimizer == "lamb":
            return get_optimizer("lamb", learning_rate=lr,
                                 weight_decay=self.weight_decay,
                                 slot_dtype=self.opt_state_dtype)
        if self.optimizer == "adamw":
            return get_optimizer("adamw", learning_rate=lr,
                                 weight_decay=self.weight_decay,
                                 slot_dtype=self.opt_state_dtype)
        raise ValueError(f"unknown optimizer {self.optimizer!r}")

    def pipeline_key(self) -> tuple:
        """Cells with equal keys share one TrainPipeline (and therefore
        its compiled step): everything that shapes the traced function
        except the replicate seed."""
        return (self.arch, self.optimizer, self.batch, self.accum_steps,
                self.precision, self.lr_policy, self.base_lr,
                self.base_batch, self.momentum, self.weight_decay,
                self.trust_coef, self.lr_decay, self.lr_schedule,
                self.warmup_frac, self.adam_base_lr, self.opt_state_dtype,
                tuple(map(tuple, self.base_lr_overrides)), self.family,
                self.seq_len, self.vocab_size, self.model_layers,
                self.model_d_model, self.epochs, self.n_train,
                self.mesh, self.zero,
                # mutated hypers are traced constants (the LR schedule
                # closure, the trust coefficient) — a mutant needs its
                # own compiled step
                self.mut_base_lr, self.mut_trust_coef)

    def to_json(self) -> dict:
        """JSON-normalized (tuples -> lists) so in-memory manifest rows
        compare equal to rows loaded back from disk."""
        import json
        return json.loads(json.dumps(dataclasses.asdict(self)))


def cell_from_json(row: dict) -> CellSpec:
    """Rebuild a :class:`CellSpec` from its ``to_json`` form (the PBT
    controller persists mutated cells in its manifest and reconstructs
    them on resume). Extra row keys (metrics) are ignored; list-encoded
    tuples are restored."""
    fields = {f.name for f in dataclasses.fields(CellSpec)}
    kw = {k: v for k, v in row.items() if k in fields}
    kw["base_lr_overrides"] = tuple(
        tuple(p) for p in kw.get("base_lr_overrides", ()))
    return CellSpec(**kw)


@dataclasses.dataclass(frozen=True)
class GridSpec:
    """An experiment = axes x shared protocol. Immutable and hashable so
    runs can be fingerprinted for resume validation."""

    name: str
    arch: str = "lenet-mnist"
    family: str = "cnn"                 # "cnn" | "lm"
    optimizers: tuple[str, ...] = ("sgd", "lars")
    batches: tuple[int, ...] = (32, 512, 4096)
    precisions: tuple[str, ...] = ("f32",)
    accum_steps: tuple[int, ...] = (1,)
    lr_policies: tuple[str, ...] = ("none",)
    lr_schedules: tuple[str, ...] = ("inverse_time",)
    seeds: tuple[int, ...] = (0,)
    epochs: int = 20
    n_train: int = 8192
    n_test: int = 2048
    data_seed: int = 0
    base_lr: float = INIT_LR
    base_batch: int = 32
    momentum: float = MOMENTUM
    weight_decay: float = WEIGHT_DECAY
    trust_coef: float = TRUST_COEF
    lr_decay: float = LR_DECAY
    warmup_frac: float = 0.1
    adam_base_lr: float = ADAM_INIT_LR
    # optimizer-state storage dtypes to sweep (int8-vs-f32 parity axis)
    opt_state_dtypes: tuple[str, ...] = ("f32",)
    base_lr_overrides: tuple = ()       # ((optimizer, base_lr), ...)
    # execution placement, shared by every cell (protocol-level, not a
    # swept axis): mesh spec string + ZeRO optimizer-state sharding
    mesh: str = ""
    zero: bool = False
    # --- LM-family protocol (family="lm" only) ---
    seq_len: int = 0                    # training sequence length
    vocab_size: int = 0                 # synthetic-corpus + model vocab
    model_layers: int = 0               # reduced() max_layers (0 = default)
    model_d_model: int = 0              # reduced() max_d_model (0 = default)
    # report file this grid writes its aggregated study to. Variants of
    # one study (e.g. lm_smoke and the full lm_lars_vs_lamb) share the
    # path — each run REPLACES the file with its own cells (most recent
    # run wins; reports are not merged across grids, and each payload
    # records its grid fingerprint). "" = EXPERIMENTS_<name>.json;
    # report_file puts "torch_" after the "EXPERIMENTS_" prefix
    report_name: str = ""

    def cells(self) -> list[CellSpec]:
        """Deterministic row-major expansion: batch-major (so the sweep
        prints as the paper's tables read), then optimizer, precision,
        accumulation, lr-policy, lr-schedule, seed."""
        if self.family not in ("cnn", "lm"):
            raise ValueError(f"grid {self.name!r}: unknown family "
                             f"{self.family!r} (have cnn, lm)")
        if self.family == "lm" and self.seq_len <= 0:
            raise ValueError(
                f"grid {self.name!r}: family='lm' requires seq_len > 0")
        if self.zero and not self.mesh:
            raise ValueError(
                f"grid {self.name!r}: zero=True requires a mesh spec "
                "(the optimizer slots shard across its data axis)")
        out = []
        for batch, opt, prec, accum, policy, sched, sdtype, seed in \
                itertools.product(
                    self.batches, self.optimizers, self.precisions,
                    self.accum_steps, self.lr_policies, self.lr_schedules,
                    self.opt_state_dtypes, self.seeds):
            if batch % accum:
                raise ValueError(
                    f"grid {self.name!r}: batch {batch} not divisible by "
                    f"accum_steps {accum}")
            out.append(CellSpec(
                grid=self.name, arch=self.arch, optimizer=opt, batch=batch,
                accum_steps=accum, precision=prec, lr_policy=policy,
                base_lr=self.base_lr, base_batch=self.base_batch,
                epochs=self.epochs, n_train=self.n_train, seed=seed,
                momentum=self.momentum, weight_decay=self.weight_decay,
                trust_coef=self.trust_coef, lr_decay=self.lr_decay,
                lr_schedule=sched, warmup_frac=self.warmup_frac,
                adam_base_lr=self.adam_base_lr, opt_state_dtype=sdtype,
                base_lr_overrides=tuple(map(tuple,
                                            self.base_lr_overrides)),
                family=self.family,
                seq_len=self.seq_len, vocab_size=self.vocab_size,
                model_layers=self.model_layers,
                model_d_model=self.model_d_model,
                mesh=self.mesh, zero=self.zero))
        return out

    @property
    def report_file(self) -> str:
        """Default aggregated-report path for this grid's study: the
        reference's name with ``torch_`` after its ``EXPERIMENTS_``
        prefix, so the reference's reports stay its own."""
        name = self.report_name or f"EXPERIMENTS_{self.name}.json"
        prefix = "EXPERIMENTS_"
        if name.startswith(prefix):
            return f"{prefix}torch_{name[len(prefix):]}"
        return f"torch_{name}"

    def fingerprint(self) -> dict:
        """JSON-able identity of the protocol; ``--resume`` refuses to
        continue a run directory whose manifest disagrees. Normalized
        through a JSON round-trip so it compares equal to a manifest
        loaded from disk (tuples -> lists)."""
        import json
        return json.loads(json.dumps(dataclasses.asdict(self)))

    def find_cell(self, cell_id: str) -> CellSpec:
        for cell in self.cells():
            if cell.cell_id == cell_id:
                return cell
        raise KeyError(
            f"no cell {cell_id!r} in grid {self.name!r}; have "
            f"{[c.cell_id for c in self.cells()]}")


# ------------------------------------------------------------- registry

# The registered CNN grids run the LARGE-BATCH RECIPE — linear LR scaling
# from (base_lr, base_batch), identical for both optimizers (same tuning
# budget; the only differing ingredient is the trust ratio, which IS the
# claim under test). Under linear scaling the large-batch LR is where
# fixed-rate SGD destabilizes and LARS's layer-wise tempering holds —
# the separation the paper's Figs. 2-4 report. The trust coefficient is
# raised from Table 1's 0.001 to 0.02: the procedural-MNIST stand-in at
# CI scale has far fewer total updates than the paper's MNIST runs, and
# 0.001 leaves LARS undertrained everywhere (tuned on the smoke grid;
# both registered grids share the value so results stay comparable).
#
# The LM grids run the paper's §6 future work — the LAMB column through
# the exact same protocol: sqrt LR scaling (the You et al. policy for
# trust-ratio optimizers), the warmup + poly-decay schedule, reduced
# smollm on the seeded synthetic Markov corpus, eval perplexity as the
# metric. Both LM grids report into EXPERIMENTS_lm_lars_vs_lamb.json.
GRIDS: dict[str, GridSpec] = {
    # The paper's study (Figs. 2-4): fixed hyperparameters, fixed epoch
    # budget, batch scaled until SGD and LARS separate.
    "lars_vs_sgd": GridSpec(
        name="lars_vs_sgd",
        batches=(32, 128, 512, 1024, 2048, 4096, 8192),
        lr_policies=("linear",), trust_coef=0.02,
        epochs=20, n_train=8192, n_test=2048),
    # CI-sized 2x2 smoke grid: one small and one large batch. Minutes on
    # CPU; the claim check (LARS >= SGD test accuracy at the largest
    # batch) must already be visible here.
    "lars_vs_sgd_smoke": GridSpec(
        name="lars_vs_sgd_smoke",
        batches=(64, 1024),
        lr_policies=("linear",), trust_coef=0.02,
        epochs=8, n_train=2048, n_test=512),
    # The smoke grid under the large-batch execution pipeline: same
    # cells, global batch split into 4 accumulated microbatches with
    # bf16 compute + f32 master weights.
    "lars_vs_sgd_accum_bf16": GridSpec(
        name="lars_vs_sgd_accum_bf16",
        batches=(64, 1024),
        precisions=("bf16",), accum_steps=(4,),
        lr_policies=("linear",), trust_coef=0.02,
        epochs=8, n_train=2048, n_test=512),
    # Int8-optimizer-state parity smoke: the accum+bf16 smoke cells run
    # twice, once with f32 slots and once with int8 codes + per-group
    # scales — same seeds, same data stream (opt_state_dtype is excluded
    # from cell_seed), so the slot storage dtype is the ONLY varying
    # ingredient. The claim check asserts int8 final test accuracy stays
    # within noise of its f32 twin for every optimizer x batch.
    "int8_parity_smoke": GridSpec(
        name="int8_parity_smoke",
        batches=(64, 1024),
        precisions=("bf16",), accum_steps=(4,),
        lr_policies=("linear",), trust_coef=0.02,
        opt_state_dtypes=("f32", "int8"),
        epochs=8, n_train=2048, n_test=512),
    # The smoke cells under ZeRO: an (8, 1) data-parallel mesh with the
    # packed optimizer slots row-sharded across it. mesh/zero are
    # excluded from cell_seed, so these cells share init + data with
    # lars_vs_sgd_smoke and the claim check (LARS >= SGD at the large
    # batch) must reproduce under sharded state. Runs in nightly under
    # 8 forced host devices.
    "zero_smoke": GridSpec(
        name="zero_smoke",
        batches=(64, 1024),
        lr_policies=("linear",), trust_coef=0.02,
        epochs=8, n_train=2048, n_test=512,
        mesh="8x1", zero=True),
    # The population-based-training smoke study (experiments/controller):
    # LARS and SGD POPULATIONS at the large batch — 4 members per
    # optimizer (the seeds axis = member slots), each initialized with a
    # controller-jittered base LR / trust coefficient around the grid
    # values, then tuned mid-run by exploit/explore over the shared
    # mid-cell checkpoint machinery. Answers the Nado et al. question at
    # a fraction of full-grid cost: does TUNED SGD close the b1024 gap
    # to LARS that the static grid shows? The pbt report block merges
    # into the lars_vs_sgd study file next to the static-grid claims.
    "pbt_smoke": GridSpec(
        name="pbt_smoke",
        batches=(1024,),
        lr_policies=("linear",), trust_coef=0.02,
        seeds=(0, 1, 2, 3),
        epochs=8, n_train=2048, n_test=512,
        report_name="EXPERIMENTS_lars_vs_sgd.json"),
    # The warmup ablation as grid cells (ROADMAP item): the large-batch
    # SGD cell with and without linear warmup under poly decay, LARS
    # alongside — does warmup rescue the scaled-LR collapse?
    "warmup_ablation": GridSpec(
        name="warmup_ablation",
        batches=(1024,), lr_policies=("linear",),
        lr_schedules=("poly", "poly_warmup"), warmup_frac=0.25,
        trust_coef=0.02, epochs=8, n_train=2048, n_test=512),
    # CI-sized token-LM smoke grid: all four optimizer columns x one
    # small and one large batch on a 2-layer reduced smollm — the
    # perplexity-vs-batch table covering lamb/adamw/lars/sgd that the
    # LM study's claim checks read. ~6 min on CPU. Base LRs were tuned
    # per optimizer AT THE SMALL BATCH (the paper's Table-1 discipline:
    # tune once, then scale), schedule and sqrt scaling shared: sgd 0.3,
    # lars 1.0, lamb 0.1, adamw 0.01 — trust-ratio optimizers take
    # relative per-layer steps, so their bases sit 1-2 orders above
    # their generic counterparts by construction. The 2-epoch budget is
    # the smallest at which the large-batch cells (32 steps) clear seed
    # noise: at 1 epoch / 16 steps the lamb-vs-adamw ordering flips
    # between seeds.
    "lm_smoke": GridSpec(
        name="lm_smoke", arch="smollm-135m", family="lm",
        optimizers=("lamb", "adamw", "lars", "sgd"),
        batches=(16, 128),
        lr_policies=("sqrt",), lr_schedules=("poly_warmup",),
        warmup_frac=0.1, base_lr=0.3, base_batch=16, adam_base_lr=0.01,
        base_lr_overrides=(("lars", 1.0), ("lamb", 0.1)),
        trust_coef=0.02, weight_decay=1e-4,
        epochs=2, n_train=2048, n_test=256,
        seq_len=32, vocab_size=256, model_layers=2, model_d_model=128,
        report_name="EXPERIMENTS_lm_lars_vs_lamb.json"),
    # The full LM study: LARS/LAMB vs their non-layer-wise counterparts
    # across a batch sweep at fixed epoch budget — the LAMB column run
    # under the paper's exact protocol (its stated §6 future work).
    # Same per-optimizer bases as the smoke grid (tuned at b16).
    "lm_lars_vs_lamb": GridSpec(
        name="lm_lars_vs_lamb", arch="smollm-135m", family="lm",
        optimizers=("lamb", "adamw", "lars", "sgd"),
        batches=(16, 64, 256, 1024),
        lr_policies=("sqrt",), lr_schedules=("poly_warmup",),
        warmup_frac=0.1, base_lr=0.3, base_batch=16, adam_base_lr=0.01,
        base_lr_overrides=(("lars", 1.0), ("lamb", 0.1)),
        trust_coef=0.02, weight_decay=1e-4,
        epochs=4, n_train=8192, n_test=512,
        seq_len=64, vocab_size=512, model_layers=2, model_d_model=192,
        report_name="EXPERIMENTS_lm_lars_vs_lamb.json"),
}


def get_grid(name: str, **overrides) -> GridSpec:
    if name not in GRIDS:
        raise KeyError(f"unknown grid {name!r}; have {sorted(GRIDS)}")
    grid = GRIDS[name]
    if overrides:
        grid = dataclasses.replace(grid, **overrides)
    return grid
