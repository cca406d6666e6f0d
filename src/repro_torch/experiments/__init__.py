"""Paper-reproduction experiment harness of the port (cnn and lm
families; mesh and ZeRO cells on the ranks of a ``torch.distributed``
process group):

* :mod:`repro_torch.experiments.spec`   — grids as data, deterministic
  per-cell seeding, the named registry (the reference's, verbatim);
* :mod:`repro_torch.experiments.runner` — cells through TrainPipeline
  with per-layer trust-ratio telemetry, and mid-grid/mid-cell resume via
  npz checkpoints;
* :mod:`repro_torch.experiments.record` — streamed JSONL trajectories
  (strict JSON: non-finite -> null + a ``diverged`` flag);
* :mod:`repro_torch.experiments.report` — accuracy-vs-batch aggregation
  + the study's claim checks (``EXPERIMENTS_torch_<study>.json``), and
  the PBT block;
* :mod:`repro_torch.experiments.controller` — population-based training
  over a grid's cells (kill, early-stop, exploit/explore), resumable
  through its ``pbt.json`` manifest;
* :mod:`repro_torch.experiments.serve_grid` — the serve-side SLO sweep
  (scenario x scheduler x slots x sampler ->
  ``EXPERIMENTS_torch_serve.json``).

Mesh and ZeRO cells (``zero_smoke``) train on a data-parallel mesh over
the process group's ranks; only rank 0 writes (see the runner).
"""

from repro_torch.experiments.spec import (CellSpec, GridSpec,  # noqa: F401
                                          GRIDS, cell_from_json, get_grid)
from repro_torch.experiments.runner import GridRunner  # noqa: F401
from repro_torch.experiments.record import (TrajectoryRecorder,  # noqa: F401
                                            read_trajectory)
from repro_torch.experiments.report import (aggregate,  # noqa: F401
                                            format_table, pbt_section,
                                            write_pbt_report, write_report)
from repro_torch.experiments.controller import (  # noqa: F401
    PopulationController)
from repro_torch.experiments.serve_grid import (  # noqa: F401
    SERVE_GRIDS, ServeCellSpec, ServeGridSpec, get_serve_grid,
    run_serve_grid)
