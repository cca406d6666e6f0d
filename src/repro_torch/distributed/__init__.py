"""Distribution layer (port of ``repro/distributed``): logical sharding
rules per architecture family, the ambient-mesh constraints, and what a
spec means for one rank of a data-parallel mesh over ``torch.distributed``
(:mod:`repro_torch.distributed.collectives` holds the step's
collectives)."""

from repro_torch.distributed.sharding import (param_pspecs,  # noqa: F401
                                              batch_pspecs, cache_pspecs,
                                              state_pspecs, named,
                                              tree_named)
