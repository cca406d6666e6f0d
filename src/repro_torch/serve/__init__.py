"""Serving runtime of the port: slot-paged persistent KV cache, the
bounded FIFO request scheduler, on-device sampling, and the
continuous-batching engine (plus the prefill/serve step factories)."""

from repro_torch.serve.cache import SlotCache  # noqa: F401
from repro_torch.serve.engine import (ServeEngine,  # noqa: F401
                                      make_prefill_step, make_serve_step)
from repro_torch.serve.sampling import (SamplerConfig,  # noqa: F401
                                        parse_sampler, sample)
from repro_torch.serve.scheduler import (FinishedRequest,  # noqa: F401
                                         QueueFull, Request,
                                         RequestScheduler)
