"""Serving runtime of the port: slot-paged persistent KV cache, the
bounded FIFO request scheduler, on-device sampling, the
continuous-batching engine and the static-batch ``DecodeEngine`` (plus
the prefill/serve step factories)."""

from repro_torch.serve.cache import SlotCache  # noqa: F401
from repro_torch.serve.engine import (DecodeEngine,  # noqa: F401
                                      ServeEngine, make_prefill_step,
                                      make_serve_step)
from repro_torch.serve.sampling import (SamplerConfig,  # noqa: F401
                                        parse_sampler, sample)
from repro_torch.serve.scheduler import (FinishedRequest,  # noqa: F401
                                         QueueFull, Request,
                                         RequestScheduler)
