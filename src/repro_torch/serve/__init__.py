"""Serving runtime of the port: slot-paged persistent KV/SSM cache,
bounded request schedulers (FIFO and SLO-aware priority/preemption), the
prefix store's radix index, on-device sampling, the continuous-batching
engine (chunked prefill, prefix reuse, preemption) and the static-batch
``DecodeEngine`` (plus the prefill/serve step factories), and the
scenario library and its report."""

from repro_torch.serve.cache import SlotCache  # noqa: F401
from repro_torch.serve.engine import (DecodeEngine,  # noqa: F401
                                      ServeEngine, make_prefill_step,
                                      make_serve_step)
from repro_torch.serve.prefix import PrefixPool, RadixIndex  # noqa: F401
from repro_torch.serve.report import (SCENARIO_LIBRARY,  # noqa: F401
                                      ServeScenario, TrafficItem,
                                      bursty_tier_traffic,
                                      diurnal_tier_traffic,
                                      heavy_tail_tier_traffic,
                                      mixed_length_traffic, run_scenario,
                                      scenario_waves, shared_prefix_traffic,
                                      steady_tier_traffic,
                                      write_serve_report)
from repro_torch.serve.sampling import (SamplerConfig,  # noqa: F401
                                        parse_sampler, sample)
from repro_torch.serve.scheduler import (FinishedRequest,  # noqa: F401
                                         PriorityScheduler, QueueFull,
                                         Request, RequestScheduler, TierSLO)
