"""Serving subsystem: the continuous-batching engine over a paged (default)
or dense KV cache, the adapter runtime, token sampling, and around them
the host machinery: block manager, prefix cache, scheduler, the paged
adapter registry (task columns through a fixed pool of device slots) and
the seeded chaos harness with its invariant audits."""
from repro_torch.config.base import (RegistryConfig,  # noqa: F401
                                     ServeConfig, SpecConfig)
from repro_torch.serving.adapter_registry import (AcquireResult,  # noqa: F401
                                                  AdapterRegistry)
from repro_torch.serving.adapter_runtime import AdapterRuntime  # noqa: F401
from repro_torch.serving.block_manager import (BlockManager,  # noqa: F401
                                               PrefixCache)
from repro_torch.serving.chaos import (ChaosInjector, audit,  # noqa: F401
                                       audit_pools)
from repro_torch.serving.engine import (CANCELLED, FAILED,  # noqa: F401
                                        FINISHED, TIMEOUT, DecodeState,
                                        Engine, PagedState, Request,
                                        RequestResult)
from repro_torch.serving.lru import LRUClock  # noqa: F401
from repro_torch.serving.sampling import SamplingConfig, sample  # noqa: F401
from repro_torch.serving.scheduler import Scheduler  # noqa: F401
from repro_torch.serving.stats import EngineStats  # noqa: F401
