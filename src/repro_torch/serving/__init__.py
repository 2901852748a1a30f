"""Serving subsystem: the dense-cache continuous-batching engine, the
adapter runtime and token sampling."""
from repro_torch.config.base import ServeConfig  # noqa: F401
from repro_torch.serving.adapter_runtime import AdapterRuntime  # noqa: F401
from repro_torch.serving.engine import (CANCELLED, FAILED,  # noqa: F401
                                        FINISHED, TIMEOUT, DecodeState,
                                        Engine, Request, RequestResult)
from repro_torch.serving.sampling import SamplingConfig, sample  # noqa: F401
from repro_torch.serving.stats import EngineStats  # noqa: F401
