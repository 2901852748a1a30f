"""Serve-time tensor parallelism over a ``torch.distributed`` process
group (``rules.py``). Parameter placement, FSDP and the data-parallel
context are not ported yet."""
from repro_torch.sharding.rules import (  # noqa: F401
    get_serve_rp,
    get_serve_tp,
    serve_cache_stripe,
    serve_psum,
    serve_tp,
    serve_tp_gather,
    serve_tp_slice,
)
