"""Continuous-batching serving over the block-paged KV cache.

Counterpart of ``repro.serve``: the engines (``engine``), the paged cache
manager (``kvcache``), the scheduler and the observability layer.
"""
from repro_torch.models.adapters import (
    prefix_compute_skippable,
    prefix_shareable,
    supported_families,
    unsupported_reason,
)
from repro_torch.serve.engine import (
    Engine,
    EngineConfig,
    ServeConfig,
    Server,
    bucket_tokens,
    make_requests,
    run_static_waves,
)
from repro_torch.serve.kvcache import (
    CacheAudit,
    PageAllocator,
    PagedCacheConfig,
    PagedKVCache,
    PrefixIndex,
)
from repro_torch.serve.obs import (
    MetricsRegistry,
    Observability,
    RequestStats,
    RequestTimeline,
    Span,
    build_serve_report,
    validate_chrome_trace,
)
from repro_torch.serve.scheduler import Request, Scheduler

__all__ = [
    "CacheAudit",
    "Engine",
    "EngineConfig",
    "MetricsRegistry",
    "Observability",
    "PageAllocator",
    "PagedCacheConfig",
    "PagedKVCache",
    "PrefixIndex",
    "Request",
    "RequestStats",
    "RequestTimeline",
    "Scheduler",
    "ServeConfig",
    "Server",
    "Span",
    "bucket_tokens",
    "build_serve_report",
    "make_requests",
    "prefix_compute_skippable",
    "prefix_shareable",
    "run_static_waves",
    "supported_families",
    "unsupported_reason",
    "validate_chrome_trace",
]
