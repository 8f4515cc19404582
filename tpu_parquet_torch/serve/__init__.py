"""tpu_parquet_torch.serve: the concurrent scan service and its caches.

The counterpart of ``tpu_parquet.serve``.  Many concurrent callers submit
scan requests (file set, projection, predicate) to one
:class:`ScanService`; requests run over SHARED state: a bounded
read-through :class:`PlanCache` of parsed footers, ScanPlans and decoded
dictionaries, and above it the two-tier :class:`ResultCache` of decoded
column chunks (host memory, ``TPQ_RESULT_CACHE_MB``, and the card's
memory, ``TPQ_RESULT_CACHE_HBM_MB``), so a repeated hot scan skips the
read, decompress and decode of what it already holds.  Admission control
(a bounded queue and an ``alloc.InFlightBudget``; a full queue refuses at
once with ``errors.OverloadError``), brownout shedding by priority,
per-file circuit breakers, fair-share tenants (:class:`FairScheduler`,
:class:`TenantRegistry`) and streaming sessions (:class:`StreamingScan`,
resumable from a ``b"TPQS"`` cursor) sit in front of the readers, with
per-request latency SLOs in the registry ``serve`` section.

``ScanService(device=)`` names where ``device=True`` requests decode
(``DeviceFileReader``, torch tensors) and device streams ship: ``cuda``
unless the caller names another; ``device="cpu"`` runs the kernels' plain
versions.  Both readers and ``device_reader.scan_files(plan_cache=)`` take
the caches directly too (``PlanCache.reader_kwargs``).
"""

from .cache import BoundDictCache, CacheStats, PlanCache
from .result_cache import (BoundResultCache, ResultCache, ResultTierStats,
                           decode_signature)
from .service import (PRIORITY_HIGH, PRIORITY_LOW, PRIORITY_NORMAL,
                      ScanRequest, ScanService, ScanTicket, ServeStats)
from .stream import (StreamingScan, check_cursor_compatible, pack_cursor,
                     request_digest, unpack_cursor)
from .tenancy import (DEFAULT_TENANT, FairScheduler, Tenant, TenantRegistry,
                      parse_tenant_spec)

__all__ = [
    "BoundDictCache", "BoundResultCache", "CacheStats", "DEFAULT_TENANT",
    "FairScheduler", "PlanCache",
    "PRIORITY_HIGH", "PRIORITY_LOW", "PRIORITY_NORMAL",
    "ResultCache", "ResultTierStats", "ScanRequest", "ScanService",
    "ScanTicket", "ServeStats", "StreamingScan", "Tenant", "TenantRegistry",
    "check_cursor_compatible", "decode_signature", "pack_cursor",
    "parse_tenant_spec", "request_digest", "unpack_cursor",
]
