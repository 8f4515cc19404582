"""tpu_parquet_torch.serve: the read caches repeated scans run on.

The counterpart of ``tpu_parquet.serve``, cut to its caches: a bounded
read-through :class:`PlanCache` of parsed footers, ScanPlans and decoded
dictionaries, and above it the two-tier :class:`ResultCache` of decoded
column chunks (host memory, ``TPQ_RESULT_CACHE_MB``, and the card's
memory, ``TPQ_RESULT_CACHE_HBM_MB``), so a repeated scan skips the read,
decompress and decode of what it already holds.  Both readers take them
(``dict_cache=``, ``result_cache=``; ``PlanCache.reader_kwargs`` builds
the arguments), and so does ``device_reader.scan_files(plan_cache=)``.

Left out of the reference: the scan service, streaming scans and tenancy
(``service``, ``stream``, ``tenancy``).
"""

from .cache import BoundDictCache, CacheStats, PlanCache
from .result_cache import (BoundResultCache, ResultCache, ResultTierStats,
                           decode_signature)

__all__ = [
    "BoundDictCache", "BoundResultCache", "CacheStats", "PlanCache",
    "ResultCache", "ResultTierStats", "decode_signature",
]
