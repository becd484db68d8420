"""Host-side paged KV-cache bookkeeping (numpy only)."""
from repro_torch.cache.paged import (AdmitPlan, BlockPool, BlockTable,
                                     ConcurrentPeakTracker, PagedCacheManager,
                                     PoolExhausted)

__all__ = ["AdmitPlan", "BlockPool", "BlockTable", "ConcurrentPeakTracker",
           "PagedCacheManager", "PoolExhausted"]
