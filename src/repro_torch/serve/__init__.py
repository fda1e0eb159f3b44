from .checkout import BatchedCheckoutServer, CheckoutStats, RetryPolicy
from .kvcache import (PagedConfig, append, fork, gather_kv, init_pool,
                      pool_stats, release)
from .tenancy import (MultiTenantServer, Overloaded, QuotaExceeded,
                      TenantQuota, TenantStats, jain_index)

__all__ = ["BatchedCheckoutServer", "CheckoutStats", "RetryPolicy",
           "MultiTenantServer", "Overloaded", "QuotaExceeded",
           "TenantQuota", "TenantStats", "jain_index",
           "PagedConfig", "append", "fork", "gather_kv", "init_pool",
           "pool_stats", "release"]
