from .checkout import BatchedCheckoutServer, CheckoutStats, RetryPolicy
from .tenancy import (MultiTenantServer, Overloaded, QuotaExceeded,
                      TenantQuota, TenantStats, jain_index)

__all__ = ["BatchedCheckoutServer", "CheckoutStats", "RetryPolicy",
           "MultiTenantServer", "Overloaded", "QuotaExceeded",
           "TenantQuota", "TenantStats", "jain_index"]
