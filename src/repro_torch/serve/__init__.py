from .checkout import BatchedCheckoutServer, CheckoutStats, RetryPolicy

__all__ = ["BatchedCheckoutServer", "CheckoutStats", "RetryPolicy"]
