"""The mean time of a batch's prompt checkout, from the submit of its
versions' tickets to the last row on the host (``BatchedCheckoutServer``,
the ``checkout_wave`` kernel), over every batch of the run: the window
and the queue served after it."""


def read(run):
    return run["spans"].mean_ms("checkout")
