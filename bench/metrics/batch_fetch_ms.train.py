"""The mean time of a step's batch: the next batch of the versioned
corpus (``VersionedDataset.batches``) and its upload to the card, over
every step of the window."""


def read(run):
    return run["spans"].mean_ms("fetch")
