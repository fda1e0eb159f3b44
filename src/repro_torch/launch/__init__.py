"""Launch drivers of the port (``serve``, ``train``, ``dryrun``) and its
mesh over ``torch.distributed``."""
