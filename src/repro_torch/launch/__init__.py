"""Launch drivers of the port (``serve``) and its one-device mesh."""
