"""Data and tensor parallelism over torch.distributed: one process a GPU."""
