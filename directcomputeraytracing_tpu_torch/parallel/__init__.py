"""Distribution over the ranks of a torch.distributed process group."""
