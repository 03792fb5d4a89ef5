"""Sharding over torch.distributed ranks: the mesh, the sharded renders and gradients, and the multi-process dry run."""
