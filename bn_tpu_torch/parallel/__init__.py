"""Multi-card scaling of the port on torch.distributed (dist.py)."""
