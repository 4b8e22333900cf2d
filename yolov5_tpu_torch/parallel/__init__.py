"""Data-parallel training over several processes (``torch.distributed``)."""
