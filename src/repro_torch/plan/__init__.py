"""Collective-schedule IR, builders and the torch.distributed executor."""
