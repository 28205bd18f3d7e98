"""Synthetic data stream of the port."""
from repro_torch.data.synthetic import SyntheticStream, make_batch

__all__ = ["SyntheticStream", "make_batch"]
