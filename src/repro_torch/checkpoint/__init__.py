"""npz pytree checkpoints in the reference's archive format."""
from repro_torch.checkpoint.io import (flatten_with_keys,  # noqa: F401
                                       load_meta, load_pytree, save_pytree)
