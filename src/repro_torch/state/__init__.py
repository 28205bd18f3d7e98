"""Declared optimizer-state slots (replicated layout)."""
from repro_torch.state.slots import (SlotSpec, StateLayout, StateTree,
                                     ef_errs, init_rank_state, slot_length)

__all__ = ["SlotSpec", "StateLayout", "StateTree", "ef_errs",
           "init_rank_state", "slot_length"]
