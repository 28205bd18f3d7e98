"""Declared optimizer-state slots and their canonical EF layout.  The
checkpoint layer built on them is ``repro_torch.state.checkpoint`` (not
imported here: it imports ``repro_torch.convert``, which imports the
slots)."""
from repro_torch.state.slots import (CHUNK_DIVISORS, EXTENTS, REPLICATIONS,
                                     SlotSpec, StateLayout, StateTree,
                                     ef_errs, flat_layout, global_shapes,
                                     init_global_state, init_rank_state,
                                     rank_shapes, slot_length, state_bytes,
                                     state_specs)
from repro_torch.state.layout import (bucket_sizes_for, canonicalize_state,
                                      ef_element_map, ef_slot_perm,
                                      from_canonical, layout_manifest,
                                      manifest_json, to_canonical)

__all__ = [
    "CHUNK_DIVISORS", "EXTENTS", "REPLICATIONS", "SlotSpec", "StateLayout",
    "StateTree", "bucket_sizes_for", "canonicalize_state", "ef_element_map",
    "ef_errs", "ef_slot_perm", "flat_layout", "from_canonical",
    "global_shapes", "init_global_state", "init_rank_state",
    "layout_manifest", "manifest_json", "rank_shapes", "slot_length",
    "state_bytes", "state_specs", "to_canonical",
]
