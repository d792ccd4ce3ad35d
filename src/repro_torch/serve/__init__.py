"""Personalized-delta serving (counterpart of ``repro/serve``)."""
from repro_torch.serve.deltas import (DeltaRecord, DeltaStore,  # noqa: F401
                                      delta_from_params, mask_index_map)
from repro_torch.serve.engine import DeltaOverlay, stack_tree  # noqa: F401
