"""Geometry, brick layout, the CUDA kernels' wrappers, and rANS.

The package exports the JAX package's geometry names (``coords`` and
``octree``, plain torch).  The kernel modules are imported on use, and
nothing here builds or loads a kernel at import time (the CUDA libraries
are compiled on the first CUDA call)."""

from .coords import (
    COORD_BITS,
    KEY_PAD,
    canonical_sort,
    coord_key,
    key_to_coord,
    lookup,
    membership,
    sort_rows_by_key,
    unique_sorted,
)
from .octree import (
    CONV_OFFSETS_27,
    NEIGHBOR_OFFSETS_7,
    OCTANT_OFFSETS,
    conv_offsets,
    neighbor_feature_code,
    neighbor_map,
    neighbor_map_27,
    octree_down,
    octree_up,
)
