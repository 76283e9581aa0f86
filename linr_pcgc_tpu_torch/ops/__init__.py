"""Geometry, brick layout, the two CUDA kernels' wrappers, and rANS.

Submodules are imported on use; nothing here builds or loads a kernel at
import time (the CUDA libraries are compiled on the first CUDA call)."""
