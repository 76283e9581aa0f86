"""Timing, tracing and logging helpers (port of linr_pcgc_tpu/utils/:
profiling.py and logging.py; its jax_cache.py and tpu_probe.py are
TPU-only and have no counterpart here)."""

from .profiling import Timer, timed, trace_context
from .logging import set_logger
