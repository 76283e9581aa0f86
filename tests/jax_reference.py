"""How the port's tests (tests/test_torch_*.py) compile their JAX references.

Most of those tests' time is XLA compiling the JAX functions they hold the
port against, once each (a trainer's step takes 30-60 s on the CPU, with
two to three cores busy), and it competes with the rest of the suite for
the box.  Within ``fast_compiles()`` every XLA compile (the tests' own
jits, the steps the JAX package's trainers jit when they are built, and
the package's module-level jits) runs at XLA's CPU backend optimisation
level 0, with the CPU backend's LLVM IR fusion emitters in place of its
MLIR ones: the same HLO, with LLVM's optimisation passes skipped and the
MLIR pipeline not run, which compiles on less CPU.  It changes no
operation the reference computes, only how the machine code for them is
made.  The options reach XLA through the one function that makes JAX's
compile options (``jax._src.compiler.get_compile_options``); options a
caller names itself win.

JAX's in-memory caches of traced and compiled functions are not keyed on
these options, so the block also sets a JAX user context
(``jax.make_user_context``), which is part of those caches' keys: what is
compiled inside the block is found only inside it, and a test module that
runs later in the same process (the JAX package's own) finds what was
compiled before the block, with the default options, and compiles the
rest with them.  Nothing is cleared, so the next port module in the
process reuses the options' compiles.  The persistent compilation cache
keys its entries on the options, so it keeps both kinds apart.

A test module takes the options for all of its tests by importing the
autouse fixture: ``from jax_reference import fast_jax_compiles``.  The
fixture also lowers the scheduling priority of the process that runs the
module (see ``yield_the_cpu``).
"""

import contextlib
import os

import jax
import pytest
from jax._src import compiler

COMPILER_OPTIONS = {"xla_backend_optimization_level": 0, "xla_cpu_use_fusion_emitters": False}
_OPTIONS_KEY = jax.make_user_context(default_value=None)


@contextlib.contextmanager
def fast_compiles():
    """Within the block, XLA compiles with COMPILER_OPTIONS, and JAX's
    in-memory caches key their entries on them."""
    real = compiler.get_compile_options

    def with_options(*args, env_options_overrides=None, **kwargs):
        return real(*args, env_options_overrides={**COMPILER_OPTIONS,
                                                  **(env_options_overrides or {})}, **kwargs)

    compiler.get_compile_options = with_options
    try:
        with _OPTIONS_KEY(tuple(sorted(COMPILER_OPTIONS.items()))):
            yield
    finally:
        compiler.get_compile_options = real


NICE = 19


def yield_the_cpu(nice=NICE):
    """Lower this process's scheduling priority to ``nice``: every thread it
    has (Linux keeps a nice value per thread: XLA's and torch's pools exist
    by now) and, by inheritance, every thread and process it starts later.
    A priority once lowered stays so for the life of the process."""
    for tid in os.listdir("/proc/self/task"):
        try:
            if os.getpriority(os.PRIO_PROCESS, int(tid)) < nice:
                os.setpriority(os.PRIO_PROCESS, int(tid), nice)
        except OSError:  # the thread has ended
            pass


@pytest.fixture(autouse=True, scope="module")
def fast_jax_compiles():
    """The importing module's JAX references compile with COMPILER_OPTIONS,
    and its process yields the CPU to those at the default priority.

    The suite is CPU-bound, and its wall is the span of the JAX package's
    tests/test_parallel.py (the 8-device trainers).  Under pytest-xdist's
    ``--dist loadfile`` that file is the seventh in the queue, behind only
    JAX's own files and port files with more than 14 cases, which import
    no JAX and never reach this fixture.  So the worker that takes it has
    run no port module with JAX references, and it runs the whole file
    before the module fixtures of the next file it takes: its priority is
    never lowered.  The port's JAX-heavy modules then run on the cores that
    file leaves idle."""
    yield_the_cpu()
    with fast_compiles():
        yield
