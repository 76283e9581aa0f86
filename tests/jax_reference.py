"""How the port's tests (tests/test_torch_*.py) compile their JAX references.

Most of those tests' time is XLA compiling the JAX functions they hold the
port against, once each (a trainer's step takes 30-60 s on the CPU, with
two to three cores busy), and it competes with the rest of the suite for
the box.  Within ``fast_compiles()`` every XLA compile (the tests' own
jits, the steps the JAX package's trainers jit when they are built, and
the package's module-level jits) runs at XLA's CPU backend optimisation
level 0: the same HLO, with LLVM's optimisation passes skipped, which
compiles in about two thirds of the time on two thirds of the CPU.  It
changes no operation the reference computes, only how the machine code
for them is optimised.  The options reach XLA through the one function
that makes JAX's compile options (``jax._src.compiler.get_compile_options``);
options a caller names itself win.

JAX's in-memory caches of traced and compiled functions are not keyed on
these options, so the block ends by clearing them (``jax.clear_caches``):
a test module that runs later in the same process compiles its functions
with the default options again.  The persistent compilation cache keys
its entries on the options, so it keeps both kinds apart.

A test module takes the options for all of its tests by importing the
autouse fixture: ``from jax_reference import fast_jax_compiles``.
"""

import contextlib

import jax
import pytest
from jax._src import compiler

COMPILER_OPTIONS = {"xla_backend_optimization_level": 0}


@contextlib.contextmanager
def fast_compiles():
    """Within the block, XLA compiles with COMPILER_OPTIONS; on leaving it,
    JAX's in-memory caches are cleared."""
    real = compiler.get_compile_options

    def with_options(*args, env_options_overrides=None, **kwargs):
        return real(*args, env_options_overrides={**COMPILER_OPTIONS,
                                                  **(env_options_overrides or {})}, **kwargs)

    compiler.get_compile_options = with_options
    try:
        yield
    finally:
        compiler.get_compile_options = real
        jax.clear_caches()


@pytest.fixture(autouse=True, scope="module")
def fast_jax_compiles():
    """The importing module's JAX references compile with COMPILER_OPTIONS."""
    with fast_compiles():
        yield
