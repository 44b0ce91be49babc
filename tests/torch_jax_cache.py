"""The port's test files release the reference's compiled programs.

Every program JAX compiles on the CPU keeps its code mapped in the
process for as long as JAX caches it, and a Linux process may hold at
most `vm.max_map_count` (65,530 by default) mappings. A pytest-xdist
worker that runs many of the port's files, each compiling many of the
reference's programs, passes that bound; the next compile, or the next
read of JAX's persistent compilation cache, then dies with a
segmentation fault, and the worker's tests with it. A test file takes
the fixture below by importing it: after the file's tests JAX's
in-process caches are cleared, which unmaps their programs. JAX is
imported only when the fixture runs, so that a file whose spawned ranks
re-import it stays free of JAX.
"""

import gc

import pytest


@pytest.fixture(autouse=True, scope="module")
def release_compiled_programs():
    """Clear JAX's in-process caches after the importing file's tests."""
    yield
    import jax
    jax.clear_caches()
    gc.collect()
