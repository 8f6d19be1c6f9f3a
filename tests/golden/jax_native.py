"""The JAX package's native geometry core, for the port's parity tests.

The port's geometry always runs its native core, which copies the JAX
package's native path (``classpose_tpu/native/geomfast.cpp``) bit for bit;
the JAX numpy fallback differs in the last bits of areas, lengths and
centroids. The JAX loader builds ``_geomfast.so`` straight onto its final
path beside the source and caches a failed load for good, so a pytest-xdist
worker that opens the file while another worker's linker rewrites it falls
back to numpy for the rest of its life.

``jax_native_geometry`` (an autouse fixture: import it into a test module)
therefore has the JAX loader build the same source with the same flags into
a private copy under the worker's temporary directory, unless the worker
already holds a loaded library. The handle stays in the JAX module for the
rest of the worker; the module's ``_SO`` path is restored. Where the native
core cannot be had the fixture fails: the numpy fallback would be a
different reference. ``CLASSPOSE_NATIVE_GEOM`` is left alone (``0`` fails).
"""

from pathlib import Path

import pytest

import classpose_tpu.native as jnative


def load_private(directory):
    """The JAX native core's ctypes handle, built into ``directory`` when the
    worker holds none yet (or cached a failed load); fails the test when
    it cannot be built or loaded."""
    lib = jnative._lib
    if lib is not False and lib is not None:
        return lib
    shared = jnative._SO
    Path(directory).mkdir(parents=True, exist_ok=True)
    jnative._lib = False
    jnative._SO = Path(directory) / shared.name
    try:
        lib = jnative.load_geomfast()
    finally:
        jnative._SO = shared
    if lib is None:
        pytest.fail("the JAX package's native geometry core could not be "
                    "built or loaded: the parity tests need its native "
                    "path, not the numpy fallback", pytrace=False)
    return lib


@pytest.fixture(autouse=True, scope="module")
def jax_native_geometry(tmp_path_factory):
    return load_private(tmp_path_factory.mktemp("geomfast"))
