"""The JAX package's native library for the port's CPU tests, loaded
without racing its first build.

``nyxus_tpu.native`` builds ``libnyxnative.so`` on first use with one
``g++ -o`` straight onto its final path, guarded only by a thread lock.
Under pytest-xdist every worker that collects a file calling
``native.available()`` starts that build at once, and a worker that
``dlopen``s a half-written library keeps the error for its whole session:
every later native call in it fails or skips.  The port's tests that
compare with JAX through that library call ``jax_native()`` (or import the
autouse fixture ``jax_native_loaded``) before anything of JAX reaches it.

``jax_native()`` holds an ``fcntl`` lock on a file under the system
temporary directory, so that the port's test processes build and load one
at a time.  A worker whose module already holds a loaded library keeps
it; otherwise the module's failed state (``_lib`` / ``_build_err``) is
cleared and the library is built from the JAX package's own sources,
flags and command into a directory of its own under the same temporary
directory, where no unlocked build writes, and loaded from there.  The
JAX package's files and its own ``_build`` directory are left as they
are."""

import fcntl
import hashlib
import os
import tempfile

import pytest

_LOCK_NAME = "nyxus_tpu_native_tests.lock"


def _private_lib(native):
    """A path for the library under the temporary directory, named by the
    JAX package's sources and flags."""
    h = hashlib.sha256(" ".join(native._CFLAGS).encode())
    for s in native._SOURCES:
        with open(os.path.join(native._SRC, s), "rb") as f:
            h.update(f.read())
    d = os.path.join(tempfile.gettempdir(),
                     "nyxus_tpu_native_" + h.hexdigest()[:16])
    return os.path.join(d, "libnyxnative.so")


def jax_native():
    """``nyxus_tpu.native`` with its library loaded; fails the test where
    it cannot be built."""
    from nyxus_tpu import native
    if native._lib is not None:
        return native
    lock = os.path.join(tempfile.gettempdir(), _LOCK_NAME)
    with open(lock, "a") as f:
        fcntl.flock(f, fcntl.LOCK_EX)
        try:
            if native._lib is None:
                with native._lock:
                    native._LIB = _private_lib(native)
                    native._lib = None
                    native._build_err = None
                native.available()
        finally:
            fcntl.flock(f, fcntl.LOCK_UN)
    if native._lib is None:
        pytest.fail("the JAX package's native library did not build: %r"
                    % (native._build_err,))
    return native


@pytest.fixture(autouse=True, scope="module")
def jax_native_loaded():
    """Load the JAX package's native library before a module's tests."""
    return jax_native()
