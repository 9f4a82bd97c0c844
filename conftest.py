"""Builds the JAX package's native image decoder once per test run, before
any test module is imported.

``gs_localization_tpu/data/native_loader.py`` builds
``native/libgsl_loader.so`` at its first use: it checks that the file
exists, runs ``make -C native`` (``g++`` writes the library in place) and
loads it, under a thread lock only, and a failure stays set for the life
of the process. ``tests/test_native_loader.py`` calls
``NativeLoader.available()`` in a module-level ``skipif``, so every
pytest-xdist worker builds while it collects, all at once; a worker that
loads a half-written file or meets another ``make`` skips that file's
tests, and the port's native-loader cases with them.

This hook runs the same build under an exclusive file lock: the first
process to arrive builds, the others wait and then find a whole file.
pytest loads this file in the controller before xdist starts its workers,
and in each worker, so no test process runs ``make``. If the build fails,
any partial library is removed and the JAX package's own loader decides
in each process, as it would without this file. The hook imports neither
package and changes no option, marker or collection. ``--noconftest``
(the card tests' command) skips it.
"""

import fcntl
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.abspath(__file__))
NATIVE_DIR = os.path.join(ROOT, "native")
LIB_PATH = os.path.join(NATIVE_DIR, "libgsl_loader.so")
LOCK_PATH = os.path.join(ROOT, "build", "native_loader.lock")


def pytest_configure(config):
    os.makedirs(os.path.dirname(LOCK_PATH), exist_ok=True)
    with open(LOCK_PATH, "w") as lock:
        # held until the file closes; a process that finds the library
        # under the lock finds it whole
        fcntl.flock(lock, fcntl.LOCK_EX)
        if os.path.exists(LIB_PATH):
            return
        try:
            subprocess.run(["make", "-C", NATIVE_DIR], check=True,
                           capture_output=True, timeout=120)
        except (OSError, subprocess.SubprocessError) as e:
            if os.path.exists(LIB_PATH):
                os.remove(LIB_PATH)
            err = getattr(e, "stderr", None)
            lines = (err.decode(errors="replace").strip().splitlines()
                     if err else []) or [str(e)]
            why = next((ln for ln in lines if "error" in ln), lines[0])
            print(f"conftest.py: make -C native failed ({why.strip()}); "
                  f"the native loader's tests decide without it",
                  file=sys.stderr)
