"""Build the C++ host library (cpp/) once, before any test is collected.

``tests/test_frontend.py`` decides at collection whether the library is
there (``skipif(not native.available())``), and ``native.available()``
builds it on first use.  Under pytest-xdist every worker would start that
same cmake build into ``cpp/build`` at once, and a worker that loses the
race skips those tests.  So the controller (or a run without xdist) runs the
build here, in ``pytest_configure``, under a file lock, before the workers
start; the workers then find a library that is up to date.

The commands are the loader's own (cmake configure, then ``cmake --build
-j`` into ``cpp/build``).  They run only when the library is missing or
older than ``cpp/frontend.cpp`` or ``cpp/CMakeLists.txt``.  A failed build is
reported and the run goes on: the library's tests then skip, as they would
without this file.  This file imports neither JAX nor the packages under
test (``tests/conftest.py`` must set ``XLA_FLAGS`` before JAX starts), and
``--noconftest`` leaves it out.
"""

import fcntl
import os
import subprocess
import sys
from os.path import dirname, getmtime, join

REPO = dirname(os.path.abspath(__file__))
SRC = join(REPO, "cpp")
BUILD = join(SRC, "build")
LIBRARY = join(BUILD, "libgantts_frontend.so")
SOURCES = ("frontend.cpp", "CMakeLists.txt")


def library_is_current():
    try:
        built = getmtime(LIBRARY)
    except OSError:
        return False
    for name in SOURCES:
        try:
            if getmtime(join(SRC, name)) > built:
                return False
        except OSError:
            pass
    return True


def build_native_library():
    """Run the loader's two cmake commands; return None, or why they
    failed."""
    commands = (["cmake", "-S", SRC, "-B", BUILD,
                 "-DCMAKE_BUILD_TYPE=Release"],
                ["cmake", "--build", BUILD, "-j"])
    for cmd, timeout in zip(commands, (120, 300)):
        try:
            proc = subprocess.run(cmd, capture_output=True, text=True,
                                  timeout=timeout)
        except (OSError, subprocess.SubprocessError) as e:
            return f"{' '.join(cmd)}: {e!r}"
        if proc.returncode != 0:
            return (f"{' '.join(cmd)} exited {proc.returncode}: "
                    f"{(proc.stdout + proc.stderr)[-2000:]}")
    return None


def pytest_configure(config):
    if hasattr(config, "workerinput") or library_is_current():
        return  # an xdist worker, or nothing to build
    os.makedirs(BUILD, exist_ok=True)
    with open(join(BUILD, ".build.lock"), "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        try:
            if library_is_current():  # another run built it meanwhile
                return
            why = build_native_library()
        finally:
            fcntl.flock(lock, fcntl.LOCK_UN)
    if why is not None:
        print(f"conftest.py: the C++ host library did not build; its tests "
              f"will skip. {why}", file=sys.stderr)
