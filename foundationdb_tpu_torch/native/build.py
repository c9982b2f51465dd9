"""Build the port's native components with g++ → shared libraries.

Run directly (``python foundationdb_tpu_torch/native/build.py``) or let
``native.load_library`` build lazily on first use.  Libraries go to the
package's ``_build/`` directory (git-ignored), written under a temporary
name and renamed into place, so concurrent first uses never load a
half-written file.  Bindings go through a C ABI + ctypes.
"""

from __future__ import annotations

import os
import subprocess
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
BUILD_DIR = os.path.join(os.path.dirname(HERE), "_build")

TARGETS = {
    "conflictset": ["conflictset.cpp"],
    "keycodec": ["keycodec.cpp"],
}


def _py_flags() -> tuple[list[str], list[str]]:
    """Compile and link flags for code that embeds this interpreter."""
    import sysconfig
    inc = sysconfig.get_paths()["include"]
    libdir = sysconfig.get_config_var("LIBDIR")
    return ([f"-I{inc}"], [f"-L{libdir}", f"-Wl,-rpath,{libdir}",
                           "-lpython" + sysconfig.get_config_var("LDVERSION")])


# targets outside native/ that embed Python: name -> (sources, the
# headers they include), relative to native/.  They build with C++
# exceptions on (the shim's std::mutex and new may throw).
PY_TARGETS = {
    "fdbtpu_c": (["../bindings/c/fdbtpu_c.cpp"],
                 ["../bindings/c/fdbtpu_c.h"]),
}

CXXFLAGS = ["-std=c++20", "-O3", "-march=native", "-fPIC", "-shared",
            "-Wall", "-Wextra", "-fno-exceptions", "-fno-rtti"]


def lib_path(name: str) -> str:
    return os.path.join(BUILD_DIR, f"lib{name}.so")


def build(name: str, force: bool = False) -> str:
    """Build lib<name>.so into ``_build/`` unless it is newer than every
    source; a failed build raises with the compiler's message."""
    flags, extra_cc, extra_ld, deps = CXXFLAGS, [], [], []
    if name in PY_TARGETS:
        rel_srcs, rel_deps = PY_TARGETS[name]
        srcs = [os.path.normpath(os.path.join(HERE, s)) for s in rel_srcs]
        deps = [os.path.normpath(os.path.join(HERE, s)) for s in rel_deps]
        flags = [f for f in CXXFLAGS if f != "-fno-exceptions"]
        extra_cc, extra_ld = _py_flags()
    else:
        srcs = [os.path.join(HERE, s) for s in TARGETS[name]]
    out = lib_path(name)
    if not force and os.path.exists(out) and all(
            os.path.getmtime(out) >= os.path.getmtime(s)
            for s in srcs + deps):
        return out
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{out}.{os.getpid()}.tmp"
    cmd = ["g++", *flags, *extra_cc, "-o", tmp, *srcs, *extra_ld]
    r = subprocess.run(cmd, capture_output=True, text=True)
    if r.returncode != 0:
        raise RuntimeError(f"building lib{name}.so failed: {' '.join(cmd)}\n"
                           f"{r.stderr}")
    os.replace(tmp, out)
    return out


def build_all(force: bool = False) -> None:
    for name in list(TARGETS) + list(PY_TARGETS):
        print(f"building lib{name}.so ...", file=sys.stderr)
        build(name, force=force)


if __name__ == "__main__":
    build_all(force="--force" in sys.argv)
