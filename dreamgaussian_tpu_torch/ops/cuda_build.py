"""Build and load the port's CUDA kernels (nvcc -> shared library -> ctypes).

Each ``csrc/<name>.cu`` exposes a plain C entry point and is compiled at
first use for Hopper (``sm_90a``) into ``build/kernels/`` at the root of
the checkout, under a name that carries the hash of the source, of the
headers beside it and of the flags, so an edited source is rebuilt. The
flags are the common ones plus the source's own (``SOURCE_FLAGS``) plus
what the caller adds (``extra``: a test's or a timing script's variant).
``build`` starts one ``nvcc`` per missing library, all at once, and waits
for all of them.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

CSRC_DIR = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)
# Flags of one source. K3's gate is equality with its plain version on every
# pixel, so it rounds each operation as PyTorch does: no contraction into
# fused multiply-adds. K1 and K2 are held to tolerances; they keep the few
# products that decide a branch apart with __fmul_rn / __fadd_rn and let
# the rest contract.
SOURCE_FLAGS = {"ztest": ("--fmad=false",)}

_LIBS: dict[tuple, ctypes.CDLL] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found: the CUDA toolkit is needed to build the kernels")


def flags_for(name: str, extra: tuple = ()) -> tuple:
    return (*NVCC_FLAGS, *SOURCE_FLAGS.get(name, ()), *extra)


def library_path(name: str, extra: tuple = ()) -> Path:
    digest = hashlib.sha256((CSRC_DIR / f"{name}.cu").read_bytes())
    for header in sorted(CSRC_DIR.glob("*.cuh")):
        digest.update(header.read_bytes())
    digest.update(" ".join(flags_for(name, extra)).encode())
    return BUILD_DIR / f"{name}-{digest.hexdigest()[:16]}.so"


def build(names, verbose: bool = False, extra: tuple = ()) -> None:
    """Compile every named kernel source whose library is missing."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    jobs = []
    for name in names:
        so = library_path(name, extra)
        if so.exists():
            continue
        tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
        cmd = [_nvcc(), *flags_for(name, extra), "-o", str(tmp), str(CSRC_DIR / f"{name}.cu")]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)
        jobs.append((name, proc, tmp, so))
    failed = []
    for name, proc, tmp, so in jobs:
        log, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"nvcc failed for {name}.cu:\n{log}")
            continue
        if verbose:
            print(f"[build] {name}.cu -> {so.name}\n{log.strip()}")
        os.replace(tmp, so)
    if failed:
        raise RuntimeError("\n".join(failed))


def load(name: str, argtypes: list, extra: tuple = ()) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built first if missing;
    its C function ``name`` gets ``argtypes`` and an int return code."""
    key = (name, extra)
    if key not in _LIBS:
        build([name], extra=extra)
        lib = ctypes.CDLL(str(library_path(name, extra)))
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        _LIBS[key] = lib
    return _LIBS[key]
