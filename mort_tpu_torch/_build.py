"""Build the port's CUDA kernels with nvcc at first use and load them.

Each ``csrc/<name>.cu`` compiles into a shared library with a plain C
interface, bound with ``ctypes``:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \\
         -Xcompiler -fPIC -o lib<name>_<key>.so csrc/<name>.cu

(no ``--use_fast_math``: square roots and divisions stay IEEE), with
``-Xptxas -v``, whose report of each kernel's registers, spills and shared
memory is kept beside the library (``build_log``).  The library lands in
``build/mort_tpu_torch/`` beside the package, named by a hash of the source
and the flags, so an edited source rebuilds and an unchanged one loads at
once.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import sys
import tempfile
from pathlib import Path

_PKG = Path(__file__).resolve().parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "mort_tpu_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_L, _U = ctypes.c_longlong, ctypes.c_uint
_LP = ctypes.POINTER(_L)
# C signatures of each library's exported functions: (restype, argtypes).
SIGNATURES = {
    "closest_hit": {
        "mort_closest_hit": (_I, (_P, _I, _P, _I, _P, _I, _P, _I, _I, _F,
                                  _I, _P, _I, _P, _P, _P, _I, _I, _P, _P,
                                  _I, _I, _P, _P, _P)),
        "mort_closest_hit_cull": (_I, (_P, _I, _P, _I, _P, _I, _P, _I, _I,
                                       _F, _P, _I, _I, _I, _P, _P, _P, _L,
                                       _P, _L, _P)),
        "mort_closest_hit_cull_scratch": (None, (_I, _I, _LP, _LP)),
        "mort_closest_hit_bwd": (_I, (_P, _I, _P, _P, _P, _P, _P, _I, _P,
                                      _I, _I, _I, _I, _F, _P, _P, _P, _P,
                                      _P, _L, _P, _L, _P)),
        "mort_cuda_error_string": (ctypes.c_char_p, (_I,)),
    },
    "philox": {
        "mort_philox_uniform4": (_I, (_P, _U, _I) * 4 + (_P, _U, _U, _L,
                                                          _P, _P, _P, _P,
                                                          _P)),
    },
    "noise": {
        "mort_noise_marble": (_I, (_P, _P, _P, _P, _P, _I, _I, _P, _P, _L,
                                   _P)),
    },
}

_loaded: dict[str, ctypes.CDLL] = {}
_build_dir: list[Path] = []


def build_dir() -> Path:
    """Where libraries are built: ``BUILD_DIR`` when it can be created and
    written, else the user's cache directory (the path is printed once).
    This is a location, not a fallback of the build: a failed compile
    still raises."""
    if not _build_dir:
        try:
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            usable = os.access(BUILD_DIR, os.W_OK | os.X_OK)
        except OSError:
            usable = False
        if usable:
            _build_dir.append(BUILD_DIR)
        else:
            cache = Path(os.environ.get("XDG_CACHE_HOME")
                         or Path.home() / ".cache")
            _build_dir.append(cache / "mort_tpu_torch" / "build")
            print(f"mort_tpu_torch: {BUILD_DIR} is not writable; building "
                  f"in {_build_dir[0]}", file=sys.stderr)
    return _build_dir[0]


def find_nvcc() -> str:
    for cand in (os.environ.get("CUDA_HOME"), os.environ.get("CUDA_PATH"),
                 "/usr/local/cuda"):
        if cand and os.path.exists(os.path.join(cand, "bin", "nvcc")):
            return os.path.join(cand, "bin", "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on "
                           "PATH): the port's CUDA kernels cannot be built")
    return found


def _library_path(stem: str, src: Path, flags) -> Path:
    key = hashlib.sha256(src.read_bytes() + " ".join(flags).encode())
    return build_dir() / f"lib{stem}_{key.hexdigest()[:16]}.so"


def library_path(name: str) -> Path:
    return _library_path(name, CSRC / f"{name}.cu", NVCC_FLAGS)


def compile_library(stem: str, src: Path, compiler: str, flags) -> Path:
    """Compile ``src`` with ``compiler flags -o out src`` into
    ``build_dir()/lib<stem>_<key>.so`` unless it is built already;
    the key hashes the source and the flags.  The compiler writes a
    temporary file that is renamed into place, so concurrent builds never
    load a half-written library; its output is kept beside it (``.log``).
    Raises ``RuntimeError`` with the compiler's output when it fails."""
    out = _library_path(stem, src, flags)
    if out.exists():
        return out
    out.parent.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=out.parent)
    os.close(fd)
    try:
        cmd = [compiler, *flags, "-o", tmp, str(src)]
        res = subprocess.run(cmd, capture_output=True, text=True)
        if res.returncode != 0:
            raise RuntimeError(f"{os.path.basename(compiler)} failed "
                               f"({res.returncode}) for {src.name}:\n"
                               f"{res.stdout}{res.stderr}")
        out.with_suffix(".log").write_text(res.stdout + res.stderr)
        os.replace(tmp, out)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return out


def build(name: str) -> Path:
    """Compile ``csrc/<name>.cu`` unless its library is already built."""
    out = library_path(name)
    if out.exists():
        return out
    return compile_library(name, CSRC / f"{name}.cu", find_nvcc(),
                           NVCC_FLAGS)


def build_log(name: str) -> str:
    """nvcc's output (the ``-Xptxas -v`` report) of the build of ``name``."""
    return build(name).with_suffix(".log").read_text()


def load_library(name: str) -> ctypes.CDLL:
    """The built library ``name``, with its C signatures declared."""
    lib = _loaded.get(name)
    if lib is None:
        lib = ctypes.CDLL(str(build(name)))
        for fn, (restype, argtypes) in SIGNATURES[name].items():
            getattr(lib, fn).restype = restype
            getattr(lib, fn).argtypes = argtypes
        _loaded[name] = lib
    return lib
