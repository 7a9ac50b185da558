"""Build a CUDA source of ``lobpcg_tpu_torch/csrc`` into a shared library
with a plain C interface, and load it with ctypes.

``nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC``
runs at first use, into ``lobpcg_tpu_torch/_build/`` (listed in
``.gitignore``); ``build_all`` starts one nvcc per source, all together.
The library's file name carries a hash of the source and the flags, so
an edited source rebuilds and an unchanged one loads the library
already built.  Nothing here runs at import time.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor

PKG_DIR = pathlib.Path(__file__).resolve().parents[2]
CSRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR / "_build"

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
)

# name -> (ctypes.CDLL, build record); one load per source per process.
_LOADED: dict = {}


def find_nvcc() -> str:
    """nvcc from CUDA_HOME, /usr/local/cuda or PATH; raises if absent."""
    cands = []
    if os.environ.get("CUDA_HOME"):
        cands.append(pathlib.Path(os.environ["CUDA_HOME"]) / "bin" / "nvcc")
    cands.append(pathlib.Path("/usr/local/cuda/bin/nvcc"))
    for c in cands:
        if c.is_file():
            return str(c)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found (CUDA_HOME, /usr/local/cuda/bin, PATH): the "
            "CUDA kernels of lobpcg_tpu_torch build from source at first use"
        )
    return found


def _paths(name: str):
    src = CSRC_DIR / f"{name}.cu"
    digest = hashlib.sha256(
        src.read_bytes() + " ".join(NVCC_FLAGS).encode()
    ).hexdigest()[:16]
    return src, BUILD_DIR / f"lib{name}_{digest}.so"


def _compile(name: str) -> dict:
    """Run nvcc on ``csrc/<name>.cu`` unless its library is built;
    returns the build record."""
    src, lib_path = _paths(name)
    record = {"name": name, "path": str(lib_path), "built": False,
              "seconds": 0.0, "log": ""}
    if lib_path.is_file():
        return record
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = find_nvcc()
    # Build into a private temporary name, then rename: a concurrent
    # process never loads a half-written library.
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    t0 = time.perf_counter()
    proc = subprocess.run(
        [nvcc, *NVCC_FLAGS, "-o", tmp, str(src)],
        capture_output=True, text=True,
    )
    record["seconds"] = time.perf_counter() - t0
    record["log"] = proc.stdout + proc.stderr
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(
            f"nvcc failed on {src} (exit {proc.returncode}):\n"
            + record["log"]
        )
    os.replace(tmp, lib_path)
    record["built"] = True
    return record


def build_all(names) -> list[dict]:
    """Build the sources of ``names`` not yet loaded, one nvcc each, all
    started together, then load them; returns their build records."""
    todo = [nm for nm in dict.fromkeys(names) if nm not in _LOADED]
    if todo:
        with ThreadPoolExecutor(len(todo)) as pool:
            records = list(pool.map(_compile, todo))
        for record in records:
            lib = ctypes.CDLL(record["path"])
            lib.lobpcg_cuda_error_string.argtypes = [ctypes.c_int]
            lib.lobpcg_cuda_error_string.restype = ctypes.c_char_p
            _LOADED[record["name"]] = (lib, record)
    return [build_record(nm) for nm in names]


def load_library(name: str, signatures: dict) -> ctypes.CDLL:
    """Build (if needed) and load ``csrc/<name>.cu``, cached per process,
    and give each entry point of ``signatures`` (symbol -> ctypes
    argument types) its argument types and an int return."""
    build_all([name])
    lib = _LOADED[name][0]
    for sym, argtypes in signatures.items():
        fn = getattr(lib, sym)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib


def build_record(name: str) -> dict:
    """What ``load_library(name)`` did in this process: library path,
    whether it compiled, nvcc seconds and nvcc's output."""
    return dict(_LOADED[name][1])


def check(lib: ctypes.CDLL, code: int, what: str) -> None:
    """Raise on a non-zero cudaError_t returned by a launch."""
    if code != 0:
        msg = lib.lobpcg_cuda_error_string(code).decode()
        raise RuntimeError(f"{what}: CUDA error {code} ({msg})")
