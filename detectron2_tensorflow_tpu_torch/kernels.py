"""Build and load the port's hand-written CUDA kernels.

Each ``csrc/<name>.cu`` has a plain C interface and is compiled by ``nvcc``
for Hopper (``sm_90a``) into its own shared library under ``_build/`` (a
directory ``.gitignore`` lists), then loaded with ``ctypes``. The first
call builds every source at once, one ``nvcc`` process per file, started
together; a library whose source and flags are unchanged is reused. Nothing
is built at import time, and nothing here falls back: without ``nvcc`` the
builder raises ``RuntimeError``.

Host code in C++ (``csrc/<name>.cpp``, for example the TFRecord CRC) is built
the same way by ``g++`` (:func:`load_host`), into the same directory.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "_build"

NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC",
]
# Per-source extras. The NMS keep mask must be bit-equal to the float32
# IoU the JAX package computes: no a*b+c contraction into FMA.
EXTRA_FLAGS = {"nms_keep": ["-fmad=false"]}

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
# Entry points of each library and their C signatures: every pointer and the
# stream are c_void_p.
_ROI_ARGS = [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _I, _P]
SIGNATURES = {
    "nms_keep": {"nms_keep_launch": [_P, _P, _P, _P, _I, _I, _F, _I, _P]},
    "roi_patch": {"roi_patch_fwd_launch": _ROI_ARGS, "roi_patch_bwd_launch": _ROI_ARGS,
                  "roi_patch_variant_launch": _ROI_ARGS[:-1] + [_I, _P]},
    "fused_residual": {
        "fused_conv1x1_bn_add_relu_launch": [_P] * 6 + [_I] * 5 + [_P]},
}

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}


def find_nvcc() -> str:
    """Path of ``nvcc``: on ``PATH``, else under ``CUDA_HOME`` or /usr/local/cuda."""
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    cand = Path(home) / "bin" / "nvcc"
    if cand.is_file():
        return str(cand)
    raise RuntimeError(
        "nvcc not found (looked on PATH and in $CUDA_HOME/bin): the CUDA "
        "kernels of detectron2_tensorflow_tpu_torch build only on a machine "
        "with the CUDA toolkit"
    )


def _flags(name: str):
    return NVCC_FLAGS + EXTRA_FLAGS.get(name, [])


def _target(name: str) -> Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    tag = hashlib.sha256(src + " ".join(_flags(name)).encode()).hexdigest()[:16]
    return BUILD_DIR / f"{name}-{tag}.so"


def build_all() -> Dict[str, Path]:
    """Compile every ``csrc/*.cu`` whose library is missing, in parallel.

    Returns ``{name: library path}``. Raises ``RuntimeError`` when ``nvcc``
    is missing or a compile fails (with the compiler's output).
    """
    nvcc = find_nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    targets = {name: _target(name) for name in SIGNATURES}
    procs = {}
    for name, target in targets.items():
        if target.is_file():
            continue
        tmp = target.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *_flags(name), "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True), tmp)
    failures = []
    for name, (proc, tmp) in procs.items():
        out, _ = proc.communicate()
        if proc.returncode != 0:
            failures.append(f"{name}.cu (exit {proc.returncode}):\n{out}")
        else:
            os.replace(tmp, targets[name])
    if failures:
        raise RuntimeError("nvcc failed to build:\n" + "\n".join(failures))
    return targets


def load(name: str) -> ctypes.CDLL:
    """The loaded library ``name`` (a key of ``SIGNATURES``), built on first use."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            paths = build_all()
            for n, path in paths.items():
                cdll = ctypes.CDLL(str(path))
                for fn_name, argtypes in SIGNATURES[n].items():
                    fn = getattr(cdll, fn_name)
                    fn.argtypes = argtypes
                    fn.restype = ctypes.c_int
                _libs[n] = cdll
            lib = _libs[name]
        return lib


def check(rc: int, what: str) -> None:
    """Raise if a C entry point returned a CUDA error code."""
    if rc != 0:
        raise RuntimeError(f"{what}: CUDA error {rc} at launch")


# Host libraries: csrc/<name>.cpp -> {entry point: (argument types, result type)}.
HOST_SIGNATURES = {"crc32c": {"crc32c": ([ctypes.c_char_p, ctypes.c_long], ctypes.c_uint32)}}
HOST_FLAGS = ["-O3", "-shared", "-fPIC", "-std=c++17"]
_host_libs: Dict[str, ctypes.CDLL] = {}


def load_host(name: str) -> ctypes.CDLL:
    """The host library ``name`` (a key of ``HOST_SIGNATURES``), built by
    ``g++`` on first use; raises ``RuntimeError`` when ``g++`` is missing or
    the compile fails."""
    with _lock:
        lib = _host_libs.get(name)
        if lib is not None:
            return lib
        src = CSRC / f"{name}.cpp"
        tag = hashlib.sha256(src.read_bytes() + " ".join(HOST_FLAGS).encode()).hexdigest()[:16]
        target = BUILD_DIR / f"{name}-{tag}.so"
        if not target.is_file():
            gxx = shutil.which("g++")
            if gxx is None:
                raise RuntimeError(f"g++ not found on PATH: {src.name} builds only with a C++ "
                                   "compiler")
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            tmp = target.with_suffix(f".{os.getpid()}.tmp")
            proc = subprocess.run([gxx, *HOST_FLAGS, "-o", str(tmp), str(src)],
                                  capture_output=True, text=True)
            if proc.returncode != 0:
                raise RuntimeError(f"g++ failed to build {src.name} (exit {proc.returncode}):\n"
                                   f"{proc.stdout}{proc.stderr}")
            os.replace(tmp, target)
        lib = ctypes.CDLL(str(target))
        for fn_name, (argtypes, restype) in HOST_SIGNATURES[name].items():
            fn = getattr(lib, fn_name)
            fn.argtypes = argtypes
            fn.restype = restype
        _host_libs[name] = lib
        return lib
