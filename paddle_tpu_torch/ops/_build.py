"""Build and load the port's hand-written CUDA kernels.

Each kernel is one source under ``paddle_tpu_torch/csrc/`` with a plain C
interface (headers there, ``*.cuh``, are shared between sources). It is
compiled by ``nvcc`` for Hopper (``sm_90a``) into a shared library in
``paddle_tpu_torch/_build/`` at first use and loaded with ``ctypes``. The
library's file name carries a hash of the source, the headers and the
flags, so an edited source or header builds anew and an unchanged one
loads from the build directory. A failed build raises.

Nothing here runs at import time: the CPU tests import every module of
the port on a machine without ``nvcc``.

``build_all()`` starts one ``nvcc`` per source, all at once, and waits
for them together; it returns the seconds spent, and ``build_logs`` keeps
each compiler's output (register and spill counts from ``-Xptxas -v``).
Each build and each library load is announced to the callables in
``listeners`` as ``(stage, name, seconds)`` with stage "nvcc_build" or
"library_load" (``observability.compile_watch`` counts them).
"""
import ctypes
import hashlib
import os
import shutil
import subprocess
import threading

PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(PKG_DIR, "csrc")
BUILD_DIR = os.path.join(PKG_DIR, "_build")
SOURCES = ("ragged_paged_attention", "weight_only_matmul", "flash_attention",
           "blockwise_ce", "flashmask", "paged_decode_attention",
           "fused_norm", "swiglu", "token_ce", "adamw")

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lock = threading.Lock()
_libs = {}
build_logs = {}     # source name -> compiler output of this process's build
listeners = []      # callables (stage, name, seconds), see the docstring


def _announce(stage, name, seconds):
    for fn in list(listeners):
        fn(stage, name, seconds)


def nvcc_path():
    """The CUDA compiler: ``$CUDA_HOME/bin/nvcc``, else ``nvcc`` on PATH,
    else the default toolkit location."""
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    cands = [os.path.join(home, "bin", "nvcc")] if home else []
    found = shutil.which("nvcc")
    if found:
        cands.append(found)
    cands.append("/usr/local/cuda/bin/nvcc")
    for c in cands:
        if os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    raise RuntimeError(
        "nvcc not found (set CUDA_HOME): the port's CUDA kernels are built "
        "from source at first use")


def _lib_path(name):
    src = os.path.join(CSRC_DIR, name + ".cu")
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    headers = sorted(f for f in os.listdir(CSRC_DIR) if f.endswith(".cuh"))
    for path in [src] + [os.path.join(CSRC_DIR, h) for h in headers]:
        with open(path, "rb") as f:
            digest.update(f.read())
    return src, os.path.join(BUILD_DIR, f"{name}-{digest.hexdigest()[:16]}.so")


def _start(name):
    """Launch nvcc for ``name`` unless its library is already built.
    Returns (process or None, target path, temp path)."""
    src, out = _lib_path(name)
    if os.path.exists(out):
        return None, out, None
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{out}.{os.getpid()}.tmp"
    proc = subprocess.Popen(
        [nvcc_path(), *NVCC_FLAGS, "-o", tmp, src],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    return proc, out, tmp


def _finish(name, proc, out, tmp, timeout):
    if proc is None:
        return
    try:
        log, _ = proc.communicate(timeout=timeout)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.communicate()
        raise RuntimeError(f"nvcc timed out building {name}")
    build_logs[name] = log
    if proc.returncode != 0:
        if os.path.exists(tmp):
            os.remove(tmp)
        raise RuntimeError(f"nvcc failed building {name}.cu "
                           f"(exit {proc.returncode}):\n{log}")
    os.replace(tmp, out)


def build_all(names=SOURCES, timeout=600):
    """Build every named source in parallel (one nvcc each) and load the
    libraries. Returns the wall seconds the builds took."""
    import time
    t0 = time.perf_counter()
    with _lock:
        started = [(n, *_start(n)) for n in names if n not in _libs]
        errors = []
        for n, proc, out, tmp in started:
            try:
                _finish(n, proc, out, tmp, timeout)
            except RuntimeError as e:
                errors.append(str(e))
            else:
                if proc is not None:
                    _announce("nvcc_build", n, time.perf_counter() - t0)
        if errors:
            raise RuntimeError("\n".join(errors))
        for n, _, out, _ in started:
            t1 = time.perf_counter()
            _libs[n] = ctypes.CDLL(out)
            _announce("library_load", n, time.perf_counter() - t1)
    return time.perf_counter() - t0


def load(name):
    """The loaded ctypes library for csrc/``name``.cu, built on first use."""
    lib = _libs.get(name)
    if lib is None:
        build_all((name,))
        lib = _libs[name]
    return lib
