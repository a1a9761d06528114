"""Build and load the port's CUDA kernels.

The sources in ``csrc/`` have a plain C interface, so they are compiled by
``nvcc`` alone (no torch headers: seconds, not minutes) and loaded with
``ctypes``. Each source is compiled to an object by its own ``nvcc``, all
started together, and the objects are linked into one shared library in
``build/optpricer_tpu_torch/`` beside the package, named by a hash of the
sources and flags, so an edit rebuilds and an unchanged tree reuses it.
A missing ``nvcc`` or a failed build raises; there is no fallback.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "build" / "optpricer_tpu_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC")
# source -> its own flags. The book, path, basket and fused PDE kernels are
# built without FMA contraction, so each operation rounds as in their plain
# torch versions (see the notes at the top of each source). The terminal
# kernels and the tridiagonal solve take it: their results are held by
# tolerance, not bit for bit.
SOURCES = {
    "terminal_mc.cu": (),
    "mc_batch.cu": ("-fmad=false",),
    "path_mc.cu": ("-fmad=false",),
    "qmc_path.cu": ("-fmad=false",),
    "thomas.cu": (),
    "fd_lv.cu": ("-fmad=false",),
    "basket_mc.cu": ("-fmad=false",),
    "lsmc.cu": (),
}

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_F = ctypes.c_float
# name -> argtypes of the C entry points in csrc/*.cu
_SIGNATURES = {
    "optpricer_terminal_mc": (_P, _P, _P, _P, _P, _I, _I, _I, _I, _P),
    "optpricer_terminal_qmc": (_P, _P, _I, _I, _I, _I, _P),
    "optpricer_terminal_qmc_clusters": (_I, _I, _P),
    "optpricer_terminal_mc_occupancy": (_I, _I),
    "optpricer_mc_batch": (_P, _P, _P, _P, _P, _I, _I, _I, _I, _P),
    "optpricer_path_mc": (_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                          _I, _I, _I, _P),
    "optpricer_path_mc_occupancy": (_I, _I, _I, _I, _I, _P),
    "optpricer_path_mc_fast_ops": (_P, _P, _P, _L, _I, _P),
    "optpricer_qmc_path": (_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I,
                           _I, _I, _I, _I, _I, _P),
    "optpricer_qmc_path_occupancy": (_I, _I),
    "optpricer_thomas": (_P, _L, _L, _L, _P, _L, _L, _L, _P, _L, _L, _L,
                         _P, _L, _L, _L, _P, _L, _L, _L, _P, _I, _I, _I, _I,
                         _P),
    "optpricer_fd_lv": (_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _F, _F,
                        _I, _I, _P),
    "optpricer_fd_lv_plan": (_P, _P, _P, _I, _I, _I, _F, _F, _I, _P),
    "optpricer_basket_mc": (_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I,
                            _P),
    "optpricer_basket_mc_occupancy": (_I, _I, _I, _P),
    "optpricer_lsmc_date": (_P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I,
                            _I, _I, _I, _I, _P),
    "optpricer_lsmc_occupancy": (_I,),
    "optpricer_lsmc_layout": (_P,),
}


def find_nvcc() -> str:
    nvcc = shutil.which("nvcc")
    if nvcc is None:
        home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
        candidate = Path(home) / "bin" / "nvcc"
        if candidate.exists():
            nvcc = str(candidate)
    if nvcc is None:
        raise RuntimeError("nvcc not found (PATH, $CUDA_HOME/bin, "
                           "/usr/local/cuda/bin): cannot build the CUDA kernels")
    return nvcc


def library_path() -> Path:
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name, flags in sorted(SOURCES.items()):
        digest.update(f"{name} {' '.join(flags)}".encode())
    for path in sorted(CSRC.iterdir()):
        if path.suffix in (".cu", ".cuh"):
            digest.update(path.name.encode())
            digest.update(path.read_bytes())
    return BUILD_DIR / f"liboptpricer_kernels-{digest.hexdigest()[:16]}.so"


def build(verbose: bool = False) -> Path:
    """Compile the kernels unless the library for these sources exists.

    ``verbose`` prints ptxas' register and spill report of every kernel,
    one block per source headed by the seconds its nvcc took.
    """
    lib = library_path()
    if lib.exists():
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = find_nvcc()
    ptxas = ["-Xptxas", "-v"] if verbose else []
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        t0 = time.perf_counter()
        procs = {}
        for name, flags in SOURCES.items():
            obj = str(Path(tmp) / f"{Path(name).stem}.o")
            cmd = [nvcc, *NVCC_FLAGS, *flags, *ptxas, "-c", "-o", obj,
                   str(CSRC / name)]
            procs[name] = (cmd, obj, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                text=True))
        failed = []
        # each source's own seconds: its nvcc waited on in a thread
        with ThreadPoolExecutor(len(procs)) as pool:
            done = pool.map(_finish, [proc for _, _, proc in procs.values()])
            for (name, (cmd, _, proc)), (err, secs) in zip(procs.items(),
                                                          done):
                if proc.returncode != 0:
                    failed.append(f"nvcc failed ({proc.returncode}):\n"
                                  f"{' '.join(cmd)}\n{err}")
                elif verbose:
                    print(f"--- {name} ({secs - t0:.1f} s)\n{err}", end="")
        if failed:
            raise RuntimeError("\n".join(failed))
        out = str(Path(tmp) / "lib.so")
        cmd = [nvcc, *NVCC_FLAGS, "-shared", "-o", out,
               *(obj for _, obj, _ in procs.values())]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc link failed ({proc.returncode}):\n"
                               f"{' '.join(cmd)}\n{proc.stderr}")
        os.replace(out, lib)
    return lib


def _finish(proc: subprocess.Popen):
    """(stderr, perf_counter at its end) of a running nvcc."""
    _, err = proc.communicate()
    return err, time.perf_counter()


@functools.cache
def load() -> ctypes.CDLL:
    """The kernels' library, built on first use, with typed entry points."""
    lib = ctypes.CDLL(str(build()))
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib
