"""Build and load the hand-written CUDA kernels.

Each ``csrc/<name>.cu`` exposes a plain C interface and is compiled on its
own by ``nvcc`` into ``<repo>/build/kernels/<name>-<hash>.so`` (the hash
covers the source, the shared ``csrc/*.cuh`` headers and the flags, so an
edited source or header rebuilds), then
loaded with ``ctypes``.  Nothing is built when a module is imported: the
first kernel launch builds what it needs, and :func:`build_all` starts one
``nvcc`` per source at once so a cold build takes as long as the slowest
file.  The process-wide table of loaded libraries lives in
:data:`_LOADED`; a shared library cannot be loaded twice anyway.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import threading
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
SOURCES = ("latent_decode", "latent_decode_tc", "flash_prefill", "dense_decode",
           "dense_verify", "stage_install")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_LOADED: dict[str, ctypes.CDLL] = {}
_LOAD_LOCK = threading.Lock()


def nvcc_path() -> str:
    for cand in (shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (PATH, $CUDA_HOME/bin, /usr/local/cuda/bin): "
                       "the CUDA kernels are built from source at first use")


def library_path(name: str) -> Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    headers = b"".join(p.read_bytes() for p in sorted(CSRC.glob("*.cuh")))
    digest = hashlib.sha256(src + headers + " ".join(NVCC_FLAGS).encode()).hexdigest()[:12]
    return BUILD_DIR / f"{name}-{digest}.so"


def build_all(names=SOURCES) -> dict[str, dict]:
    """Compile every library in ``names`` that is not built yet, all
    ``nvcc`` processes at once.  Returns {name: {"seconds" (that nvcc's own
    wall time), "ptxas", "path", "cached"}}; raises with nvcc's output if
    any build fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = nvcc_path() if any(not library_path(n).exists() for n in names) else None
    procs, info = {}, {}
    t0 = time.perf_counter()
    for name in names:
        out = library_path(name)
        if out.exists():
            info[name] = {"seconds": 0.0, "ptxas": "", "path": str(out), "cached": True}
            continue
        tmp = out.with_suffix(f".tmp{os.getpid()}.so")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, out)
    done = {}

    def wait(name, proc):   # each nvcc's own wall time
        log, _ = proc.communicate()
        done[name] = (log, time.perf_counter() - t0)

    threads = [threading.Thread(target=wait, args=(name, proc))
               for name, (proc, _, _) in procs.items()]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    failed = []
    for name, (proc, tmp, out) in procs.items():
        log, seconds = done[name]
        if proc.returncode != 0:
            failed.append(f"--- {name} (exit {proc.returncode}) ---\n{log}")
            continue
        os.replace(tmp, out)
        info[name] = {"seconds": seconds, "ptxas": log, "path": str(out),
                      "cached": False}
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
    return info


def ptxas_summary(log: str) -> list[dict]:
    """Per kernel entry of an ``nvcc -Xptxas -v`` log: its name (demangled
    where ``c++filt`` exists), registers, and spill stores / loads in
    bytes."""
    out, cur = [], None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            cur = {"kernel": m.group(1), "registers": None, "spill_stores": 0,
                   "spill_loads": 0}
            out.append(cur)
        elif cur is not None:
            m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
            if m:
                cur["spill_stores"], cur["spill_loads"] = int(m[1]), int(m[2])
            m = re.search(r"Used (\d+) registers", line)
            if m:
                cur["registers"] = int(m[1])
    filt = shutil.which("c++filt")
    if filt and out:
        names = subprocess.run([filt], input="\n".join(e["kernel"] for e in out),
                               capture_output=True, text=True).stdout.splitlines()
        if len(names) == len(out):
            for e, n in zip(out, names):
                e["kernel"] = n
    return out


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``name``, building it first if needed (one
    thread at a time: the overlapped engine prefills on a worker thread
    while its main thread decodes)."""
    with _LOAD_LOCK:
        lib = _LOADED.get(name)
        if lib is None:
            path = library_path(name)
            if not path.exists():
                build_all((name,))
            lib = ctypes.CDLL(str(path))
            _LOADED[name] = lib
    return lib


def check(err: int, what: str) -> None:
    """Raise on a nonzero cudaError_t returned by a C entry point."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err} at launch")
