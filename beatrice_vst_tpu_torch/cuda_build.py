"""Build and load the port's native code: the CUDA kernels (`nvcc` ->
shared library -> `ctypes`) and the host-edge library of the streaming
server (`csrc/beatrice_host.cc`, the host compiler -> shared library ->
`ctypes`).

Every source in `csrc/` has a plain `extern "C"` launcher and includes no
PyTorch header, so one `nvcc` call builds it in seconds (a source built
through `torch.utils.cpp_extension.load`, which compiles PyTorch's
headers, takes minutes).  Libraries are built at first use into
`_build/` beside this file, named by a hash of the source, the headers
in `csrc/` and the flags, so an edited source or header is rebuilt and an
unchanged one is reused.  The host library is built the same way with
`g++` (or $CXX) and the flags of `native/Makefile`; a failed build raises.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)
HOST_FLAGS = ("-O3", "-march=native", "-fPIC", "-std=c++17", "-shared")


def nvcc_path() -> str:
    """The CUDA compiler: `nvcc` on PATH, else under $CUDA_HOME (default
    /usr/local/cuda, the toolkit's standard install location)."""
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    path = Path(home) / "bin" / "nvcc"
    if not path.exists():
        raise RuntimeError("nvcc not found: put it on PATH or set CUDA_HOME")
    return str(path)


def library_path(name: str) -> Path:
    """Where the library of `csrc/<name>.cu` is (or will be) built: named
    by a hash of the source, every header in `csrc/` (sorted by name) and
    the flags, so that an edited header rebuilds too."""
    digest = hashlib.sha256()
    for path in [CSRC / f"{name}.cu", *sorted(CSRC.glob("*.cuh"))]:
        digest.update(path.name.encode() + b"\0" + path.read_bytes() + b"\0")
    digest.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{digest.hexdigest()[:16]}.so"


def build(names) -> dict[str, str]:
    """Build the libraries of the given sources that are not built yet,
    one `nvcc` process per source, all started together.  Returns each
    name's compiler log (register and shared-memory use from -Xptxas -v),
    kept beside the library, so a library built earlier gives its log too;
    raises with the log if a build fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs, logs = {}, {}
    for name in names:
        out = library_path(name)
        if out.exists():
            log = out.with_suffix(".log")
            logs[name] = log.read_text() if log.exists() else ""
            continue
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, out)
    failed = []
    for name, (proc, tmp, out) in procs.items():
        logs[name] = proc.communicate()[0]
        if proc.returncode != 0:
            failed.append(name)
        else:
            out.with_suffix(".log").write_text(logs[name])
            os.replace(tmp, out)
    if failed:
        raise RuntimeError("nvcc failed for " + ", ".join(failed) + ":\n"
                           + "\n".join(logs[n] for n in failed))
    return logs


@functools.lru_cache(maxsize=None)
def load_library(name: str) -> ctypes.CDLL:
    """Build (if needed) and load `csrc/<name>.cu` as a ctypes library."""
    build([name])
    return ctypes.CDLL(str(library_path(name)))


def sass(name: str) -> str:
    """The SASS (machine code) of the library of `csrc/<name>.cu`, built if
    needed, as `cuobjdump -sass` prints it (cuobjdump comes with nvcc)."""
    build([name])
    tool = Path(nvcc_path()).with_name("cuobjdump")
    return subprocess.run([str(tool), "-sass", str(library_path(name))], capture_output=True,
                          text=True, check=True).stdout


def host_compiler() -> str:
    """The host C++ compiler: $CXX, else `g++`, resolved on PATH."""
    name = os.environ.get("CXX") or "g++"
    found = shutil.which(name)
    if not found:
        raise RuntimeError(f"host compiler {name!r} not found: put g++ on PATH or set CXX")
    return found


def host_library_path(name: str, compiler: str) -> Path:
    """Where the library of `csrc/<name>.cc` built by `compiler` is (or
    will be): named by a hash of the source, the compiler and the flags."""
    digest = hashlib.sha256((CSRC / f"{name}.cc").read_bytes())
    digest.update(("\0".join((compiler, *HOST_FLAGS))).encode())
    return BUILD_DIR / f"lib{name}-{digest.hexdigest()[:16]}.so"


def build_host(name: str, compiler: str | None = None) -> Path:
    """Build `csrc/<name>.cc` with `compiler` (the host compiler when not
    given) if it is not built yet; returns the library's path and raises
    with the compiler's output if the build fails."""
    compiler = compiler or host_compiler()
    out = host_library_path(name, compiler)
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    proc = subprocess.run([compiler, *HOST_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cc")],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"{compiler} failed for {name}.cc:\n{proc.stdout}{proc.stderr}")
    os.replace(tmp, out)
    return out
