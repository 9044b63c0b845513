"""Build and load the port's hand-written CUDA kernels.

Each kernel is one ``csrc/<name>.cu`` file with a plain C entry point; the
kernels share headers (``csrc/*.cuh``).  On first use it is compiled with
nvcc for Hopper into ``_build/lib<name>.so`` (rebuilt when any file under
``csrc/`` is newer, like tntblast_tpu/native) and loaded with ctypes.
Nothing here runs at import time: the CPU tests import every module of the
package on a machine without nvcc.
"""

import ctypes
import os
import re
import shutil
import subprocess
import tempfile
import threading

_HERE = os.path.dirname(os.path.abspath(__file__))
CSRC = os.path.join(_HERE, "csrc")
BUILD_DIR = os.path.join(_HERE, "_build")

# the kernels of the package, one csrc/<name>.cu each
KERNELS = ("seed", "seed_dense", "pool", "win_decode", "screen_dp",
           "screen_probe", "eval_pack", "kept")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-O3",
              "-std=c++17", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v"]
# flags of one kernel's every build: eval_pack's f32 sums are held against
# the plain version bit for bit, so nothing may be contracted (seed,
# seed_dense, pool, win_decode, kept and the DP kernels do integer
# arithmetic alone)
KERNEL_FLAGS = {"eval_pack": ("-fmad=false",)}

_lock = threading.Lock()
_libs = {}
build_log = {}      # kernel name -> nvcc output of the build (ptxas -v)


def _nvcc():
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    path = os.path.join(home, "bin", "nvcc")
    if os.path.exists(path):
        return path
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH)")


def sources_mtime(csrc=None):
    """The newest modification time of the files under csrc/: an edited
    header rebuilds every kernel that may include it."""
    csrc = csrc or CSRC
    return max(os.path.getmtime(os.path.join(root, f))
               for root, _, files in os.walk(csrc) for f in files)


def build(name, force=False, flags=(), tag="", csrc=None):
    """Compile csrc/<name>.cu unless the built library is up to date.
    Returns the library path; the compiler's output is kept in
    build_log[name + tag].  `flags` (extra nvcc arguments), `tag` (a suffix
    of the library's name) and `csrc` (another source directory) build a
    variant beside the kernel the package loads."""
    csrc = csrc or CSRC
    src = os.path.join(csrc, f"{name}.cu")
    lib = os.path.join(BUILD_DIR, f"lib{name}{tag}.so")
    if (not force and os.path.exists(lib)
            and os.path.getmtime(lib) >= sources_mtime(csrc)):
        return lib
    os.makedirs(BUILD_DIR, exist_ok=True)
    # build to a private file and rename: concurrent builds never load a
    # half-written library
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        proc = subprocess.run(
            [_nvcc(), *NVCC_FLAGS, *KERNEL_FLAGS.get(name, ()), *flags, src,
             "-o", tmp],
            capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}:\n{proc.stderr}")
        build_log[name + tag] = proc.stdout + proc.stderr
        os.replace(tmp, lib)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return lib


def load(name):
    """The ctypes handle of kernel library `name`, built on first use."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            lib = ctypes.CDLL(build(name))
            _libs[name] = lib
        return lib


def define(kernel, name):
    """The integer value of `#define name` in csrc/<kernel>.cu."""
    with open(os.path.join(CSRC, f"{kernel}.cu")) as fh:
        m = re.search(rf"^#define {name} (\d+)", fh.read(), re.M)
    if m is None:
        raise KeyError(f"csrc/{kernel}.cu defines no {name}")
    return int(m.group(1))


def ptxas_problems(log):
    """[(kernel, line)] of the kernels in an nvcc -Xptxas -v log whose
    previous row is meant to live in registers (every kernel but the
    *_wide_kernel ones) and that report a stack frame or spills."""
    bad = []
    lines = log.splitlines()
    for i, line in enumerate(lines):
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if not m or "wide_kernel" in m.group(1):
            continue
        for nxt in lines[i + 1:i + 4]:
            if "stack frame" in nxt and not re.search(
                    r"\b0 bytes stack frame, 0 bytes spill stores, "
                    r"0 bytes spill loads", nxt):
                bad.append((m.group(1), nxt.strip()))
    return bad


def ptxas_summary(log, pattern):
    """'kernel: registers, stack, spills' for kernels matching `pattern`."""
    out = []
    lines = log.splitlines()
    for i, line in enumerate(lines):
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m and re.search(pattern, m.group(1)):
            info = " ".join(x.split(":", 1)[-1].strip()
                            for x in lines[i + 1:i + 4]
                            if "stack frame" in x or "registers" in x)
            out.append(f"{m.group(1)}: {info}")
    return out
