"""Builds and loads the package's CUDA kernels.

The sources under ``csrc/`` are compiled by ``nvcc`` for ``sm_90a`` at
first use into one shared library with a plain C interface, loaded with
``ctypes``. One ``nvcc -c`` runs per source, all started together; the
objects are then linked. The library is cached in ``build/`` at the root
of the checkout (override: ``NGSF_TORCH_BUILD_DIR``) under a name that
hashes the sources and flags, so an edited source rebuilds.

Nothing here runs at import: the CPU tests import every module of the
package on a machine without a CUDA toolkit.

``LAUNCHES[name]`` counts the launches of each kernel (incremented by its
wrapper where it launches, nowhere else); ``PLAIN_CALLS[name]`` counts
the calls of each kernel's plain PyTorch version.
"""

import collections
import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import tempfile

import torch

CSRC = pathlib.Path(__file__).resolve().parents[1] / "csrc"
# The four chain-kernel sources each export three instantiations of one
# template: the gl-layout kernel on float32 and on bfloat16 ("_bf16") gl
# slabs, and the emission-slab ("_v1") kernel. maf_state_grad, maf_sums_grad
# and maf_macro export a float32 and a bfloat16 gl instantiation.
SOURCES = (
    "block_transfer.cu",
    "block_transfer_grad.cu",
    "bw_sites.cu",
    "fw_post.cu",
    "combine_blocks.cu",
    "viterbi.cu",
    "maf_state_grad.cu",
    "maf_sums_grad.cu",
    "maf_window.cu",
    "maf_exact.cu",
    "maf_macro.cu",
)
HEADERS = ("gl_load.cuh", "hmm_common.cuh", "maf_common.cuh")
# chunks of one CTA of the two-level combine: csrc/combine_blocks.cu is
# built with it (CB_MAXC), models/hmm_kernels.py sizes its chunks by it
COMBINE_MAX_CHUNKS = 128
# -fmad=false: the grad kernel's primal rows must equal the transfer
# kernel's output bit for bit, so nvcc may not contract the two streams'
# multiply-adds differently.
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-fmad=false", "-Xcompiler", "-fPIC", f"-DCB_MAXC={COMBINE_MAX_CHUNKS}",
)

LAUNCHES = collections.Counter()
PLAIN_CALLS = collections.Counter()

_libs = {}  # flags -> loaded library
build_log = []  # one (source, nvcc stderr) pair per compiled source

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_SIGNATURES = {
    "ngsf_block_transfer": [_P] * 7 + [_I] * 4 + [_P],
    "ngsf_block_transfer_grad": [_P] * 7 + [_I] * 3 + [_P],
    "ngsf_bw_sites": [_P] * 8 + [_I] * 3 + [_P],
    "ngsf_fw_post": [_P] * 9 + [_I] * 3 + [_P],
    "ngsf_block_transfer_v1": [_P] * 6 + [_I] * 4 + [_P],
    "ngsf_block_transfer_grad_v1": [_P] * 6 + [_I] * 3 + [_P],
    "ngsf_bw_sites_v1": [_P] * 7 + [_I] * 3 + [_P],
    "ngsf_fw_post_v1": [_P] * 8 + [_I] * 3 + [_P],
    "ngsf_combine_blocks": [_P, _L, _L, _L] + [_P] * 4 + [_I] * 4 + [_P],
    "ngsf_viterbi_f32": [_P] * 10 + [_I] * 4 + [_P],
    "ngsf_viterbi_f64": [_P] * 10 + [_I] * 4 + [_P],
    "ngsf_maf_state_grad": [_P] * 4 + [_L] + [_I] * 4 + [_P],
    "ngsf_maf_sums_grad": [_P] * 5 + [_L, _I, _P],
    "ngsf_maf_window": [_P] * 3 + [_L, _I, _I, _P],
    "ngsf_maf_exact": [_P] * 4 + [_L] + [_I] * 4 + [_P],
    "ngsf_maf_macro": [_P] * 4 + [_L, _I, _I, _P] + [_I] * 3 + [_P],
}
# the bfloat16 gl exports take the same arguments as their float32 ones
_SIGNATURES.update({
    f"{name}_bf16": _SIGNATURES[name] for name in (
        "ngsf_block_transfer", "ngsf_block_transfer_grad", "ngsf_bw_sites",
        "ngsf_fw_post", "ngsf_maf_state_grad", "ngsf_maf_sums_grad",
        "ngsf_maf_macro")})


def reset_counts():
    LAUNCHES.clear()
    PLAIN_CALLS.clear()


def build_dir():
    env = os.environ.get("NGSF_TORCH_BUILD_DIR")
    if env:
        return pathlib.Path(env)
    return CSRC.parents[1] / "build" / "ngsf_hmm_tpu_torch"


def _nvcc():
    exe = shutil.which("nvcc")
    if exe is None and os.path.exists("/usr/local/cuda/bin/nvcc"):
        exe = "/usr/local/cuda/bin/nvcc"
    if exe is None:
        raise RuntimeError(
            "nvcc not found: the CUDA kernels build at first use and need "
            "the CUDA toolkit on PATH or under /usr/local/cuda"
        )
    return exe


def _digest(flags):
    h = hashlib.sha256()
    for name in HEADERS + SOURCES:
        h.update(name.encode())
        h.update((CSRC / name).read_bytes())
    h.update(" ".join(flags).encode())
    return h.hexdigest()[:16]


def build(flags=NVCC_FLAGS):
    """Compile the sources (in parallel) with `flags` and link them;
    returns the path of the shared library. A library already built from
    the same sources and flags is reused."""
    flags = tuple(flags)
    out_dir = build_dir()
    out_dir.mkdir(parents=True, exist_ok=True)
    lib_path = out_dir / f"libngsf_hmm_{_digest(flags)}.so"
    if lib_path.exists():
        return lib_path
    nvcc = _nvcc()
    with tempfile.TemporaryDirectory(dir=out_dir) as tmp:
        procs = []
        for name in SOURCES:
            obj = os.path.join(tmp, name + ".o")
            cmd = [nvcc, *flags, "-I", str(CSRC), "-c",
                   str(CSRC / name), "-o", obj]
            procs.append((name, obj, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                text=True)))
        objs = []
        for name, obj, proc in procs:
            out, err = proc.communicate()
            build_log.append((name, err))
            if proc.returncode != 0:
                for _, _, other in procs:
                    if other.poll() is None:
                        other.kill()
                raise RuntimeError(f"nvcc failed on {name}:\n{out}\n{err}")
            objs.append(obj)
        tmp_lib = os.path.join(tmp, "lib.so")
        link = subprocess.run(
            [nvcc, "-shared", "-gencode", "arch=compute_90a,code=sm_90a",
             "-o", tmp_lib, *objs],
            capture_output=True, text=True)
        if link.returncode != 0:
            raise RuntimeError(f"nvcc link failed:\n{link.stdout}\n{link.stderr}")
        os.replace(tmp_lib, lib_path)
    return lib_path


def load(flags=NVCC_FLAGS):
    """The loaded library (built on first call). The package runs the one
    built with NVCC_FLAGS; other flags give a second library for
    measurements."""
    flags = tuple(flags)
    if flags not in _libs:
        lib = ctypes.CDLL(str(build(flags)))
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        _libs[flags] = lib
    return _libs[flags]


def stream():
    return torch.cuda.current_stream().cuda_stream


def check(rc, name):
    if rc != 0:
        raise RuntimeError(f"CUDA kernel {name} failed to launch (error {rc})")


def gl_suffix(g0, g2, name):
    """The export suffix of a kernel that reads gl slabs g0 / g2: "" for
    float32 slabs, "_bf16" for bfloat16 ones (upcast at load). The
    launch counts use the same suffix. Raises for any other dtype, or
    for g0 and g2 of different dtypes."""
    sfx = {torch.float32: "", torch.bfloat16: "_bf16"}.get(g0.dtype)
    if sfx is None or g2.dtype != g0.dtype:
        raise TypeError(f"{name}: gl slabs must be both float32 or both "
                        f"bfloat16, got {g0.dtype} and {g2.dtype}")
    return sfx


def count_plain(name, g0):
    """Counts one call of a plain version that reads the gl slab g0, under
    its kernel's name with "_bf16" for bfloat16 slabs."""
    PLAIN_CALLS[name + ("_bf16" if g0.dtype == torch.bfloat16 else "")] += 1


def upcast(t):
    """A bfloat16 gl slab as float32 (exact), as the kernels load it; any
    other dtype as it is (the plain versions also run in float64)."""
    return t.float() if t.dtype == torch.bfloat16 else t


def require(t, name, dtype, shape=None):
    """Raise unless t is a contiguous CUDA tensor of the dtype (and shape)."""
    if not t.is_cuda:
        raise ValueError(f"{name}: expected a CUDA tensor, got {t.device}")
    if t.dtype != dtype:
        raise TypeError(f"{name}: expected {dtype}, got {t.dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: tensor must be contiguous")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(
            f"{name}: expected shape {tuple(shape)}, got {tuple(t.shape)}")
