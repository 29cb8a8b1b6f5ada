"""Build, load and launch the port's hand-written CUDA kernels.

Each ``csrc/<name>.cu`` compiles with ``nvcc`` into its own shared
library with a plain C interface (headers such as ``supports.cuh`` are
included, not built) (no PyTorch headers, so a build takes
seconds), loaded through ``ctypes``. Builds happen at first use, never
at import, into ``_build/<content hash>/`` next to this file: the hash
covers every source under ``csrc/`` and the compiler flags, so an edit
rebuilds and an unchanged tree reuses what is there. ``build_all``
starts one ``nvcc`` per missing library, all at once, and waits for
them together.

Every C launcher takes its pointers and the CUDA stream as
``c_void_p`` (ctypes would otherwise pass them as 32-bit ints), returns
``cudaGetLastError()`` after the launch, and allocates nothing; the
Python wrappers allocate outputs with ``torch.empty`` and raise when the
returned code is not 0. ``LaunchCounter``s count the launches that
succeeded, one per wrapper.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, Iterable, Optional, Tuple

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parent / "_build"
SOURCES = ("gram", "gram_q8", "ensemble_score", "sdca", "gram_matvec",
           "flash_attention", "flash_attention_tc", "flash_attention_tc_f16")
# csrc/<name>.cu -> lib<name>.so
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
SIGNATURES: Dict[str, Dict[str, list]] = {
    "gram": {
        # x1, x2, gammas, out, g, m, n, d, rows, staged, stream
        "batched_rbf_gram_launch": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P],
        # x1, x2, gamma, out, m, n, d, rows, staged, stream
        "rbf_gram_launch": [_P, _P, _F, _P, _I, _I, _I, _I, _I, _P],
    },
    "gram_q8": {
        # x, q, scale, zero, gamma, out, planes, norms, m, n, d, per_split,
        # splits, stream
        "rbf_gram_q8_launch": [_P, _P, _P, _P, _F, _P, _P, _P, _I, _I, _I, _I, _I, _P],
        # the same arguments: the chunked route at any d
        "rbf_gram_q8_chunked_launch": [_P, _P, _P, _P, _F, _P, _P, _P, _I, _I, _I, _I, _I, _P],
        "rbf_gram_q8_chunked_smem_bytes": [],
        # m; n; d
        "rbf_gram_q8_padded_rows": [_I],
        "rbf_gram_q8_padded_supports": [_I],
        "rbf_gram_q8_slab_dim": [_I],
    },
    "ensemble_score": {
        # x, sup, coef, gammas, norms, partial, out, b, k, n_max, d, per_split,
        # splits, stream
        "ensemble_score_launch": [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P],
        # x, q, scale, zero, coef, gammas, norms, partial, out, b, k, n_max, d,
        # per_split, splits, stream
        "ensemble_score_q8_launch": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                                     _I, _P],
        # the same arguments as the two above: the chunked partials kernel at any d
        "ensemble_score_chunked_launch": [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                                          _P],
        "ensemble_score_q8_chunked_launch": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I,
                                             _I, _I, _I, _P],
        "ensemble_score_smem_bytes": [_I],
        "ensemble_score_chunked_smem_bytes": [],
        "ensemble_score_q8_chunked_smem_bytes": [],
    },
    "sdca": {
        # K, y, n_real, alpha, g, b, lam, epochs, stream
        "sdca_launch": [_P, _P, _P, _P, _I, _I, _F, _I, _P],
        # the same arguments: the cluster kernel at any bucket
        "sdca_cluster_launch": [_P, _P, _P, _P, _I, _I, _F, _I, _P],
        "sdca_smem_bytes": [_I],
        "sdca_cluster_smem_bytes": [_I],
    },
    "gram_matvec": {
        # x1, x2, v, gamma, partial, out, planes, norms, m, n, d, per_split,
        # splits, stream
        "gram_matvec_launch": [_P, _P, _P, _F, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P],
        # the same arguments: the chunked route at any d
        "gram_matvec_chunked_launch": [_P, _P, _P, _F, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                                       _P],
        "gram_matvec_smem_bytes": [_I],
        "gram_matvec_chunked_smem_bytes": [],
        # m, n, x2 is x1; d
        "gram_matvec_scratch_rows": [_I, _I, _I],
        "gram_matvec_padded_dim": [_I],
    },
    "flash_attention": {
        # q, k, v, o, B, Sq, Skv, H, K, hd, causal, window, scale, stream (float32)
        "flash_attention_launch": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _F, _P],
    },
    "flash_attention_tc": {
        # the same arguments, bfloat16
        "flash_attention_tc_launch": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _F, _P],
    },
    "flash_attention_tc_f16": {
        # the same arguments, float16
        "flash_attention_tc_f16_launch": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _F,
                                          _P],
    },
}

# shared memory a block may take on sm_90 (227 KB of the SM's 256 KB)
MAX_SMEM_BYTES = 232448

_LIBS: Dict[str, ctypes.CDLL] = {}
_LOCK = threading.Lock()


class LaunchCounter:
    """Launches of one kernel wrapper since the last ``reset``."""

    __slots__ = ("name", "count")

    def __init__(self, name: str):
        self.name = name
        self.count = 0

    def reset(self) -> None:
        self.count = 0


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    toolkit = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if toolkit.exists():
        return str(toolkit)
    raise RuntimeError("nvcc not found: the CUDA kernels build with the CUDA "
                       "toolkit's nvcc, on PATH or under $CUDA_HOME/bin")


def source_hash() -> str:
    h = hashlib.sha256()
    for path in sorted(CSRC.iterdir()):
        h.update(path.name.encode())
        h.update(path.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return h.hexdigest()[:16]


def build_dir() -> Path:
    return BUILD_ROOT / source_hash()


def build_all(names: Iterable[str] = SOURCES) -> Dict[str, str]:
    """Compile every named library that is not built yet, one ``nvcc``
    per source, all started together. Returns name -> compiler output
    (``-Xptxas -v``: registers, shared memory, spills) for those built;
    raises with the compiler's output if any build fails."""
    out_dir = build_dir()
    out_dir.mkdir(parents=True, exist_ok=True)
    todo = [n for n in names if not (out_dir / f"lib{n}.so").exists()]
    if not todo:
        return {}
    nvcc = _nvcc()
    procs = {}
    for name in todo:
        tmp = out_dir / f"lib{name}.so.{os.getpid()}.tmp"
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    logs, failed = {}, []
    for name, (tmp, proc) in procs.items():
        logs[name], _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(name)
            tmp.unlink(missing_ok=True)
        else:
            os.replace(tmp, out_dir / f"lib{name}.so")
    if failed:
        raise RuntimeError("nvcc failed for " + ", ".join(failed) + ":\n"
                           + "\n".join(logs[n] for n in failed))
    return logs


def library(name: str) -> ctypes.CDLL:
    """The loaded library ``lib<name>.so``, built first if needed."""
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            path = build_dir() / f"lib{name}.so"
            if not path.exists():
                build_all([name])
            lib = ctypes.CDLL(str(path))
            for fn, argtypes in SIGNATURES[name].items():
                getattr(lib, fn).argtypes = argtypes
                getattr(lib, fn).restype = ctypes.c_int
            _LIBS[name] = lib
        return lib


def refuse_grad(name: str, **tensors: torch.Tensor) -> None:
    """A kernel has no backward, so raise when grad mode is on and a
    tensor requires grad: the output would carry no ``grad_fn`` and cut
    the gradient silently."""
    if torch.is_grad_enabled():
        needs = [arg for arg, t in tensors.items() if t.requires_grad]
        if needs:
            verb = "requires" if len(needs) == 1 else "require"
            raise RuntimeError(
                f"{name}: {', '.join(needs)} {verb} grad, but the CUDA kernel has no "
                "backward (the reference has no backward kernel for any Pallas kernel "
                "either): call it under torch.no_grad(), or train with "
                "use_pallas=False as the reference does")


def check_device(name: str, device: torch.device, **tensors: torch.Tensor) -> None:
    """Raise unless ``device`` is a CUDA device and every tensor is on it."""
    if device.type != "cuda":
        raise ValueError(f"{name}: the CUDA kernel takes CUDA tensors, got {device}")
    for arg, t in tensors.items():
        if t.device != device:
            raise ValueError(f"{name}: {arg} is on {t.device}, expected {device}")


def _castable(t: torch.Tensor, want: torch.dtype) -> bool:
    """The reference's ``astype``: a float slot takes any real type; an
    integer slot (int8 codes, int32 counts) any integer type."""
    if t.dtype == torch.bool or t.is_complex():
        return False
    return want.is_floating_point or not t.is_floating_point()


def prepare(name: str, device: torch.device, dtypes: Optional[Dict[str, torch.dtype]] = None,
            **tensors: torch.Tensor) -> Tuple[torch.Tensor, ...]:
    """The tensors as the kernel reads them (``kernel_inputs``), after
    ``refuse_grad`` and ``check_device``."""
    refuse_grad(name, **tensors)
    check_device(name, device, **tensors)
    return kernel_inputs(name, dtypes, **tensors)


def kernel_inputs(name: str, dtypes: Optional[Dict[str, torch.dtype]] = None,
                  **tensors: torch.Tensor) -> Tuple[torch.Tensor, ...]:
    """The tensors in the order given, each as the kernel reads it. A
    tensor of another type than the kernel's (``dtypes[arg]``, float32
    where the wrapper names none) is cast to it, as the reference's
    kernels cast with ``astype``; then a tensor that is not contiguous or
    does not start on a 16-byte boundary (the kernels' ``cp.async`` rows)
    gets one contiguous, aligned copy. A tensor that needs neither comes
    back as it is, so a call from the port's own paths copies nothing; a
    tensor passed twice (a fit's x1 as x2) stays one tensor."""
    dtypes = dtypes or {}
    done: Dict[int, torch.Tensor] = {}
    out = []
    for arg, t in tensors.items():
        if id(t) not in done:
            want = dtypes.get(arg, torch.float32)
            u = t
            if u.dtype != want:
                if not _castable(u, want):
                    raise TypeError(f"{name}: {arg} must be {want}, got {u.dtype}")
                u = u.to(want, memory_format=torch.contiguous_format)
            if not u.is_contiguous() or u.data_ptr() % 16:
                u = u.clone(memory_format=torch.contiguous_format)
            done[id(t)] = u
        out.append(done[id(t)])
    return tuple(out)


def stream_handle(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def launch(counter: LaunchCounter, device: torch.device, fn, *args) -> None:
    """Run one C launcher on ``device``; raise on a CUDA error code,
    count the launch otherwise."""
    with torch.cuda.device(device):
        rc = fn(*args, stream_handle(device))
    if rc != 0:
        raise RuntimeError(f"{counter.name}: kernel launch failed with CUDA error {rc}")
    counter.count += 1
