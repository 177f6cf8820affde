"""Build the hand-written CUDA kernels and load them with ctypes.

Every ``csrc/*.cu`` file is compiled by ``nvcc`` for ``sm_90a``, one
``nvcc`` a source, all started together, and the objects are linked into one
shared library with a plain C interface, at first use, in the git-ignored
``csrc/build/`` directory beside the sources.  The library's name carries a
hash of the sources, the shared headers (``csrc/*.cuh``) and the flags, so
an edited source or header builds anew and an unchanged tree is loaded as
it is.  Nothing is built or loaded at import time:
this module is imported on machines with no CUDA toolkit, where only the
plain PyTorch versions of the kernels run.

Each kernel is a ``torch.library`` custom op in the ``uegan_torch``
namespace (:func:`custom_op`): its CUDA impl launches the kernel, its CPU
impl is the plain PyTorch version, and its fake kernel gives the output's
shape, dtype and strides without running either, so that ``torch.export``
(tools/export_model.py) traces a forward through the kernels and the
exported program launches the same kernels.  Importing ``uegan_tpu_torch.ops``
registers every op.
"""

from __future__ import annotations

import ctypes
import hashlib
import json
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path
from typing import Optional

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = CSRC / "build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
)

_P = ctypes.c_void_p
_I64 = ctypes.c_int64
_SIGNATURES = {
    # x, part, ticket, mean, std, mean32, var32, dtype, n, hw, c, vec, groups, splits, chunk,
    # eps, stream
    "uegan_gam_stats": [_P, _P, _P, _P, _P, _P, _P, ctypes.c_int, _I64, _I64, _I64, ctypes.c_int,
                        _I64, _I64, _I64, ctypes.c_float, _P],
    # x, dmean, dstd, mean32, var32, dx, dtype, n, hw, c, vec, groups, splits, chunk, eps,
    # stream
    "uegan_gam_stats_bwd": [_P, _P, _P, _P, _P, _P, ctypes.c_int, _I64, _I64, _I64, ctypes.c_int,
                            _I64, _I64, _I64, ctypes.c_float, _P],
    # x, out, dtype, n, h, w, c, vec, stream
    "uegan_upsample2x": [_P, _P, ctypes.c_int, _I64, _I64, _I64, _I64, ctypes.c_int, _P],
    # dy, dx, dtype, n, h, w, c (of dx), vec, groups, rows, grid, stream
    "uegan_upsample2x_bwd": [_P, _P, ctypes.c_int, _I64, _I64, _I64, _I64, ctypes.c_int,
                             ctypes.c_int, ctypes.c_int, _I64, _P],
    # x, out, in dtype, out dtype, n, h, w, c, pairs, in_word, out_word, in_span, smem, stream
    "uegan_s2d_convert": [_P, _P, ctypes.c_int, ctypes.c_int, _I64, _I64, _I64, _I64, _I64,
                          ctypes.c_int, ctypes.c_int, _I64, _I64, _P],
    # res, xp, out, dtype, n, hp, wp, c, stream
    "uegan_residual_tail_d2s": [_P, _P, _P, ctypes.c_int, _I64, _I64, _I64, _I64, _I64, _I64,
                                _P],
    # x, wts, w_scale, bias, mul, out, n, l, w, cin, cout, S, s0, act, requant,
    # inv_scale, vec_mul, stream
    "uegan_packed_conv_int8": [_P, _P, _P, _P, _P, _P, _I64, _I64, _I64, _I64, _I64,
                               ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                               ctypes.c_float, ctypes.c_int, _P],
    # x, wts, bias, out, dtype, n, l, w, cin, cout, S, s0, act, stream
    "uegan_packed_conv": [_P, _P, _P, _P, ctypes.c_int, _I64, _I64, _I64, _I64, _I64,
                          ctypes.c_int, ctypes.c_int, ctypes.c_int, _P],
    # a, b, out, n, h, w, pad, a's bytes a pixel, b's, word bytes, stream
    "uegan_reflect_pad": [_P, _P, _P, _I64, _I64, _I64, _I64, _I64, _I64, ctypes.c_int, _P],
    # dy, da, db, dtype, n, h, w, pad, c1, c2, vec, stream
    "uegan_reflect_pad_bwd": [_P, _P, _P, ctypes.c_int, _I64, _I64, _I64, _I64, _I64, _I64,
                              ctypes.c_int, _P],
    # x, y, part, ticket, mean, var, gamma, beta, run_mean, run_var, dtype, groups, rows, c,
    # vec, gt, splits, chunk, eps, slope, momentum, unbias, cap, stream
    "uegan_norm_act": [_P] * 10 + [ctypes.c_int, _I64, _I64, _I64, ctypes.c_int, _I64, _I64,
                                   _I64] + [ctypes.c_float] * 5 + [_P],
    # dy, x, dx, part, ticket, mean, var, gamma, beta, sdz, sdzx, dgamma, dbeta, dtype,
    # groups, rows, c, vec, gt, splits, chunk, eps, slope, cap, strict, stream
    "uegan_norm_act_bwd": [_P] * 13 + [ctypes.c_int, _I64, _I64, _I64, ctypes.c_int, _I64, _I64,
                                       _I64] + [ctypes.c_float] * 3 + [ctypes.c_int, _P],
}
ACTS = {"none": 0, "leaky": 1, "tanh": 2}  # the C entry points' act argument
# codes past the CUDA runtime's that the tensor-core body returns
# (csrc/packed_conv_body.cuh)
_BODY_ERRORS = {10001: "cuTensorMapEncodeTiled is not available",
                10002: "cuTensorMapEncodeTiled refused a tensor map"}

NAMESPACE = "uegan_torch"
# the ops' definitions, impls and backwards live as long as the process
ops_library = torch.library.Library(NAMESPACE, "DEF")

_lib: Optional[ctypes.CDLL] = None
_lib_lock = threading.Lock()  # one build and load, whichever thread launches first
ptxas_report: dict = {}


def nvcc_path() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    cands = [os.path.join(home, "bin", "nvcc")] if home else []
    cands += [shutil.which("nvcc") or "", "/usr/local/cuda/bin/nvcc"]
    for c in cands:
        if c and os.path.isfile(c):
            return c
    raise RuntimeError("nvcc not found (set CUDA_HOME); the CUDA kernels cannot be built")


def sources() -> list:
    return sorted(CSRC.glob("*.cu"))


def headers() -> list:
    return sorted(CSRC.glob("*.cuh"))


def library_path() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sources() + headers():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"libuegan_kernels-{h.hexdigest()[:16]}.so"


def _run_all(cmds: list) -> list:
    """Run the commands side by side; raise with every failure's output, else
    return each command's standard error."""
    procs = [(cmd, subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                                    text=True)) for cmd in cmds]
    failed, errs = [], []
    for cmd, proc in procs:
        _, err = proc.communicate()
        errs.append(err)
        if proc.returncode != 0:
            failed.append(f"nvcc failed ({proc.returncode}):\n{' '.join(cmd)}\n{err}")
    if failed:
        raise RuntimeError("\n".join(failed))
    return errs


def ptxas_report_path(lib: Path) -> Path:
    return lib.with_suffix(".ptxas.json")


def build() -> Path:
    """Compile the kernels if no library for the current sources exists:
    one nvcc a source, started together, then one link.  Each compile runs
    with ``-Xptxas -v`` (the code is the same); its registers, shared memory
    and spills per kernel are kept beside the library as JSON and loaded
    into ``ptxas_report`` ({source name: lines}) whether the library was
    built now or found."""
    out = library_path()
    report = ptxas_report_path(out)
    if not (out.exists() and report.exists()):
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        nvcc = nvcc_path()
        with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmpdir:
            objs = [os.path.join(tmpdir, src.stem + ".o") for src in sources()]
            errs = _run_all([[nvcc, *NVCC_FLAGS, "-Xptxas", "-v", "-c", str(src), "-o", obj]
                             for src, obj in zip(sources(), objs)])
            lines = {src.name: [ln for ln in err.splitlines() if "ptxas" in ln or "spill" in ln]
                     for src, err in zip(sources(), errs)}
            tmp_report = os.path.join(tmpdir, "ptxas.json")
            with open(tmp_report, "w") as f:
                json.dump(lines, f, indent=1)
            tmp = os.path.join(tmpdir, "lib.so")
            _run_all([[nvcc, *NVCC_FLAGS, "-shared", "-o", tmp, *objs]])
            # atomic, report first: a loader that sees the library sees its report
            os.replace(tmp_report, report)
            os.replace(tmp, out)
    with open(report) as f:
        ptxas_report.update(json.load(f))
    return out


def load() -> ctypes.CDLL:
    """The kernels' library, built on first use; raises if it cannot be built.
    Threads that launch at once (a server's request threads) wait for one build."""
    global _lib
    if _lib is not None:
        return _lib
    with _lib_lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            for name, argtypes in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            lib.uegan_tc_conv_smem_bytes.argtypes = []
            lib.uegan_tc_conv_smem_bytes.restype = ctypes.c_int
            lib.uegan_error_string.argtypes = [ctypes.c_int]
            lib.uegan_error_string.restype = ctypes.c_char_p
            _lib = lib
    return _lib


def check(lib: ctypes.CDLL, err: int, what: str) -> None:
    """Raise if a kernel's C entry point returned a CUDA error."""
    if err != 0:
        msg = _BODY_ERRORS.get(err) or lib.uegan_error_string(err).decode(errors="replace")
        raise RuntimeError(f"{what}: CUDA error {err} ({msg})")


def check_nhwc(x, what: str, batch_stride: bool = False) -> None:
    """Raise on any input the kernels do not take: they read a contiguous
    rank-4 NHWC float32 or bfloat16 tensor, or with ``batch_stride`` one
    whose images are each contiguous, a batch stride apart (a window of
    rows of every image of a contiguous batch)."""
    if x.dim() != 4:
        raise ValueError(f"{what}: expected a rank-4 NHWC tensor, got shape {tuple(x.shape)}")
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"{what}: dtype {x.dtype} is not float32 or bfloat16")
    _, h, w, c = x.shape
    rows_ok = x[0].is_contiguous() and (x.shape[0] == 1 or x.stride(0) >= h * w * c)
    if not (x.is_contiguous() or (batch_stride and rows_ok)):
        raise ValueError(f"{what}: input must be contiguous NHWC (strides {x.stride()})")
    if x.numel() == 0:
        raise ValueError(f"{what}: empty input of shape {tuple(x.shape)}")
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{what}: device {x.device} is neither cpu nor cuda")


def custom_op(schema: str, cpu, cuda, fake):
    """Define ``uegan_torch::<schema>`` with its CPU impl (the plain version),
    its CUDA impl (the launch, which counts itself) and its fake kernel, and
    return the op.  The ops are registered through ``torch.library.Library``
    rather than ``torch.library.custom_op``, whose Python wrapper costs more
    a call."""
    name = schema.split("(", 1)[0]
    ops_library.define(schema)
    ops_library.impl(name, cpu, "CPU")
    ops_library.impl(name, cuda, "CUDA")
    torch.library.register_fake(f"{NAMESPACE}::{name}", fake, lib=ops_library)
    return getattr(getattr(torch.ops, NAMESPACE), name).default


def fresh(out: torch.Tensor, *inputs: Optional[torch.Tensor],
          memory_format: torch.memory_format = torch.contiguous_format) -> torch.Tensor:
    """``out`` contiguous (in ``memory_format``) and sharing no memory with
    ``inputs`` (None ones skipped): a custom op's output may not alias its
    input, where a plain version's reshape or cast could."""
    out = out.contiguous(memory_format=memory_format)
    if any(t is not None and out.untyped_storage().data_ptr() == t.untyped_storage().data_ptr()
           for t in inputs):
        out = out.clone(memory_format=memory_format)
    return out


def eager_cuda(t: torch.Tensor) -> bool:
    """Whether a call on t runs eagerly on a card: a real CUDA tensor, not a
    trace's fake or functional one, and not under ``torch.compile``."""
    return t.is_cuda and type(t) is torch.Tensor and not torch.compiler.is_compiling()


def needs_grad(*tensors) -> bool:
    """Whether autograd would record a call on ``tensors``."""
    return torch.is_grad_enabled() and any(t is not None and t.requires_grad for t in tensors)


def refuse_grad(what: str, *tensors) -> None:
    """Raise where autograd would have to differentiate a kernel that has no
    backward: a launch writes its output through a raw pointer, so the
    result would carry no gradient and nothing would say so.  Kernels C-F
    run only under ``torch.no_grad`` or ``torch.inference_mode`` on every
    path; A and B have backward kernels (ops/gam_stats.py, ops/resize2x.py)."""
    if needs_grad(*tensors):
        raise RuntimeError(
            f"{what}: the CUDA kernel has no backward and its output would carry no gradient; "
            "call it under torch.no_grad() or torch.inference_mode(), or on tensors that do "
            "not require grad")


def dtype_code(x) -> int:
    """The C entry points' dtype argument: 0 = float32, 1 = bfloat16."""
    return 0 if x.dtype == torch.float32 else 1


def tma_operand(t: torch.Tensor, multiple: int) -> torch.Tensor:
    """``t`` (..., C) zero-padded on its last axis to a multiple of
    ``multiple`` channels and 16-byte aligned, as the tensor-core body's
    TMA loads need (16-byte row strides and base); ``t`` itself where it
    already is."""
    pad = -t.shape[-1] % multiple
    if pad:
        t = torch.nn.functional.pad(t, (0, pad))
    t = t.contiguous()
    if t.data_ptr() % 16:
        t = t.clone()
    return t
