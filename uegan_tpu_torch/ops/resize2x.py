"""x2 bilinear align-corners upsample kernel (NHWC).

Port of uegan_tpu/ops/pallas/resize2x.py:upsample2x_ac_pallas to a CUDA
kernel for Hopper (csrc/upsample2x.cu; the design note is in its header).
``upsample2x`` launches the kernel for a CUDA tensor and raises if it
cannot; for a CPU tensor it runs ``plain``, the PyTorch version of the same
function.  ``upsample2x.launches`` counts kernel launches.
"""

from __future__ import annotations

import torch

from uegan_tpu_torch.ops import _build
from uegan_tpu_torch.ops.resize import upsample2x_align_corners as plain

_GRID_YZ_MAX = 65535  # CUDA's limit on gridDim.y (output rows) and gridDim.z (batch)


def vector_width(x: torch.Tensor, out: torch.Tensor) -> int:
    """Channels per thread: a 16-byte pack where C and both pointers allow it."""
    v = 16 // x.element_size()
    aligned = x.data_ptr() % 16 == 0 and out.data_ptr() % 16 == 0
    return v if x.shape[-1] % v == 0 and aligned else 1


def upsample2x(x: torch.Tensor) -> torch.Tensor:
    """x (N, H, W, C) contiguous, float32 or bfloat16 -> (N, 2H, 2W, C) in
    x.dtype, torch bilinear ``align_corners=True`` semantics, f32 math."""
    _build.check_nhwc(x, "upsample2x")
    if x.device.type == "cpu":
        return plain(x)
    n, h, w, c = x.shape
    if n > _GRID_YZ_MAX or 2 * h > _GRID_YZ_MAX:
        raise ValueError(f"upsample2x: shape {tuple(x.shape)} exceeds the kernel's grid")
    lib = _build.load()
    with torch.cuda.device(x.device):
        out = torch.empty((n, 2 * h, 2 * w, c), dtype=x.dtype, device=x.device)
        err = lib.uegan_upsample2x(
            x.data_ptr(), out.data_ptr(), _build.dtype_code(x), n, h, w, c,
            vector_width(x, out), torch.cuda.current_stream().cuda_stream,
        )
    _build.check(lib, err, "upsample2x")
    upsample2x.launches += 1
    return out


upsample2x.launches = 0
