"""Export the inference forward as a ``torch.export`` program, counterpart of
uegan_tpu/tools/export_model.py.

The JAX tool serializes ``make_fast_eval``'s forward with the weights baked
in as a StableHLO artifact.  This one exports the port's
``infer/packed.py:make_fast_eval`` forward with ``torch.export.export`` at
the static ``(batch, hw, hw, 3)`` input and saves the ``ExportedProgram``
(``torch.export.save``, a ``.pt2`` file) with the weights and the packed
(and quantized) kernels in it.  The route is ``make_fast_eval``'s: packed
under the default config, the int8 forward under ``--quantized``
(calibrated eagerly first, on JAX's seeded batch, as the Tester and the
server calibrate), and at ``--hw 2048`` and up the strip executor, by its
own gate.  The program calls the hand-written kernels as the custom ops
of ``uegan_tpu_torch.ops`` (``uegan_torch::s2d_convert`` and the rest), so
on a card it launches the same CUDA kernels as the eager forward.

Usage:
  python -m uegan_tpu_torch.tools.export_model --out uegan_512.pt2 \\
      [--ckpt results/UEGAN-FiveK/models/UEGAN-FiveK_rahinge_92.pth] \\
      [--hw 512] [--batch 16] [--quantized int8|int8_pallas] \\
      [--compute_dtype bfloat16] [--u8_io] [--platform cpu]

Load + run (torch and this package required):
  from uegan_tpu_torch.tools.export_model import load_exported
  fn = load_exported("uegan_512.pt2")
  out = fn(x)   # (batch, hw, hw, 3) in [-1, 1] -> enhanced, same shape

Where JAX's artifact needs only jax, this one needs torch and
``uegan_tpu_torch.ops``: importing it registers the kernels' custom ops,
and the first call on a card builds the kernel library from the
package's CUDA sources (nvcc).  The program runs on the device it was
exported on: the card (``UEGAN_TORCH_DEVICE``, default ``cuda``) unless
``--platform cpu`` asks for the CPU, where the ops run their plain PyTorch
versions.  It is one device's program, so ``--platforms`` takes one entry.
A ``.pth`` checkpoint gives G's weights (its EMA copy where it keeps one,
``Config.ema_eval``); without one G is seeded as the Tester seeds it.  An
orbax directory is refused with the ``orbax_to_pth.py`` command that
exports it.  ``--u8_io`` makes a serving program: uint8 pixels in and out,
normalized and quantized on the device inside the program
(``utils/image_io.py``).
"""

from __future__ import annotations

import argparse
import os
from typing import Callable

import torch

PLATFORMS = {"cpu": "cpu", "gpu": "cuda", "cuda": "cuda"}


class _Forward(torch.nn.Module):
    """The exported module: G (so its weights are the program's parameters)
    and ``make_fast_eval``'s forward, between the u8 normalize and quantize
    under ``u8_io``."""

    def __init__(self, g: torch.nn.Module, fn: Callable, u8_io: bool):
        super().__init__()
        self.g, self.fn, self.u8_io = g, fn, u8_io

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        from uegan_tpu_torch.utils.image_io import normalize_u8, quantize_u8

        if self.u8_io:
            return quantize_u8(self.fn(normalize_u8(x)))
        return self.fn(x)


def _device(platforms: tuple) -> torch.device:
    from uegan_tpu_torch.utils.device import resolve_device

    if len(platforms) > 1:
        raise ValueError(f"--platforms {','.join(platforms)}: a torch.export program holds "
                         "one device's weights and runs there; export once for each device")
    if platforms and platforms[0] not in PLATFORMS:
        raise ValueError(f"--platforms {platforms[0]!r}: one of {sorted(PLATFORMS)}")
    return resolve_device(PLATFORMS[platforms[0]] if platforms else None)


def _generator(cfg, ckpt: str, out_path: str, device: torch.device):
    """G of ``cfg`` with the weights of the ``.pth`` ``ckpt`` (seeded as the
    Tester seeds it without one), on ``device`` in eval mode."""
    from uegan_tpu_torch.infer.packed import served_generator
    from uegan_tpu_torch.utils.checkpoint import generator_state, load_pth, orbax_refusal

    sd = None
    if os.path.isdir(ckpt):
        stem = os.path.splitext(os.path.abspath(out_path))[0]
        raise NotImplementedError(orbax_refusal(ckpt, stem + "_G.pth"))
    if ckpt.endswith(".pth"):
        sd = generator_state(load_pth(ckpt), ema=cfg.ema_eval)
    elif ckpt:
        raise FileNotFoundError(f"--ckpt {ckpt!r} is neither a .pth file nor an orbax "
                                "checkpoint directory")
    return served_generator(cfg, sd, device).eval()


def export_generator(out_path: str, ckpt: str = "", hw: int = 512, batch: int = 16,
                     quantized: str = "", compute_dtype: str = "bfloat16",
                     platforms: tuple = (), u8_io: bool = False) -> int:
    """Export the inference forward to ``out_path``; returns its size in bytes."""
    from uegan_tpu_torch.config import Config
    from uegan_tpu_torch.infer.packed import make_fast_eval

    device = _device(tuple(platforms))
    cfg = Config(compute_dtype=compute_dtype, quantized_inference=quantized).validate()
    g = _generator(cfg, ckpt, out_path, device)
    fn = make_fast_eval(g, cfg)  # the int8 route calibrates here, eagerly
    x = torch.zeros((batch, hw, hw, 3), dtype=torch.uint8 if u8_io else torch.float32,
                    device=device)
    module = _Forward(g, fn, u8_io)
    # one eager call first: the forward's per-shape state (the strip
    # executor of this shape, its constants) is made from real tensors,
    # and the trace records them as constants
    with torch.inference_mode():
        module(x)
    program = torch.export.export(module, (x,))
    program.example_inputs = None  # else the file carries the (zero) example batch
    torch.export.save(program, out_path)
    return os.path.getsize(out_path)


def load_exported(path: str) -> Callable[[torch.Tensor], torch.Tensor]:
    """Load an exported program; returns ``fn(x) -> enhanced``, run under
    ``torch.inference_mode()`` on the device it was exported on, with the
    ``ExportedProgram`` itself as ``fn.program``."""
    import uegan_tpu_torch.ops  # noqa: F401  registers the ops the program calls

    program = torch.export.load(path)
    module = program.module()

    def fn(x: torch.Tensor) -> torch.Tensor:
        with torch.inference_mode():
            return module(x)

    fn.program = program
    return fn


def kernel_calls(program) -> dict:
    """How often the program's graph calls each kernel's op, by op name."""
    calls: dict = {}
    for node in program.graph.nodes:
        target = str(node.target).split(".")
        if node.op == "call_function" and target[0] == "uegan_torch":
            calls[target[1]] = calls.get(target[1], 0) + 1
    return calls


def main(argv=None) -> None:
    p = argparse.ArgumentParser(prog="export-model")
    p.add_argument("--out", required=True)
    p.add_argument("--ckpt", default="", help=".pth checkpoint (an orbax dir is refused)")
    p.add_argument("--hw", type=int, default=512)
    p.add_argument("--batch", type=int, default=16)
    p.add_argument("--quantized", default="", help="'', 'int8' or 'int8_pallas'")
    p.add_argument("--compute_dtype", default="bfloat16")
    p.add_argument("--platforms", default="",
                   help="one device to export for (cpu or cuda); empty = --platform, else "
                        "UEGAN_TORCH_DEVICE (default cuda)")
    p.add_argument("--platform", default="", help="the device, as --platforms")
    p.add_argument("--u8_io", action="store_true",
                   help="uint8-in/uint8-out serving program (normalize and quantize on "
                        "the device)")
    a = p.parse_args(argv)
    plats = tuple(s for s in a.platforms.split(",") if s) or tuple(s for s in [a.platform] if s)
    n = export_generator(a.out, a.ckpt, a.hw, a.batch, a.quantized, a.compute_dtype, plats,
                         u8_io=a.u8_io)
    print(f"exported {a.hw}px batch-{a.batch} forward to {a.out} ({n / 1e6:.2f} MB)")


if __name__ == "__main__":
    main()
