"""PyTorch port: the kernels as ``torch.library`` custom ops and
``uegan_tpu_torch/tools/export_model.py``, against the JAX package's
``uegan_tpu/tools/export_model.py`` on the same ``.pth``.

- ``torch.library.opcheck`` on every op through its CPU impl (the plain
  version), at the verify fixture's sizes (cd 8, 32 px);
- the exported forward at cd 32 (the tool's default generator, as JAX's),
  32 px, batch 2, float32 (the shapes of tests/test_checkpoint.py's JAX
  round trips), loaded in a fresh interpreter that loads no ``jax*`` and no
  ``uegan_tpu`` module: bit-equal to the port's eager ``make_fast_eval``
  and within 1e-4 of JAX's artifact; the ``--u8_io`` program bit-equal in
  u8 to the eager u8 chain and within one gray level of JAX's; the
  int8_pallas program bit-equal to the eager int8_pallas forward (its
  distance to JAX's is tests/test_torch_quantized.py's); the kernels' ops
  in the exported graph;
- an export leaves no traced tensor in the forwards' constant caches;
- on fake CUDA tensors (a trace for the card) every op runs its fake
  kernel and counts no launch; each CUDA impl raises where the kernels
  cannot launch, with no fallback to the plain version;
- the refusals: an orbax ``--ckpt``, two platforms, no card; and the EMA
  copy of G that the exporter loads.

JAX's artifacts are made from the ``.pth`` with ``create_train_state``
traced for its shapes only (as orbax_to_pth.py's template): every weight
comes from the ``.pth``, and its jitted init costs 45 s a call on one CPU core.
"""

import contextlib
import io
import json
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

import uegan_tpu.train.state as jax_state
from uegan_tpu.tools import export_model as jax_export
from uegan_tpu_torch.config import Config
from uegan_tpu_torch.infer import packed, quantized, strips
from uegan_tpu_torch.infer.packed import make_fast_eval
from uegan_tpu_torch.models.discriminator import Discriminator
from uegan_tpu_torch.models.generator import Generator
from uegan_tpu_torch.models.initializers import fan_in_normal_state
from uegan_tpu_torch.ops import gam_stats, resize2x
from uegan_tpu_torch.tools import export_model
from uegan_tpu_torch.utils.checkpoint import generator_state, load_pth, save_pth
from uegan_tpu_torch.utils.image_io import normalize_u8, quantize_u8

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HW, B = 32, 2

# a fresh interpreter: load each program, run it on its saved input, save
# the output, and fail if any jax or uegan_tpu module was loaded
LOAD = """
import json
import sys
import numpy as np
import torch
from uegan_tpu_torch.tools.export_model import kernel_calls, load_exported
torch.set_num_threads(1)
root, calls = sys.argv[1], {}
for name in sys.argv[2:]:
    fn = load_exported(f"{root}/{name}.pt2")
    y = fn(torch.from_numpy(np.load(f"{root}/{name}.in.npy")))
    np.save(f"{root}/{name}.out.npy", (y if y.dtype == torch.uint8 else y.float()).numpy())
    calls[name] = kernel_calls(fn.program)
bad = sorted(m for m in sys.modules
             if m.split('.')[0] in ('jax', 'jaxlib', 'uegan_tpu') or m.startswith('jax_'))
assert not bad, bad
print(json.dumps(calls))
"""


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One torch thread while this file runs (the suite runs several workers
    on a few cores), restored after it so other files keep their setting."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _numpy(y: torch.Tensor) -> np.ndarray:
    return (y if y.dtype == torch.uint8 else y.float()).numpy()


create_train_state = jax_state.create_train_state


def _shape_only_create_train_state(cfg, rng, image_hw, steps_per_epoch, vgg_vars=None):
    """JAX's create_train_state with its state traced for shapes and dtypes
    only; the export tool takes every weight from the .pth."""
    bundle = {}

    def state_of(key):
        state, bundle["b"] = create_train_state(cfg, key, image_hw, steps_per_epoch, vgg_vars)
        return state

    return jax.eval_shape(state_of, rng), bundle["b"]


@pytest.fixture(scope="module")
def exported(tmp_path_factory):
    """A .pth of seeded cd-32 weights; the port's programs (float32 packed
    through ``main``, ``--u8_io``, int8_pallas with kernel E's gate open, as
    tests/test_torch_quantized.py opens it at this width) run in a fresh
    interpreter; the eager forwards on the same inputs; JAX's float32 and
    u8 artifacts from the same .pth, run."""
    root = tmp_path_factory.mktemp("export")
    g = Generator(conv_dim=32)
    sd = {k: torch.from_numpy(v) for k, v in fan_in_normal_state(g, seed=1990).items()}
    pth = str(root / "g.pth")
    save_pth(pth, sd, Discriminator(conv_dim=32).state_dict(), 1.0, {}, {}, {}, {})
    rng = np.random.default_rng(0)
    inputs = {"f32": rng.uniform(-1, 1, (B, HW, HW, 3)).astype(np.float32),
              "u8": rng.integers(0, 256, (B, HW, HW, 3), dtype=np.uint8)}
    inputs["int8"] = inputs["f32"]
    for name, x in inputs.items():
        np.save(root / f"{name}.in.npy", x)

    out = {}
    printed = io.StringIO()
    with contextlib.redirect_stdout(printed):
        export_model.main(["--out", str(root / "f32.pt2"), "--ckpt", pth, "--hw", str(HW),
                           "--batch", str(B), "--compute_dtype", "float32", "--platform", "cpu"])
    out["printed"] = printed.getvalue()
    export_model.export_generator(str(root / "u8.pt2"), pth, HW, B, compute_dtype="float32",
                                  platforms=("cpu",), u8_io=True)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(quantized, "eligible", lambda *shapes: True)
        export_model.export_generator(str(root / "int8.pt2"), pth, HW, B,
                                      quantized="int8_pallas", platforms=("cpu",))
        gq = Generator(conv_dim=32)
        gq.load_state_dict(sd)
        eager_int8 = make_fast_eval(gq.eval(), Config(quantized_inference="int8_pallas"))
        out["eager_int8"] = _numpy(eager_int8(torch.from_numpy(inputs["int8"])))

    # the fresh interpreter runs beside the eager and JAX references below
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env.update(PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    proc = subprocess.Popen([sys.executable, "-c", LOAD, str(root), "f32", "u8", "int8"],
                            cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True)
    try:
        g.load_state_dict(sd)
        fn = make_fast_eval(g.eval(), Config(compute_dtype="float32"))
        with torch.inference_mode():
            out["eager_f32"] = _numpy(fn(torch.from_numpy(inputs["f32"])))
            out["eager_u8"] = _numpy(quantize_u8(fn(normalize_u8(
                torch.from_numpy(inputs["u8"])))))
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(jax_state, "create_train_state", _shape_only_create_train_state)
            for name, u8 in (("f32", False), ("u8", True)):
                path = str(root / f"{name}.jaxexport")
                jax_export.export_generator(path, pth, HW, B, compute_dtype="float32", u8_io=u8)
                out[f"jax_{name}"] = np.asarray(jax_export.load_exported(path)(inputs[name]))
        stdout, stderr = proc.communicate(timeout=300)
    finally:
        proc.kill()
        proc.wait()
    assert proc.returncode == 0, stderr
    out["calls"] = json.loads(stdout.splitlines()[-1])
    for name in inputs:
        out[name] = np.load(root / f"{name}.out.npy")
    out["root"] = root
    return out


@pytest.mark.parametrize("name", ["s2d_convert", "residual_tail_d2s", "upsample2x",
                                  "upsample2x_backward", "gam_mean_std", "gam_mean_std_train",
                                  "gam_mean_std_backward", "packed_conv", "packed_conv_int8",
                                  "packed_conv_int8_requant"])
def test_opcheck_on_the_cpu(name):
    """``torch.library.opcheck`` (schema, autograd registration, the fake
    kernel against the CPU impl, AOT dispatch with dynamic shapes) on each
    op at a shape of the cd-8, 32 px forwards; A and B with inputs that
    require grad, so their registered backwards (A', B') run too."""
    gen = torch.Generator().manual_seed(7)
    r = lambda *shape: torch.randn(*shape, generator=gen)
    i8 = lambda *shape: torch.randint(-127, 128, shape, generator=gen, dtype=torch.int8)
    x = r(B, 16, 16, 8)
    mean32, var32 = gam_stats.plain_stats32(x)
    cases = {
        "s2d_convert": (r(B, HW, HW, 3), torch.bfloat16),
        "residual_tail_d2s": (r(B, 16, 16, 12), r(B, 16, 16, 12)),
        "upsample2x": (r(B, 4, 4, 64).requires_grad_(),),
        "upsample2x_backward": (r(B, 8, 8, 64),),
        "gam_mean_std": (x, 1e-5),
        "gam_mean_std_train": (x.clone().requires_grad_(), 1e-5),
        "gam_mean_std_backward": (x, mean32, var32, r(B, 1, 1, 8), r(B, 1, 1, 8), 1e-5),
        "packed_conv": (r(B, 16, 16, 32), r(32, 32, 3, 3), r(32), 1, "leaky"),
        "packed_conv_int8": (i8(B, 16, 16, 32), i8(32, 32, 1, 1), r(32).abs() * 1e-3, r(32),
                             0, "none", None, None, False),
        "packed_conv_int8_requant": (i8(B, 16, 16, 32), i8(32, 32, 3, 3),
                                     r(32).abs() * 1e-3, r(32), 1, "leaky",
                                     r(B, 16, 16, 32).to(torch.bfloat16), 0.05, True),
    }
    op = getattr(torch.ops.uegan_torch, name.replace("_requant", "")).default
    result = torch.library.opcheck(op, cases[name])
    assert set(result.values()) == {"SUCCESS"}, result


def test_exported_forward_loads_without_jax_and_matches(exported):
    """The float32 packed program, loaded in a fresh interpreter without jax:
    bit-equal to the eager forward, within 1e-4 of JAX's artifact, and
    ``main`` prints JAX's line."""
    y = exported["f32"]
    assert y.shape == (B, HW, HW, 3) and y.dtype == np.float32
    np.testing.assert_array_equal(y, exported["eager_f32"])
    np.testing.assert_allclose(y, exported["jax_f32"], rtol=0, atol=1e-4)
    size = os.path.getsize(exported["root"] / "f32.pt2")
    assert exported["printed"] == (f"exported {HW}px batch-{B} forward to "
                                   f"{exported['root'] / 'f32.pt2'} ({size / 1e6:.2f} MB)\n")


def test_u8_io_program_matches_the_eager_u8_chain(exported):
    """``--u8_io``: uint8 in and out, bit-equal to normalize -> forward ->
    quantize run eagerly, within one gray level of JAX's u8 artifact."""
    y = exported["u8"]
    assert y.dtype == np.uint8 and y.shape == (B, HW, HW, 3)
    np.testing.assert_array_equal(y, exported["eager_u8"])
    assert int(np.abs(y.astype(np.int16) - exported["jax_u8"].astype(np.int16)).max()) <= 1


def test_int8_pallas_program_matches_the_eager_forward(exported):
    """The int8_pallas program (calibrated before the export), bit-equal to
    the eager int8_pallas forward, with kernel E's op in its graph."""
    np.testing.assert_array_equal(exported["int8"], exported["eager_int8"])
    ops = exported["calls"]["int8"]
    assert ops == {"s2d_convert": 1, "gam_mean_std": 4, "upsample2x": 3,
                   "packed_conv_int8": 1, "residual_tail_d2s": 1}, ops


def test_exported_graph_calls_the_kernels(exported):
    """The packed route's program calls C once, B three times, D once, as
    the eager forward launches them on a card."""
    for name in ("f32", "u8"):
        ops = exported["calls"][name]
        assert ops == {"s2d_convert": 1, "upsample2x": 3, "residual_tail_d2s": 1}, (name, ops)


class _Forward(torch.nn.Module):
    def __init__(self, fn):
        super().__init__()
        self.fn = fn

    def forward(self, x):
        return self.fn(x)


def test_export_leaves_no_traced_tensor_in_the_caches():
    """The packed and strip forwards cache per-shape constant tensors.  An
    export that is first to make one must not keep it: after it, an eager
    packed forward and an int8 calibration in the same process give the
    outputs they gave before (a kept fake tensor made the forward fail)."""
    g = Generator(conv_dim=8)
    g.load_state_dict({k: torch.from_numpy(v) for k, v in fan_in_normal_state(g, 3).items()})
    g.eval()
    fn = make_fast_eval(g, Config(g_conv_dim=8, compute_dtype="float32"))
    x = torch.from_numpy(np.random.default_rng(1).uniform(-1, 1, (B, HW, HW, 3))
                         .astype(np.float32))
    y0, scales0 = fn(x), quantized.calibrate(g, x)
    for cache in (packed._pad_sources, packed._phase0_channels, packed._phase_matrix,
                  strips._reflect_rows, strips._strip_constants, strips._col_taps,
                  resize2x._matrix):
        cache.cache_clear()
    torch.export.export(_Forward(fn), (x,))
    assert torch.equal(fn(x), y0)
    assert quantized.calibrate(g, x) == scales0


def test_export_refuses_orbax_two_platforms_and_a_missing_card(tmp_path, monkeypatch):
    """An orbax --ckpt is refused with the orbax_to_pth.py command, a list of
    two platforms with the reason, and without a card or UEGAN_TORCH_DEVICE
    the export stops rather than moving to the CPU."""
    orbax = tmp_path / "UEGAN-FiveK_rahinge_1"
    orbax.mkdir()
    out = str(tmp_path / "g.pt2")
    with pytest.raises(NotImplementedError, match="orbax_to_pth.py --ckpt"):
        export_model.export_generator(out, str(orbax), HW, B, platforms=("cpu",))
    with pytest.raises(ValueError, match="one device"):
        export_model.export_generator(out, "", HW, B, platforms=("cpu", "cuda"))
    monkeypatch.delenv("UEGAN_TORCH_DEVICE", raising=False)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            export_model.export_generator(out, "", HW, B)
    assert not os.path.exists(out)


def test_ema_copy_is_what_the_exporter_loads(tmp_path):
    """A .pth with an EMA copy of G: ``generator_state`` under ema_eval (the
    exporter's, the Tester's and the server's load) gives the EMA weights,
    without it the live ones."""
    g = Generator(conv_dim=8)
    live = {k: torch.from_numpy(v) for k, v in fan_in_normal_state(g, 4).items()}
    ema = {k: v + 1.0 for k, v in live.items() if k.endswith(("weight", "bias"))}
    pth = str(tmp_path / "g.pth")
    save_pth(pth, live, {}, 1.0, {}, {}, {}, {}, g_ema=ema)
    ckpt = load_pth(pth)
    assert all(torch.equal(generator_state(ckpt, ema=True)[k], ema[k]) for k in ema)
    assert all(torch.equal(generator_state(ckpt)[k], live[k]) for k in live)


def test_cuda_dispatch_reaches_fake_kernels_and_launches_nothing_when_traced():
    """Every op on fake CUDA tensors (as torch.export traces a forward on the
    card) runs its fake kernel: the output's shape and dtype, no launch
    counted, no kernel library built."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    from uegan_tpu_torch.ops import _build, packed_conv, packed_conv_int8, s2d_fuse

    ops = torch.ops.uegan_torch
    wrappers = (gam_stats.gam_mean_std, gam_stats.gam_mean_std_backward, resize2x.upsample2x,
                resize2x.upsample2x_backward, s2d_fuse.s2d_convert, s2d_fuse.residual_tail_d2s,
                packed_conv.packed_conv, packed_conv_int8.packed_conv_int8)
    before = [w.launches for w in wrappers]
    lib = _build._lib
    with FakeTensorMode():
        x = torch.empty(B, 8, 8, 16, device="cuda")
        s = torch.empty(B, 1, 1, 16, device="cuda")
        i8 = torch.empty(B, 8, 8, 16, dtype=torch.int8, device="cuda")
        k8 = torch.empty(32, 16, 3, 3, dtype=torch.int8, device="cuda")
        v = torch.empty(32, device="cuda")
        got = {
            "s2d_convert": ops.s2d_convert(x, torch.bfloat16),
            "residual_tail_d2s": ops.residual_tail_d2s(x, x),
            "upsample2x": ops.upsample2x(x),
            "upsample2x_backward": ops.upsample2x_backward(x),
            "gam_mean_std": ops.gam_mean_std(x, 1e-5)[1],
            "gam_mean_std_train": ops.gam_mean_std_train(x, 1e-5)[3],
            "gam_mean_std_backward": ops.gam_mean_std_backward(x, s, s, s, s, 1e-5),
            "packed_conv": ops.packed_conv(x, torch.empty(32, 16, 3, 3, device="cuda"), v, 1,
                                           "none"),
            "packed_conv_int8": ops.packed_conv_int8(i8, k8, v, v, 1, "leaky", None, 0.1, True),
        }
    want = {"s2d_convert": ((B, 4, 4, 64), torch.bfloat16),
            "residual_tail_d2s": ((B, 16, 16, 4), torch.float32),
            "upsample2x": ((B, 16, 16, 16), torch.float32),
            "upsample2x_backward": ((B, 4, 4, 16), torch.float32),
            "gam_mean_std": ((B, 1, 1, 16), torch.float32),
            "gam_mean_std_train": ((B, 1, 1, 16), torch.float32),
            "gam_mean_std_backward": ((B, 8, 8, 16), torch.float32),
            "packed_conv": ((B, 8, 8, 32), torch.float32),
            "packed_conv_int8": ((B, 8, 8, 32), torch.int8)}
    for name, t in got.items():
        assert (tuple(t.shape), t.dtype, t.device.type) == (*want[name], "cuda"), name
    assert [w.launches for w in wrappers] == before
    assert _build._lib is lib


def test_cuda_impls_raise_where_the_kernels_cannot_launch(monkeypatch):
    """No fallback: each op's CUDA impl raises when the kernel library cannot
    be built or loaded; nothing runs the plain version in its place."""
    from uegan_tpu_torch.ops import _build, packed_conv, packed_conv_int8, s2d_fuse

    def no_library():
        raise RuntimeError("nvcc not found")

    monkeypatch.setattr(_build, "load", no_library)
    x = torch.randn(B, 8, 8, 16)
    s = torch.randn(B, 1, 1, 16)
    i8 = torch.randint(-127, 128, (B, 8, 8, 16), dtype=torch.int8)
    calls = [lambda: s2d_fuse._s2d_cuda(x, torch.bfloat16),
             lambda: s2d_fuse._d2s_cuda(x, x),
             lambda: resize2x._launch(x),
             lambda: resize2x._backward_cuda(x),
             lambda: gam_stats._launch(x, 1e-5, keep32=True),
             lambda: gam_stats._backward_cuda(x, s, s, s, s, 1e-5),
             lambda: packed_conv._packed_conv_cuda(x, torch.randn(32, 16, 3, 3),
                                                   torch.randn(32), 1, "none"),
             lambda: packed_conv_int8._packed_conv_int8_cuda(
                 i8, torch.randint(-127, 128, (32, 16, 1, 1), dtype=torch.int8),
                 torch.rand(32), torch.randn(32), 0, "none", None, None, False)]
    for call in calls:
        with pytest.raises(RuntimeError, match="nvcc not found"):
            call()
