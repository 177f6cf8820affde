"""PyTorch port: int8 quantized packed inference against the JAX package on
the same weights: the int8 conv, the plain versions of kernels E and F
against the interpret-mode Pallas kernels, the quantizers and tables, the
fused conv with its reflect strips, the int8 forward and ``--mode test
--quantized_inference int8_pallas``.

Weights are N(0, 1/fan_in) from a numpy seed, carried to flax through
uegan_tpu.convert.torch_import; cd 8, CPU.  The CUDA kernels run only on a
card; chip_smoke.py holds them against these plain versions there.
"""

import os
from types import SimpleNamespace

import jax
import jax.lax as lax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from uegan_tpu.config import Config as JaxConfig
from uegan_tpu.convert.torch_import import import_generator
from uegan_tpu.data.pipeline import device_normalize
from uegan_tpu.infer import packed as jpacked
from uegan_tpu.infer import quantized as jquant
from uegan_tpu.models.generator import Generator as JaxGenerator
from uegan_tpu.ops.pallas import packed_conv_int8 as jpallas_int8
from uegan_tpu.ops.pallas.packed_conv import packed_conv_pallas
from uegan_tpu_torch.data.pipeline import get_test_loader
from uegan_tpu_torch.infer import packed, quantized
from uegan_tpu_torch.models.generator import Generator
from uegan_tpu_torch.models.initializers import fan_in_normal_state
from uegan_tpu_torch.ops import packed_conv_int8 as e_mod
from uegan_tpu_torch.ops.conv_int8 import conv2d_int8
from uegan_tpu_torch.ops.packed_conv import kernel_operands as f_operands
from uegan_tpu_torch.ops.packed_conv import packed_conv as f_kernel
from uegan_tpu_torch.ops.packed_conv import plain_packed_conv
from uegan_tpu_torch.utils.image_io import read_png_rgb

CD = 8
BF16 = torch.bfloat16
FIXTURE = os.path.join(os.path.dirname(os.path.abspath(__file__)), "fixtures", "verify_fivek", "test")


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One torch thread while this file runs (the suite runs several workers
    on a few cores), restored after it so other files keep their setting."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _oihw(k: np.ndarray) -> torch.Tensor:
    """HWIO numpy -> OIHW torch (the port's kernel layout)."""
    return torch.from_numpy(np.ascontiguousarray(np.transpose(k, (3, 2, 0, 1))))


def _psnr(a, b) -> float:
    mse = float(np.mean((np.asarray(a, np.float64) - np.asarray(b, np.float64)) ** 2))
    return 10.0 * np.log10(4.0 / max(mse, 1e-12))  # range [-1, 1]: peak 2


@pytest.fixture(scope="module")
def weights():
    """(numpy state dict, flax params, port Generator in eval mode), cd 8."""
    g = Generator(conv_dim=CD)
    sd = fan_in_normal_state(g, seed=1990)
    g.load_state_dict({k: torch.from_numpy(v) for k, v in sd.items()})
    return sd, import_generator(sd)["params"], g.eval()


@pytest.fixture(scope="module")
def jax_tables(weights):
    """JAX build_quant_tables on the bridged weights (its default seeded
    calibration batch)."""
    bundle = SimpleNamespace(g_model=JaxGenerator(conv_dim=CD))
    return bundle, jquant.build_quant_tables(bundle, weights[1])


# ---------------------------------------------------------------------------
# the int8 conv
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("shape,k,cout,stride,pad", [
    ((2, 9, 7, 8), 3, 16, 1, ((1, 1), (1, 1))),    # 3x3, reflect-free zero pad
    ((1, 10, 12, 16), 6, 48, 2, ((2, 2), (2, 2))),  # the deep head's stride 2, pad 2
    ((2, 6, 5, 12), 5, 8, 1, ((2, 2), (2, 2))),     # K = 5*5*12 = 300, not a multiple of 8
    ((1, 8, 6, 32), 5, 12, 1, ((0, 0), (0, 0))),    # N = 12 (dec5_1's packed output), VALID
    ((1, 3, 2, 4), 1, 8, 1, ((0, 0), (0, 0))),      # M = 6 <= 16 rows
    ((2, 7, 9, 5), 3, 6, 1, ((1, 1), (2, 0))),      # odd channels: a byte gather
    ((1, 6, 5, 6), 4, 8, 2, ((2, 1), (1, 2))),      # 2-byte words, uneven pads
])
def test_conv2d_int8_matches_lax(shape, k, cout, stride, pad):
    """Bit-equal to lax.conv_general_dilated(..., preferred_element_type=int32),
    with every value at +-127 in one of the cases."""
    rng = np.random.default_rng(3)
    x = rng.integers(-127, 128, shape, dtype=np.int8)
    w = rng.integers(-127, 128, (k, k, shape[-1], cout), dtype=np.int8)
    if shape[-1] == 16:
        x = np.where(x >= 0, 127, -127).astype(np.int8)
        w = np.where(w >= 0, 127, -127).astype(np.int8)
    want = lax.conv_general_dilated(jnp.asarray(x), jnp.asarray(w), (stride, stride), pad,
                                    dimension_numbers=("NHWC", "HWIO", "NHWC"),
                                    preferred_element_type=jnp.int32)
    got = conv2d_int8(torch.from_numpy(x), _oihw(w), stride, pad)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_conv2d_int8_refuses_float():
    with pytest.raises(TypeError):
        conv2d_int8(torch.zeros(1, 4, 4, 8), torch.zeros(8, 8, 1, 1, dtype=torch.int8))


# ---------------------------------------------------------------------------
# kernel E's plain version against the interpret-mode Pallas kernel
# (the cases of tests/test_pallas_int8.py)
# ---------------------------------------------------------------------------
def _mk_int8(S, seed=0, n=2, l=16, w=128, cin=128, cout=128):
    rng = np.random.default_rng(seed)
    xq = rng.integers(-127, 128, (n, l, w, cin), dtype=np.int8)
    kq = rng.integers(-4, 5, (S, S, cin, cout), dtype=np.int8)
    ws = rng.uniform(1e-4, 3e-4, cout).astype(np.float32)
    b = (rng.standard_normal(cout) * 0.1).astype(np.float32)
    return xq, kq, ws, b


def _port_e(xq, kq, ws, b, s0, **kw):
    before = e_mod.packed_conv_int8.launches
    out = e_mod.packed_conv_int8(torch.from_numpy(xq), _oihw(kq), torch.from_numpy(ws),
                                 torch.from_numpy(b), s0, **kw)
    assert e_mod.packed_conv_int8.launches == before  # CPU: the plain version, no launch
    return out


@pytest.mark.parametrize("S,s0", [(3, 1), (4, 2), (1, 0)])
def test_packed_conv_int8_plain_matches_pallas(S, s0):
    xq, kq, ws, b = _mk_int8(S)
    want = jpallas_int8.packed_conv_int8_pallas(jnp.asarray(xq), jnp.asarray(kq), jnp.asarray(ws),
                                                jnp.asarray(b), s0, act="leaky", interpret=True,
                                                th=8)
    got = _port_e(xq, kq, ws, b, s0, act="leaky")
    assert got.dtype == torch.bfloat16 and got.shape == want.shape
    s1 = S - 1 - s0
    cols = slice(s0, -s1 if s1 else None)  # the columns the TPU kernel specifies
    np.testing.assert_allclose(got.float().numpy()[:, :, cols],
                               np.asarray(want, np.float32)[:, :, cols], rtol=1 / 128, atol=1e-6)


def test_packed_conv_int8_requant_and_mul_match_pallas():
    xq, kq, ws, b = _mk_int8(3)
    rng = np.random.default_rng(3)
    mul = jnp.asarray(rng.standard_normal((2, 16, 128, 128)).astype(np.float32))
    mul = mul.astype(jnp.bfloat16)
    want = jpallas_int8.packed_conv_int8_pallas(
        jnp.asarray(xq), jnp.asarray(kq), jnp.asarray(ws), jnp.asarray(b), 1, act="leaky",
        mul=mul, out_scale=jnp.asarray(0.013, jnp.float32), requant=True, interpret=True, th=4)
    got = _port_e(xq, kq, ws, b, 1, act="leaky",
                  mul=torch.from_numpy(np.asarray(mul, np.float32)).to(torch.bfloat16),
                  out_scale=0.013, requant=True)
    assert got.dtype == torch.int8
    diff = np.abs(got.numpy()[:, :, 1:-1].astype(np.int32)
                  - np.asarray(want)[:, :, 1:-1].astype(np.int32))
    assert diff.max() <= 1 and (diff > 0).mean() < 1e-3


def test_packed_conv_int8_tanh_matches_pallas():
    xq, kq, ws, b = _mk_int8(3, seed=5)
    want = jpallas_int8.packed_conv_int8_pallas(jnp.asarray(xq), jnp.asarray(kq), jnp.asarray(ws),
                                                jnp.asarray(b), 1, act="tanh", interpret=True,
                                                th=8)
    got = _port_e(xq, kq, ws, b, 1, act="tanh")
    np.testing.assert_allclose(got.float().numpy()[:, :, 1:-1],
                               np.asarray(want, np.float32)[:, :, 1:-1], atol=1e-2)


def test_eligible_copy_matches_jax():
    for xs, ks in [((8, 256, 256, 128), (1, 1, 128, 128)), ((8, 256, 256, 128), (3, 3, 128, 128)),
                   ((8, 256, 256, 12), (4, 4, 12, 128)), ((8, 256, 250, 128), (3, 3, 128, 128)),
                   ((1, 16, 16, 32), (1, 1, 32, 32)), ((1, 128, 128, 128), (1, 1, 128, 128))]:
        assert e_mod.eligible(xs, ks) == jpallas_int8.eligible(xs, ks), (xs, ks)
    assert e_mod.eligible((8, 256, 256, 128), (1, 1, 128, 128))  # ga1 at 512 px, cd 32


def test_kernel_wrappers_refuse_what_the_kernels_do_not_take():
    x8 = torch.zeros(1, 4, 4, 8, dtype=torch.int8)
    k8 = torch.zeros(4, 8, 3, 3, dtype=torch.int8)
    ones = torch.ones(4)
    with pytest.raises(TypeError):
        e_mod.packed_conv_int8(x8.float(), k8, ones, ones, 1)
    with pytest.raises(ValueError, match="s0"):
        e_mod.packed_conv_int8(x8, k8, ones, ones, 3)
    with pytest.raises(ValueError, match="w_scale"):
        e_mod.packed_conv_int8(x8, k8, ones.double(), ones, 1)
    with pytest.raises(ValueError, match="mul"):
        e_mod.packed_conv_int8(x8, k8, ones, ones, 1, mul=torch.zeros(1, 4, 4, 4))
    with pytest.raises(ValueError, match="act"):
        e_mod.packed_conv_int8(x8, k8, ones, ones, 1, act="relu")
    xf = torch.zeros(1, 4, 4, 8)
    with pytest.raises(ValueError, match="dtype"):
        f_kernel(xf, torch.zeros(4, 8, 3, 3, dtype=torch.bfloat16), ones, 1)
    with pytest.raises(TypeError):
        f_kernel(xf.double(), torch.zeros(4, 8, 3, 3).double(), ones.double(), 1)


# ---------------------------------------------------------------------------
# kernel F's plain version against the interpret-mode Pallas kernel
# (the cases of tests/test_pallas_packed_conv.py)
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("S,s0,L,W,cin,cout,th", [
    (3, 1, 32, 16, 128, 128, 8),
    (3, 1, 32, 16, 128, 128, 0),
    (5, 2, 32, 24, 128, 128, 8),
    (3, 1, 16, 16, 256, 128, 8),
    (2, 1, 16, 16, 128, 128, 4),
])
def test_packed_conv_plain_matches_pallas(S, s0, L, W, cin, cout, th):
    rng = np.random.default_rng(0)
    x = rng.normal(size=(2, L, W, cin)).astype(np.float32)
    k = (rng.normal(size=(S, S, cin, cout)) * 0.05).astype(np.float32)
    b = rng.normal(size=(cout,)).astype(np.float32)
    want = packed_conv_pallas(jnp.asarray(x), jnp.asarray(k), jnp.asarray(b), s0, act="leaky",
                              interpret=True, th=th)
    before = f_kernel.launches
    got = f_kernel(torch.from_numpy(x), _oihw(k), torch.from_numpy(b), s0, act="leaky")
    assert f_kernel.launches == before
    s1 = S - 1 - s0
    hi = W - s1 if s1 else W
    np.testing.assert_allclose(got.numpy()[:, :, s0:hi], np.asarray(want)[:, :, s0:hi],
                               rtol=2e-5, atol=2e-5)
    # bf16 in and out: the same sums in f32, rounded once
    xb, kb, bb = (torch.from_numpy(a).to(torch.bfloat16) for a in (x, k, b))
    got_b = f_kernel(xb, _oihw(kb.float().numpy()).to(torch.bfloat16), bb, s0, act="leaky")
    want_b = plain_packed_conv(xb.double(), _oihw(kb.double().numpy()), bb.double(), s0,
                               act="leaky").to(torch.bfloat16)
    assert got_b.dtype == torch.bfloat16
    np.testing.assert_allclose(got_b.float().numpy(), want_b.float().numpy(), rtol=1 / 128,
                               atol=1e-5)


@pytest.mark.parametrize("dtype,S,s0,cin", [
    (torch.int8, 3, 1, 5),       # Cin 5 -> 16 zero-padded channels
    (torch.int8, 1, 0, 32),      # 16-byte rows already: x is passed as it is
    (torch.bfloat16, 4, 2, 12),  # Cin 12 -> 16
])
def test_kernel_operands_rebuild_the_conv_by_taps(dtype, S, s0, cin):
    """The wrappers' host-side layout for the tensor-core body of E and F:
    weights K-major (Cout, S, S, Cpad) and channels zero-padded to 16-byte
    rows.  The conv rebuilt from those operands as the kernel decomposes it
    (for each tap, the zero-filled shifted input times the tap's weights,
    summed in int64 or f32) equals the plain versions: E's bit for bit after
    its epilogue, F's to 1e-5."""
    rng = np.random.default_rng(7)
    n, l, w, cout = 2, 5, 7, 24
    if dtype == torch.int8:
        xp = torch.from_numpy(rng.integers(-127, 128, (n, l, w, cin), dtype=np.int8))
        kp = torch.from_numpy(rng.integers(-127, 128, (cout, cin, S, S), dtype=np.int8))
        x, wts = e_mod.kernel_operands(xp, kp)
        mult, acc_t = 16, torch.int64
    else:
        xp = torch.from_numpy(rng.standard_normal((n, l, w, cin)).astype(np.float32)).to(BF16)
        kp = torch.from_numpy(rng.standard_normal((cout, cin, S, S)).astype(np.float32)).to(BF16)
        x, wts = f_operands(xp, kp)
        mult, acc_t = 8, torch.float32
    cpad = -(-cin // mult) * mult
    assert x.shape == (n, l, w, cpad) and wts.shape == (cout, S, S, cpad)
    assert x.dtype == wts.dtype == dtype and x.is_contiguous() and wts.is_contiguous()
    assert x.data_ptr() % 16 == 0 and wts.data_ptr() % 16 == 0
    assert not x[..., cin:].any() and not wts[..., cin:].any()
    assert torch.equal(x[..., :cin], xp) and torch.equal(wts[..., :cin], kp.permute(0, 2, 3, 1))
    assert (x.data_ptr() == xp.data_ptr()) == (cin % mult == 0)
    xz = torch.nn.functional.pad(x.to(acc_t), (0, 0, s0, S - 1 - s0, s0, S - 1 - s0))
    acc = torch.zeros((n, l, w, cout), dtype=acc_t)
    for si in range(S):
        for sj in range(S):
            acc += xz[:, si:si + l, sj:sj + w] @ wts[:, si, sj].to(acc_t).T
    if dtype == torch.int8:
        ws = torch.from_numpy(rng.uniform(1e-4, 3e-4, cout).astype(np.float32))
        b = torch.from_numpy((rng.standard_normal(cout) * 0.1).astype(np.float32))
        got = e_mod.int8_epilogue(acc, ws, b, "leaky")
        assert torch.equal(got, e_mod.plain_packed_conv_int8(xp, kp, ws, b, s0, act="leaky"))
    else:
        b = torch.from_numpy(rng.standard_normal(cout).astype(np.float32))
        want = plain_packed_conv(xp.float(), kp.float(), b, s0)
        np.testing.assert_allclose((acc + b).numpy(), want.numpy(), rtol=1e-5, atol=1e-5)


# ---------------------------------------------------------------------------
# quantizers, tables, the int8 packed conv and GAM statistics
# ---------------------------------------------------------------------------
def test_quantize_weights_and_act_match_jax():
    rng = np.random.default_rng(0)
    w = rng.standard_normal((3, 3, 8, 16)).astype(np.float32)
    for in_sc in (rng.uniform(0.5, 2.0, 8).astype(np.float32), 0.0123):
        got, want = quantized.quantize_weights(w, in_sc), jquant.quantize_weights(w, in_sc)
        for a, b in zip(got, want):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)
    x = rng.uniform(-3, 3, (2, 8, 8, 8)).astype(np.float32)
    x[0, 0, 0, :4] = [0.5 * 3 / 127, 1.5 * 3 / 127, -2.5 * 3 / 127, 400.0]  # ties and clip
    for scale in (3.0 / 127.0, quantized.INPUT_SCALE, 0.0071):
        got = quantized.quantize_act(torch.from_numpy(x), scale)
        want = jquant.quantize_act(jnp.asarray(x), scale)
        assert got.dtype == torch.int8
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        gotb = quantized.quantize_act(torch.from_numpy(x).to(torch.bfloat16), scale)
        wantb = jquant.quantize_act(jnp.asarray(x).astype(jnp.bfloat16), scale)
        np.testing.assert_array_equal(gotb.numpy(), np.asarray(wantb))


def test_quant_tables_match_jax(weights, jax_tables):
    """Given JAX's scales, the port's q and w are the same bits; the port's
    own calibration is within 2% of JAX's."""
    g = weights[2]
    _, jt = jax_tables
    got = quantized.build_quant_tables(g, scales=jt["sc"])
    for part in ("q", "w"):
        assert sorted(got[part]) == sorted(jt[part])
        for k, v in got[part].items():
            assert v.dtype == jt[part][k].dtype, (part, k)
            np.testing.assert_array_equal(v, jt[part][k], err_msg=f"{part}/{k}")
    np.testing.assert_array_equal(got["b9"], jt["b9"])
    for k, v in got["b"].items():
        np.testing.assert_array_equal(v, np.asarray(jt["b"][k]), err_msg=k)
    for k, v in got["se"].items():
        np.testing.assert_array_equal(v, np.asarray(jt["se"][k]), err_msg=k)
    own = quantized.build_quant_tables(g)
    assert sorted(own["sc"]) == sorted(quantized.SCALE_KEYS)
    for k, v in own["sc"].items():
        assert abs(v / jt["sc"][k] - 1) <= 0.02, (k, v, jt["sc"][k])


def test_packed_conv_int8_form_and_gam_stats_match_jax():
    rng = np.random.default_rng(5)
    cin = 4
    xq = rng.integers(-127, 128, (2, 8, 8, 8 * cin), dtype=np.int8)
    kq = rng.integers(-127, 128, (3, 3, 8 * cin, 16), dtype=np.int8)
    want = jpacked.packed_conv(jnp.asarray(xq), jnp.asarray(kq), 1, [cin, cin], None, jnp.int8)
    got = packed.packed_conv(torch.from_numpy(xq), _oihw(kq), 1, [cin, cin], dtype=torch.int8)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    x = rng.normal(0.3, 1.5, (2, 4, 6, 4 * cin)).astype(np.float32)
    for a, b in zip(packed.packed_gam_stats(torch.from_numpy(x), cin),
                    jpacked.packed_gam_stats(jnp.asarray(x), cin)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("S,s0,act,use_mul,requant", [
    (1, 0, "none", False, False),  # the ga1 site
    (3, 1, "leaky", True, True),   # the dec4 site: leaky, y4 * x1, requant
    (3, 1, "none", False, True),   # the dec5_0 site
])
def test_conv_q_fused_matches_jax(S, s0, act, use_mul, requant):
    """Kernel E's plain version + the reflect border strips against JAX's
    interpret-mode kernel + strips, every column."""
    rng = np.random.default_rng(7)
    c = 4
    xq = rng.integers(-127, 128, (2, 16, 16, 4 * c), dtype=np.int8)
    kq = rng.integers(-20, 21, (S, S, 4 * c, 4 * c), dtype=np.int8)
    ws = rng.uniform(1e-3, 3e-3, 4 * c).astype(np.float32)
    bt = (rng.standard_normal(4 * c) * 0.1).astype(np.float32)
    mul = rng.standard_normal((2, 16, 16, 4 * c)).astype(np.float32) if use_mul else None
    mulj = None if mul is None else jnp.asarray(mul).astype(jnp.bfloat16)
    want = jquant._conv_q_fused(jnp.asarray(xq), kq, ws, jnp.asarray(bt), s0, c, act=act,
                                mul=mulj, out_scale=0.021 if requant else None, requant=requant)
    mult = None if mul is None else torch.from_numpy(np.asarray(mulj, np.float32)).to(BF16)
    got = quantized._conv_q_fused(torch.from_numpy(xq), _oihw(kq), torch.from_numpy(ws),
                                  torch.from_numpy(bt), s0, c, act=act, mul=mult,
                                  out_scale=0.021 if requant else None, requant=requant)
    want = np.asarray(want).astype(np.float32)
    got = got.float().numpy()
    if requant:
        diff = np.abs(got - want)
        assert diff.max() <= 1 and (diff > 0).mean() < 1e-3
    else:
        np.testing.assert_allclose(got, want, rtol=1 / 128, atol=1e-6)


# ---------------------------------------------------------------------------
# the int8 forward and the CLI
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("use_pallas", [False, True])
def test_make_int8_eval_matches_jax(weights, jax_tables, use_pallas, monkeypatch):
    """The port's int8 forward on the JAX tables against JAX make_int8_eval.
    With use_pallas, both sides' kernel gate is opened for the cd-8 shapes
    (it passes only 128-lane channels, cd 32 and up), so kernel E's plain
    version and JAX's interpret-mode kernel run at ga1."""
    sd, params, g = weights
    bundle, jt = jax_tables
    calls = []
    if use_pallas:
        monkeypatch.setattr(jpallas_int8, "eligible", lambda xs, ks: True)
        monkeypatch.setattr(quantized, "eligible", lambda xs, ks: True)
        real = quantized.packed_conv_int8
        monkeypatch.setattr(quantized, "packed_conv_int8",
                            lambda *a, **k: calls.append(a[0].shape) or real(*a, **k))
    x = np.random.default_rng(8).uniform(-1, 1, (2, 32, 48, 3)).astype(np.float32)
    want = np.asarray(jax.jit(jquant.make_int8_eval(bundle, params, use_pallas=use_pallas,
                                                    tables=jt))(None, None, jnp.asarray(x)),
                      np.float32)
    tabs = quantized.build_quant_tables(g, scales=jt["sc"])
    got = quantized.make_int8_eval(g, tabs, use_pallas=use_pallas)(torch.from_numpy(x))
    assert got.dtype == torch.bfloat16 and got.shape == x.shape
    got = got.float().numpy()
    assert calls == ([(2, 16, 24, 4 * CD)] if use_pallas else [])
    assert float(np.abs(got - x).mean()) > 0.05  # the residual is not ~0
    psnr, dmax = _psnr(got, want), float(np.abs(got - want).max())
    assert psnr >= 40.0 and dmax <= 0.05, (psnr, dmax)
    # and within the int8 error of the bf16 packed forward
    bf = packed.make_packed_eval(quantized.bf16_interior(g),
                                 packed.pack_generator_params(g.state_dict(), CD))
    with torch.inference_mode():
        assert _psnr(got, bf(torch.from_numpy(x)).float().numpy()) >= 30.0


def test_make_fast_eval_takes_the_int8_route(weights):
    from uegan_tpu_torch.config import Config

    g = weights[2]
    x = torch.from_numpy(np.random.default_rng(9).uniform(-1, 1, (1, 32, 32, 3)).astype(np.float32))
    tabs = quantized.build_quant_tables(g, calib_batch=x)
    want = quantized.make_int8_eval(g, tabs)(x)
    for qi in ("int8", "int8_pallas"):
        got = packed.make_fast_eval(g, Config(quantized_inference=qi), calib_batch=x)(x)
        assert got.dtype == torch.bfloat16
        torch.testing.assert_close(got, want, rtol=0, atol=0)
    # a forced strip height the strips cannot take runs the direct int8 forward
    got = packed.make_fast_eval(g, Config(quantized_inference="int8", strip_rows=8),
                                calib_batch=x)(x)
    torch.testing.assert_close(got, want, rtol=0, atol=0)


def test_cli_test_mode_int8_pallas_matches_jax(weights, tmp_path, monkeypatch):
    """``--mode test --quantized_inference int8_pallas`` on the vendored
    fixture: the PNGs against the JAX Tester's int8 u8 forward on the same
    batch (calibrated on it, padded to val_batch_size and normalized on the
    host, as the JAX Tester does)."""
    from uegan_tpu.train.tester import _host_norm_u8
    from uegan_tpu_torch import cli

    sd, params, _ = weights
    models = tmp_path / "results" / "UEGAN-FiveK" / "models"
    models.mkdir(parents=True)
    torch.save({"G_net": {k: torch.from_numpy(v) for k, v in sd.items()}},
               str(models / "UEGAN-FiveK_rahinge_92.pth"))
    label_dir = os.path.join(FIXTURE, "label") + os.sep
    monkeypatch.setenv("UEGAN_TORCH_DEVICE", "cpu")
    res = cli.run([
        "--mode", "test", "--test_img_dir", FIXTURE, "--test_label_dir", label_dir,
        "--save_root_dir", str(tmp_path / "results"), "--g_conv_dim", str(CD),
        "--test_img_size", "32", "--val_batch_size", "2", "--pretrained_model", "92",
        "--compute_dtype", "float32", "--is_test_nima", "false",
        "--is_test_psnr_ssim", "true", "--num_workers", "1",
        "--quantized_inference", "int8_pallas",
    ])
    assert res["n_images"] == 2

    batch = next(iter(get_test_loader(FIXTURE, img_size=32, batch_size=2, num_workers=1,
                                      emit="uint8")))
    raw = np.asarray(batch["img_raw"])
    cfg = JaxConfig(g_conv_dim=CD, compute_dtype="float32", quantized_inference="int8_pallas")
    bundle = SimpleNamespace(g_model=JaxGenerator(conv_dim=CD), config=cfg)
    base = jpacked.make_fast_eval(bundle, params, calib_batch=_host_norm_u8(raw), u8_output=True)
    want = np.asarray(jax.jit(lambda p, x: base(p, None, device_normalize(x)))(
        params, jnp.asarray(raw))).astype(np.int16)
    out_dir = tmp_path / "results" / "UEGAN-FiveK" / "test" / "test_results"
    got = np.stack([read_png_rgb(str(out_dir / f"{name}_92.00_testFakeExp.png"))
                    for name in batch["img_name"]]).astype(np.int16)
    d = np.abs(got - want)
    assert d.max() <= 3 and (d <= 1).mean() >= 0.99, (d.max(), (d <= 1).mean())
