"""PyTorch port: the packed (space-to-depth) inference path against the JAX
package on the same weights: the kernel packing, the packed ops, the plain
versions of kernels C and D against the interpret-mode Pallas kernels, the
packed forward, and ``--mode test`` with packing on.

Weights are N(0, 1/fan_in) from a numpy seed, carried to flax through
uegan_tpu.convert.torch_import; cd 8, f32, CPU.  The CUDA kernels run only
on a card; chip_smoke.py holds them against these plain versions there.
"""

import os
import shutil
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from uegan_tpu.config import Config as JaxConfig
from uegan_tpu.convert.torch_import import import_generator
from uegan_tpu.data.pipeline import device_normalize
from uegan_tpu.infer import packed as jpacked
from uegan_tpu.models.generator import Generator as JaxGenerator
from uegan_tpu.ops.pallas.s2d_fuse import residual_tail_d2s as jax_residual_tail_d2s
from uegan_tpu.ops.pallas.s2d_fuse import s2d_convert as jax_s2d_convert
from uegan_tpu_torch.data.pipeline import get_test_loader
from uegan_tpu_torch.infer import packed
from uegan_tpu_torch.models.generator import Generator
from uegan_tpu_torch.models.initializers import fan_in_normal_state
from uegan_tpu_torch.ops.s2d_fuse import (plain_residual_tail_d2s, plain_s2d_convert,
                                          residual_tail_d2s, s2d_convert, s2d_plan)
from uegan_tpu_torch.utils.image_io import read_png_rgb

CD = 8
FIXTURE = os.path.join(os.path.dirname(os.path.abspath(__file__)), "fixtures", "verify_fivek", "test")


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One torch thread while this file runs (the suite runs several workers
    on a few cores), restored after it so other files keep their setting."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def weights():
    """(numpy state dict, flax params, port Generator in eval mode), cd 8."""
    g = Generator(conv_dim=CD)
    sd = fan_in_normal_state(g, seed=1990)
    g.load_state_dict({k: torch.from_numpy(v) for k, v in sd.items()})
    return sd, import_generator(sd)["params"], g.eval()


@pytest.fixture(scope="module")
def jax_packed(weights):
    """JAX ``make_packed_eval`` on the bridged weights, jitted: x -> output."""
    params = weights[1]
    bundle = SimpleNamespace(g_model=JaxGenerator(conv_dim=CD))
    fn = jax.jit(jpacked.make_packed_eval(bundle, jpacked.pack_generator_params(params, CD)))
    return lambda x: np.asarray(fn(params, jnp.asarray(x)))


def _hwio(t: torch.Tensor) -> np.ndarray:
    return np.transpose(t.numpy(), (2, 3, 1, 0))


def test_pack_generator_params_matches_jax(weights):
    """The port packs the same bits as JAX from the same weights (OIHW
    tensors here, HWIO there).  JAX's ``up4_k`` is its train path's alone,
    and its 9x9 ``dec5c_k`` (with ``dec5c_s0``) feeds only the head's
    stride-1 form, which no input the generator takes reaches: the port
    keeps the deep form ``dec5d_k`` alone."""
    sd, params, g = weights
    want = jpacked.pack_generator_params(params, CD)
    got = packed.pack_generator_params(g.state_dict(), CD)
    assert sorted(got) == sorted(set(want) - {"up4_k", "dec5c_k", "dec5c_s0"})
    for k, v in packed.packed_s0_statics().items():
        assert got[k] == v, k
    for k, v in got.items():
        if isinstance(v, int):
            assert v == want[k], k
            continue
        a = _hwio(v) if v.dim() == 4 else v.numpy()
        assert a.dtype == want[k].dtype, k
        np.testing.assert_array_equal(a, want[k], err_msg=k)


@pytest.mark.parametrize("pad,c", [(1, 3), (2, 3), (2, [3, 5])])
def test_packed_reflect_pad_matches_jax(pad, c):
    ctot = c if isinstance(c, int) else sum(c)
    x = np.random.default_rng(4).standard_normal((2, 8, 6, 4 * ctot)).astype(np.float32)
    want = jpacked.packed_reflect_pad(jnp.asarray(x), pad, c)
    got = packed.packed_reflect_pad(torch.from_numpy(x), pad, c)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("k,pad,stride", [(3, 1, 1), (7, 3, 1), (3, 1, 2)])
def test_packed_conv_matches_jax(k, pad, stride):
    """packed_conv (stride-1 kernels, and the stride-2 consumer that emits an
    unpacked half-res map) on the same packed input and kernel as JAX."""
    rng = np.random.default_rng(5)
    cin, cout = 4, 6
    xp = rng.standard_normal((2, 8, 8, 4 * cin)).astype(np.float32)
    kern = rng.standard_normal((k, k, cin, cout)).astype(np.float32)
    bias = rng.standard_normal((cout,)).astype(np.float32)
    pack = packed.pack_kernel_s1 if stride == 1 else packed.pack_kernel_s2
    kp, s0 = pack(kern, pad)
    want = jpacked.packed_conv(jnp.asarray(xp), jnp.asarray(kp), s0, cin, jnp.asarray(bias),
                               jnp.float32, act=jpacked.leaky)
    got = packed.packed_conv(torch.from_numpy(xp), torch.from_numpy(kp).permute(3, 2, 0, 1), s0,
                             cin, torch.from_numpy(bias), torch.float32, act=packed.leaky)
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("h,w", [(32, 32), (32, 48)])
def test_packed_dec5_head_matches_jax(h, w):
    """The composed head in its deep stride-2 form with its sequential
    border strips, against JAX, at the smallest inputs the generator takes."""
    rng = np.random.default_rng(6)
    k0 = rng.standard_normal((3, 3, CD, CD)).astype(np.float32) * 0.5
    b0 = rng.standard_normal((CD,)).astype(np.float32)
    k1 = rng.standard_normal((7, 7, CD, 3)).astype(np.float32) * 0.5
    b1 = rng.standard_normal((3,)).astype(np.float32)
    pk0, s0_0 = packed.pack_kernel_s1(k0, 1)
    pk1, s0_1 = packed.pack_kernel_s1(k1, 3)
    k9, b9 = packed.compose_dec5_kernels(k0, b0, k1, b1)
    pk9, s0_9 = packed.pack_kernel_s1(k9, 4)
    k6 = packed.compose_dec5_deep_kernel(pk9)
    z = rng.standard_normal((2, h // 2, w // 2, 4 * CD)).astype(np.float32)
    j = jnp.asarray
    want = jpacked.packed_dec5_head(j(z), j(pk9), s0_9, j(b9), j(pk0), s0_0, j(b0), j(pk1),
                                    s0_1, j(b1), CD, jnp.float32, k6=k6, act=jnp.tanh)
    t = lambda a: torch.from_numpy(a).permute(3, 2, 0, 1) if a.ndim == 4 else torch.from_numpy(a)
    got = packed.packed_dec5_head(torch.from_numpy(z), t(k6), t(b9), t(pk0), s0_0, t(b0),
                                  t(pk1), s0_1, t(b1), CD, torch.float32, act=torch.tanh)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-4, atol=2e-4)
    with pytest.raises(ValueError, match="even"):
        packed.packed_dec5_head(torch.from_numpy(z[:, 1:]), t(k6), t(b9), t(pk0), s0_0, t(b0),
                                t(pk1), s0_1, t(b1), CD, torch.float32)


def test_gam_norm_eval_matches_canonical_gam_and_jax(weights):
    """IN(conv1x1(x, W_x)) equals the port's full GAM (the SE branch and the
    fuse bias are constants the instance norm removes) and JAX's
    ``gam_norm_eval``."""
    _, params, g = weights
    x = np.random.default_rng(7).normal(0.0, 1.0, (2, 16, 16, 2 * CD)).astype(np.float32)
    xt = torch.from_numpy(x).permute(0, 3, 1, 2)
    with torch.inference_mode():
        got = packed.gam_norm_eval(xt, packed.gam_x_weight(g.ga2, torch.float32))
        full = g.ga2(xt)
    np.testing.assert_allclose(got.numpy(), full.numpy(), rtol=1e-4, atol=1e-5)
    want = jpacked.gam_norm_eval(jnp.asarray(x), params["ga2"], jnp.float32)
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), np.asarray(want),
                               rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("n,h,w,c,th", [(2, 16, 16, 3, 0), (1, 32, 24, 3, 4), (2, 16, 16, 4, 2),
                                        (1, 4, 2, 1, 0)])
def test_s2d_convert_plain_matches_pallas(n, h, w, c, th):
    """Kernel C's plain version == the interpret-mode Pallas kernel, bit for
    bit (``th`` > 0 forces a grid of several row blocks); the CPU wrapper
    runs the plain version and counts no launch."""
    x = np.random.default_rng(3).uniform(-1, 1, (n, h, w, c)).astype(np.float32)
    want = np.asarray(jax_s2d_convert(jnp.asarray(x), interpret=True, th=th), np.float32)
    before = s2d_convert.launches
    got = s2d_convert(torch.from_numpy(x))
    assert s2d_convert.launches == before
    assert got.dtype == torch.bfloat16 and got.shape == want.shape
    np.testing.assert_array_equal(got.float().numpy(), want)
    np.testing.assert_array_equal(plain_s2d_convert(torch.from_numpy(x)).float().numpy(), want)
    # float32 out: a pure permutation, and its inverse restores x
    got32 = s2d_convert(torch.from_numpy(x), torch.float32)
    np.testing.assert_array_equal(np.asarray(jpacked.space_to_depth(jnp.asarray(x))),
                                  got32.numpy())
    np.testing.assert_array_equal(packed.depth_to_space(got32).numpy(), x)


@pytest.mark.parametrize("n,hp,wp,c,th", [(2, 8, 8, 3, 0), (1, 16, 12, 3, 4), (2, 8, 8, 4, 2),
                                          (1, 1, 1, 5, 0)])
def test_residual_tail_d2s_plain_matches_pallas(n, hp, wp, c, th):
    """Kernel D's plain version == the interpret-mode Pallas kernel, bit for
    bit, NaN and +-inf included (the clip keeps NaN)."""
    rng = np.random.default_rng(3)
    res = rng.uniform(-2, 2, (n, hp, wp, 4 * c)).astype(np.float32)
    xp = rng.uniform(-1, 1, (n, hp, wp, 4 * c)).astype(np.float32)
    res.reshape(-1)[:3] = [np.nan, np.inf, -np.inf]
    xp.reshape(-1)[-2:] = [np.nan, np.inf]
    rj, xj = (jnp.asarray(a).astype(jnp.bfloat16) for a in (res, xp))
    want = np.asarray(jax_residual_tail_d2s(rj, xj, interpret=True, th=th), np.float32)
    rt, xt = (torch.from_numpy(np.asarray(a, np.float32)).to(torch.bfloat16) for a in (rj, xj))
    got = residual_tail_d2s(rt, xt)
    assert got.dtype == torch.bfloat16 and got.shape == want.shape
    assert np.isnan(want).sum() >= 2
    np.testing.assert_array_equal(got.float().numpy(), want)  # NaN positions must agree
    np.testing.assert_array_equal(plain_residual_tail_d2s(rt, xt).float().numpy(), want)


def _s2d_by_row_pairs(x: torch.Tensor, out_dtype: torch.dtype, address: int) -> torch.Tensor:
    """Kernel C as its blocks run, on bytes: for each row pair and column
    block of ``s2d_plan``, the two source runs copied as ``in_word``-byte
    words into one buffer, each output run j = 2 wq + pi taken from source
    row pi's run wq and converted, the output run written back as
    ``out_word``-byte words.  Every run's start and length must be whole
    words, at ``address`` (the input's address mod 16)."""
    n, h, w, c = x.shape
    si, so = x.element_size(), torch.tensor([], dtype=out_dtype).element_size()
    p = s2d_plan(w, c, si, so, address)
    assert p.in_span % 16 == 0 and p.in_span >= 4 * p.pairs * c * si
    assert p.smem == p.in_span + 4 * p.pairs * c * so
    src = x.reshape(-1).view(torch.uint8)
    out = torch.empty(n * h * w * c * so, dtype=torch.uint8)
    wq_total, wc = w // 2, w * c
    for rp in range(n * h // 2):
        for blk in range(p.blocks):
            wq0 = blk * p.pairs
            k = min(p.pairs, wq_total - wq0)
            run = k * 2 * c
            a = (rp * 2 * wc + wq0 * 2 * c) * si  # byte offset of row 2 rp's run
            pieces = []
            for start in (a, a + wc * si):
                assert (address + start) % p.in_word == 0 and run * si % p.in_word == 0
                pieces.append(src[start:start + run * si])
            sin = torch.cat(pieces).view(x.dtype)
            sout = torch.empty(2 * run, dtype=out_dtype)
            for j in range(2 * k):
                pi, wq = j & 1, j >> 1
                sout[j * 2 * c:(j + 1) * 2 * c] = sin[pi * run + wq * 2 * c:
                                                     pi * run + (wq + 1) * 2 * c].to(out_dtype)
            d = (rp * 2 * wc + wq0 * 4 * c) * so
            assert d % p.out_word == 0 and 2 * run * so % p.out_word == 0
            out[d:d + 2 * run * so] = sout.view(torch.uint8)
    return out.view(out_dtype).view(n, h // 2, w // 2, 4 * c)


@pytest.mark.parametrize("shape,tin,tout,address,words", [
    ((2, 16, 32, 3), torch.float32, torch.bfloat16, 0, (16, 16)),  # the main path's row pairs
    ((2, 16, 32, 3), torch.float32, torch.bfloat16, 4, (4, 16)),  # input 4 bytes past 16
    ((2, 12, 10, 3), torch.float32, torch.bfloat16, 0, (8, 8)),
    ((1, 4, 6, 3), torch.bfloat16, torch.bfloat16, 0, (4, 8)),
    ((1, 4, 6, 3), torch.bfloat16, torch.float32, 0, (4, 16)),
    ((1, 4, 6, 3), torch.float32, torch.float32, 0, (8, 16)),
    ((1, 2, 2, 5), torch.float32, torch.bfloat16, 0, (8, 8)),
    ((1, 2, 1400, 3), torch.float32, torch.bfloat16, 0, (16, 16)),  # 3 column blocks
    ((1, 2, 100, 64), torch.bfloat16, torch.bfloat16, 0, (16, 16)),  # 24 pairs a block
])
def test_s2d_kernel_row_pairs_rebuild_space_to_depth(shape, tin, tout, address, words):
    """A mirror of kernel C's index mapping (source words into the output
    row, by row pair and column block) rebuilds space_to_depth bit for bit,
    with the word sizes its plan picks."""
    x = torch.from_numpy(np.random.default_rng(5).uniform(-1, 1, shape).astype(np.float32)).to(tin)
    x.view(-1)[:2] = torch.tensor([float("nan"), float("inf")])
    assert s2d_plan(shape[2], shape[3], x.element_size(), 4 if tout == torch.float32 else 2,
                    address)[2:4] == words
    got = _s2d_by_row_pairs(x, tout, address)
    want = plain_s2d_convert(x, tout)
    as_int = torch.int16 if tout == torch.bfloat16 else torch.int32
    assert torch.equal(got.view(as_int), want.view(as_int))


def test_s2d_wrappers_refuse_what_the_kernels_do_not_take():
    x = torch.zeros(1, 6, 5, 3)
    with pytest.raises(ValueError, match="even"):
        s2d_convert(x)
    with pytest.raises(TypeError):
        s2d_convert(torch.zeros(1, 4, 4, 3), torch.float16)
    r = torch.zeros(1, 2, 2, 12)
    with pytest.raises(ValueError, match="differ"):
        residual_tail_d2s(r, r.to(torch.bfloat16))
    with pytest.raises(ValueError, match="multiple of 4"):
        residual_tail_d2s(torch.zeros(1, 2, 2, 6), torch.zeros(1, 2, 2, 6))


@pytest.mark.parametrize("shape", [(2, 32, 32, 3), (1, 32, 48, 3)])
def test_packed_forward_matches_jax_and_canonical(weights, jax_packed, shape):
    x = np.random.default_rng(8).uniform(-1, 1, shape).astype(np.float32)
    g = weights[2]
    fn = packed.make_packed_eval(g, packed.pack_generator_params(g.state_dict(), CD))
    with torch.inference_mode():
        got = fn(torch.from_numpy(x)).numpy()
        canon = g(torch.from_numpy(x)).numpy()
    assert got.shape == x.shape
    assert float(np.abs(got - x).mean()) > 0.05  # the residual is not ~0
    np.testing.assert_allclose(got, jax_packed(x), rtol=0, atol=1e-4)
    np.testing.assert_allclose(got, canon, rtol=0, atol=2e-3)


def test_cached_constants_serve_autograd_after_inference_mode():
    """The packed path caches its pad indices, phase masks and resize
    matrices; made first under inference mode, they must still serve a
    forward with autograd on (the int8 tables are built that way)."""
    shape, out_hw = (1, 6, 10, 12), (12, 20)  # shapes no other test caches
    with torch.inference_mode():
        packed.packed_reflect_pad(torch.zeros(shape), 2, 3)
        packed.packed_resize2x_align_corners(torch.zeros(shape), out_hw)
    y = torch.randn(shape, requires_grad=True)
    (packed.packed_reflect_pad(y, 2, 3).sum()
     + packed.packed_resize2x_align_corners(y, out_hw).sum()).backward()
    assert y.grad is not None and bool(torch.isfinite(y.grad).all())


def test_make_fast_eval_routing(weights):
    """Packed for the default G with --packed_inference true (int8 under
    --quantized_inference int8); the canonical step otherwise; the strips
    where their gate passes, else the direct packed forward."""
    from uegan_tpu_torch.config import Config

    sd, _, g = weights
    x = torch.from_numpy(np.random.default_rng(9).uniform(-1, 1, (1, 32, 32, 3)).astype(np.float32))
    with torch.inference_mode():
        canon = g(x)
    packed_fn = packed.make_fast_eval(g, Config(packed_inference=True))
    canon_fn = packed.make_fast_eval(g, Config(packed_inference=False))
    torch.testing.assert_close(canon_fn(x), canon, rtol=0, atol=0)
    assert not torch.equal(packed_fn(x), canon)
    torch.testing.assert_close(packed_fn(x), canon, rtol=0, atol=2e-3)
    bn = Generator(conv_dim=CD, norm_fun="BatchNorm")  # not the default config: canonical
    bn.load_state_dict({k: torch.from_numpy(v) for k, v in fan_in_normal_state(bn, 2).items()})
    with torch.inference_mode():
        torch.testing.assert_close(packed.make_fast_eval(bn, Config())(x), bn.eval()(x))
    int8_fn = packed.make_fast_eval(g, Config(quantized_inference="int8"), calib_batch=x)
    assert int8_fn(x).dtype == torch.bfloat16  # the int8 route: bf16 whatever G's dtype
    torch.testing.assert_close(int8_fn(x).float(), packed_fn(x), rtol=0, atol=0.1)
    # a forced strip height the strips cannot take (not > 12) runs the
    # direct packed forward, as in JAX
    torch.testing.assert_close(packed.make_fast_eval(g, Config(strip_rows=8))(x), packed_fn(x),
                               rtol=0, atol=0)
    # a packed height of 1024 takes the strips (r = 128) under the default
    # --strip_rows 0, and gives the direct forward's values
    x2k = torch.from_numpy(np.random.default_rng(10).uniform(-1, 1, (1, 2048, 32, 3))
                           .astype(np.float32))
    direct = packed.make_fast_eval(g, Config(strip_rows=-1))(x2k)
    torch.testing.assert_close(packed_fn(x2k), direct, rtol=0, atol=1e-5)


def test_cli_test_mode_packed_matches_jax(weights, tmp_path, monkeypatch):
    """``python -m uegan_tpu_torch --mode test`` with the default (packed)
    flags on the vendored fixture: its PNGs are within one gray level of the
    JAX Tester's packed u8 forward (``make_fast_eval(u8_output=True)`` after
    ``device_normalize``) on the same batch, and its PSNR CSV equals the JAX
    metric over the same PNGs."""
    from uegan_tpu.metrics.psnr import calc_psnr as jax_calc_psnr
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
    ])
    assert res["n_images"] == 2

    batch = next(iter(get_test_loader(FIXTURE, img_size=32, batch_size=2, num_workers=1,
                                      emit="uint8")))
    cfg = JaxConfig(g_conv_dim=CD, compute_dtype="float32")
    bundle = SimpleNamespace(g_model=JaxGenerator(conv_dim=CD), config=cfg)
    base = jpacked.make_fast_eval(bundle, params, u8_output=True)
    want = np.asarray(jax.jit(lambda p, x: base(p, None, device_normalize(x)))(
        params, jnp.asarray(batch["img_raw"])))
    out_dir = tmp_path / "results" / "UEGAN-FiveK" / "test" / "test_results"
    for i, name in enumerate(batch["img_name"]):
        got = read_png_rgb(str(out_dir / f"{name}_92.00_testFakeExp.png")).astype(np.int16)
        assert np.abs(got - want[i].astype(np.int16)).max() <= 1, name
    jax_calc_psnr(str(out_dir), label_dir, str(tmp_path / "jax_psnr"), 92.0, verbose=False)
    csv = lambda p: (tmp_path / p).read_text().splitlines()
    assert csv("results/psnr_test_results/PSNR_epoch_92.0.csv") == csv("jax_psnr/PSNR_epoch_92.0.csv")


def test_loader_raises_on_an_unreadable_image(tmp_path):
    """An image that does not decode fails the iteration after the batches
    before it, rather than ending the data early (the JAX loader's producer
    ends it, so a test run would score part of the set and exit 0)."""
    root = tmp_path / "test"
    shutil.copytree(FIXTURE, root)
    raws = sorted((root / "raw").iterdir())
    assert len(raws) == 2
    raws[1].write_bytes(b"not a png")
    batches = iter(get_test_loader(str(root), img_size=32, batch_size=1, num_workers=1))
    assert next(batches)["img_name"] == [raws[0].stem]
    with pytest.raises(OSError):
        next(batches)
