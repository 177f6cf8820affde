"""PyTorch port: the two kernels' plain versions against the JAX functions
and the interpret-mode Pallas kernels, the weight bridge, device dispatch,
and the port's independence from JAX.

The CUDA kernels themselves run only on a card; chip_smoke.py holds them
against these plain versions there.
"""

import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from uegan_tpu.convert.torch_import import import_generator
from uegan_tpu.ops.norms import feature_mean_std as jax_feature_mean_std
from uegan_tpu.ops.pallas.gam_stats import gam_mean_std_pallas
from uegan_tpu.ops.pallas.resize2x import upsample2x_ac_pallas
from uegan_tpu.ops.resize import upsample2x_align_corners as jax_upsample2x
from uegan_tpu_torch.convert.from_flax import generator_state_dict
from uegan_tpu_torch.models.generator import Generator
from uegan_tpu_torch.models.initializers import fan_in_normal_state
from uegan_tpu_torch.ops import gam_stats, resize2x
from uegan_tpu_torch.ops.gam_stats import gam_mean_std
from uegan_tpu_torch.ops.resize2x import upsample2x

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One torch thread while this file runs (the suite runs several workers
    on a few cores), restored after it so other files keep their setting."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("shape", [(2, 16, 8, 32), (2, 12, 10, 3), (1, 1, 1, 5)])
def test_gam_mean_std_matches_jax(shape):
    x = np.random.default_rng(3).normal(0.5, 1.5, shape).astype(np.float32)
    mean, std = gam_mean_std(torch.from_numpy(x))
    assert mean.shape == std.shape == (shape[0], 1, 1, shape[3])
    for ref in (jax_feature_mean_std(jnp.asarray(x)),
                gam_mean_std_pallas(jnp.asarray(x), interpret=True)):
        np.testing.assert_allclose(mean.numpy(), np.asarray(ref[0]), rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(std.numpy(), np.asarray(ref[1]), rtol=1e-5, atol=1e-6)


def _plan_pixels(p, hw: int):
    """Per split of ``split_plan``'s plan, the pixels the kernel's loop
    reads: thread row r steps from p0 + r by rows * UNROLL and loads UNROLL
    pixels rows apart, up to the split's end.  (split, pixel) pairs."""
    split = np.arange(p.splits)[:, None, None, None]
    r = np.arange(p.rows)[None, :, None, None]
    step = np.arange(-(-p.chunk // (p.rows * gam_stats.UNROLL)))[None, None, :, None]
    u = np.arange(gam_stats.UNROLL)[None, None, None, :]
    p0 = split * p.chunk
    p1 = np.minimum(p0 + p.chunk, hw)
    at = p0 + r + step * p.rows * gam_stats.UNROLL
    q = at + u * p.rows
    keep = np.broadcast_to((at < p1) & (q < p1), q.shape)
    return np.broadcast_to(split, q.shape)[keep], q[keep]


def _emulate_gam(x: np.ndarray, p) -> tuple:
    """Kernel A as its blocks combine, in float64: each thread's sums over
    its pixels, the block's column sums in lanes, each split's partials
    written, then the last block's sums over splits in lanes; mean and the
    unbiased std as the kernel finishes them."""
    n, h, w, c = x.shape
    hw = h * w
    xs = x.reshape(n, hw, c).astype(np.float64)
    splits, pix = _plan_pixels(p, hw)
    width = p.groups * p.vec
    part = np.zeros((n, p.splits, 2, c))

    def column_sums(m, cols):  # m (rows, cols, 2), lanes as in the kernel
        lanes = max(1, min(m.shape[0], gam_stats.THREADS // cols))
        return sum(m[lane::lanes].sum(0) for lane in range(lanes))

    for s in range(p.splits):
        mine = pix[splits == s]
        owner = (mine - s * p.chunk) % p.rows  # the thread row that reads each pixel
        for t in range(p.tiles):
            c0, c1 = t * width, min((t + 1) * width, c)
            v = np.zeros((n, len(mine), width))
            v[:, :, :c1 - c0] = xs[:, mine, c0:c1]
            per_row = np.stack([np.stack([v[:, owner == r].sum(1), (v[:, owner == r] ** 2).sum(1)],
                                         -1) for r in range(p.rows)], 1)  # (n, rows, width, 2)
            for i in range(n):
                part[i, s, :, c0:c1] = column_sums(per_row[i], width)[:c1 - c0].T
    mean = np.zeros((n, c))
    std = np.zeros((n, c))
    for t in range(p.tiles):
        c0, c1 = t * width, min((t + 1) * width, c)
        for i in range(n):
            s1, s2 = column_sums(part[i, :, :, c0:c1].transpose(0, 2, 1), c1 - c0).T
            m = s1 / hw
            var = (s2 - hw * m * m) / max(hw - 1, 1)
            mean[i, c0:c1], std[i, c0:c1] = m, np.sqrt(np.maximum(var, 0) + 1e-5)
    return mean, std


# the five GAM sites of the 512 px canonical forward at B=8, a batch of one
# at 512 px, ragged shapes, and the five GAM sites of the 256 px train step
# (batch 10, so 20 images through G), whose backward A' takes the same plan
GAM_PLAN_SHAPES = [(8, 512 >> s, 512 >> s, 32 << s) for s in range(5)]
GAM_PLAN_SHAPES += [(1, 512, 512, 32), (2, 12, 10, 3), (1, 1, 1, 5)]
GAM_PLAN_SHAPES += [(20, 256 >> s, 256 >> s, 32 << s) for s in range(5)]


@pytest.mark.parametrize("itemsize", [2, 4])
@pytest.mark.parametrize("shape", GAM_PLAN_SHAPES)
def test_gam_plan_reads_every_pixel_and_channel_once(shape, itemsize):
    """Kernel A's launch plan: its splits and thread rows read every pixel
    of an image exactly once, its tiles and groups every channel exactly
    once, with 16-byte words at the GAM sites, about one wave of blocks on
    the card, and each thread at least UNROLL pixels where the image has
    them."""
    n, h, w, c = shape
    hw = h * w
    p = gam_stats.split_plan(n, hw, c, itemsize)
    splits, pix = _plan_pixels(p, hw)
    assert np.array_equal(np.bincount(pix, minlength=hw), np.ones(hw, np.int64))
    assert np.all((pix >= splits * p.chunk) & (pix < (splits + 1) * p.chunk))
    chans = (np.arange(p.tiles)[:, None, None] * p.groups * p.vec
             + np.arange(p.groups)[None, :, None] * p.vec + np.arange(p.vec)[None, None, :])
    chans = chans[chans < c]
    assert np.array_equal(np.bincount(chans.ravel(), minlength=c), np.ones(c, np.int64))
    assert c % p.vec == 0 and p.vec * itemsize <= 16 and p.groups <= 8
    assert p.rows * p.groups <= gam_stats.THREADS and p.tiles * p.groups * p.vec >= c
    if c >= 32:
        assert p.vec * itemsize == 16
    blocks = n * p.tiles * p.splits
    wave = gam_stats._TARGET_BLOCKS
    assert blocks <= max(wave, n * p.tiles)
    if hw >= wave * p.rows * gam_stats.UNROLL:
        assert blocks >= wave // 2 and p.chunk >= p.rows * gam_stats.UNROLL


@pytest.mark.parametrize("shape,itemsize,address", [
    ((2, 16, 8, 32), 2, 0), ((2, 16, 8, 32), 4, 0), ((1, 8, 8, 512), 2, 0),
    ((2, 12, 10, 3), 4, 0), ((1, 1, 1, 5), 2, 0), ((2, 16, 8, 32), 2, 2)])
def test_gam_kernel_emulation_matches_plain(shape, itemsize, address):
    """An emulation of kernel A's partition and fixed-order combine, in
    float64, equals the plain version run in float64."""
    x = np.random.default_rng(9).normal(0.5, 1.5, shape)
    p = gam_stats.split_plan(shape[0], shape[1] * shape[2], shape[3], itemsize, address)
    if address:
        assert p.vec == 1
    mean, std = _emulate_gam(x, p)
    want_mean, want_std = gam_stats.plain(torch.from_numpy(x))
    np.testing.assert_allclose(mean, want_mean.numpy().reshape(mean.shape), rtol=1e-12,
                               atol=1e-12)
    np.testing.assert_allclose(std, want_std.numpy().reshape(std.shape), rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("offset", [None, 0, 1, 2, 3])
def test_gam_backward_plan_takes_every_pointer_alignment(offset):
    """A' runs on A's plan with the word width that all four x-dtype
    pointers allow: x, dx, dmean or dstd one element past a 16-byte boundary
    (``offset`` names which) drops it to one channel, and every pointer is
    aligned to the word the plan picks."""
    n, h, w, c = 20, 16, 16, 512  # the train step's ga5 site

    def tensor(shape, shifted):
        t = torch.empty(int(np.prod(shape)) + 1, dtype=torch.bfloat16)
        return (t[1:] if shifted else t[:-1]).view(shape)

    x, dx = tensor((n, h, w, c), offset == 0), tensor((n, h, w, c), offset == 1)
    dm, ds = tensor((n, 1, 1, c), offset == 2), tensor((n, 1, 1, c), offset == 3)
    p = gam_stats.backward_plan(x, dx, dm, ds)
    assert p == gam_stats.split_plan(n, h * w, c, 2, 0 if offset is None else 2)
    assert p.vec == (8 if offset is None else 1)
    assert c % p.vec == 0 and all(t.data_ptr() % (2 * p.vec) == 0 for t in (x, dx, dm, ds))


def _emulate_upsample_bwd(dy: np.ndarray, p) -> tuple:
    """Kernel B' as its blocks run, in float64: block b walks tiles b, b +
    grid, ...; each tile stages dy rows 2 i0 - 1 .. 2 (i0 + rows) (those in
    the map) and columns 2 j0 - 1 .. 2 (j0 + cols) (those in the map; the
    rest of the stage holds NaN, as unwritten shared memory holds anything),
    works out each column's horizontal sum over its nonzero-weight taps,
    adds it to input rows lo and lo + 1 and stores row lo once it has all
    its terms.  (dx, how many times each element was written)."""
    n, h2, w2, c = dy.shape
    h, w = h2 // 2, w2 // 2
    mh, mw = resize2x.adjoint_matrix(h), resize2x.adjoint_matrix(w)

    def weight(m, i, s):  # the kernel's adjoint_weight, from the f64 matrix
        o = 2 * i + s - 1
        return m[o, i] if 0 <= i < m.shape[1] and 0 <= o < m.shape[0] else 0.0

    dx = np.full((n, h, w, c), np.nan)
    writes = np.zeros((n, h, w, c), np.int64)
    steps = 2 * p.rows + 2
    words = c // p.vec
    j = np.arange(p.cols)
    walked = []
    for b in range(p.grid):
        for t in range(b, p.tiles, p.grid):
            walked.append(t)
            ct, chunk = t % p.ctiles, t // p.ctiles % p.chunks
            strip = t // (p.ctiles * p.chunks) % p.strips
            img = t // (p.ctiles * p.chunks * p.strips)
            i0, i1, j0 = chunk * p.rows, min(chunk * p.rows + p.rows, h), strip * p.cols
            c0, c1 = ct * p.groups * p.vec, min((ct * p.groups + p.groups) * p.vec, words * p.vec)
            act = j0 + j < w
            cw = np.array([[weight(mw, j0 + jj, q) for q in range(4)] for jj in j])
            staged = 2 * j0 - 1 + np.arange(2 * p.cols + 2)
            ok = (staged >= 0) & (staged < w2)
            acc_lo = acc_hi = np.zeros((p.cols, c1 - c0))
            for cl in range(steps):
                if cl and cl % 2 == 0:
                    acc_lo, acc_hi = acc_hi, np.zeros_like(acc_hi)
                r, lo = 2 * i0 - 1 + cl, i0 - 1 + cl // 2
                if not 0 <= r <= min(2 * i1, 2 * h - 1):
                    continue
                stage = np.full((2 * p.cols + 2, c1 - c0), np.nan)
                stage[ok] = dy[img, r, staged[ok], c0:c1]
                hsum = np.zeros((p.cols, c1 - c0))
                for q in range(4):
                    taps = cw[:, q] != 0
                    hsum = np.where(taps[:, None], hsum + cw[:, q, None] * stage[2 * j + q], hsum)
                if lo >= i0:
                    acc_lo = acc_lo + weight(mh, i0 - 1 + cl // 2, 2 + cl % 2) * hsum
                    if cl % 2 or r == 2 * h - 1:
                        dx[img, lo, j0 + j[act], c0:c1] = acc_lo[act]
                        writes[img, lo, j0 + j[act], c0:c1] += 1
                if lo + 1 < i1:
                    acc_hi = acc_hi + weight(mh, i0 + cl // 2, cl % 2) * hsum
    assert sorted(walked) == list(range(p.tiles))
    return dx, writes


# dx shapes: the four upsample inputs of a cd-8, 32 px train step (batch 2,
# so 4 images through G; (2, 2, 2, 128) ... (2, 16, 16, 16)); H and W not a
# multiple of the tile; H = 1; W = 1; C = 3, 12 and 520; dy one element
# past a 16-byte boundary (narrow words); and a small wave, so that a block
# walks several tiles of the most rows a tile takes, the last one ragged
UP_BWD_CASES = [((4, 32 >> s, 32 >> s, 8 << s), 0, None) for s in range(4, 0, -1)]
UP_BWD_CASES += [((2, 13, 37, 64), 0, None), ((1, 1, 9, 16), 0, None), ((2, 7, 1, 16), 0, None),
                 ((2, 5, 6, 3), 0, None), ((1, 9, 17, 12), 0, None), ((2, 3, 20, 520), 0, None),
                 ((2, 6, 10, 16), 1, None), ((2, 150, 20, 16), 0, 2)]


@pytest.mark.parametrize("itemsize", [2, 4])
@pytest.mark.parametrize("shape,shifted,wave", UP_BWD_CASES)
def test_upsample_bwd_tiling_matches_plain(shape, shifted, wave, itemsize):
    """The tiling of B' (backward_plan and the kernel's staging, horizontal then
    vertical sums and stores, mirrored in numpy) reproduces plain_backward
    in float64, and writes every dx element exactly once."""
    n, h, w, c = shape
    address = shifted * itemsize
    p = resize2x.backward_plan(n, h, w, c, itemsize, address,
                               **({} if wave is None else {"wave": wave}))
    assert c % p.vec == 0 and p.vec * itemsize <= 16 and (address % (p.vec * itemsize) == 0)
    assert p.groups <= resize2x.BWD_MAX_GROUPS and p.cols * p.groups <= resize2x.BWD_THREADS
    assert 1 <= p.rows <= resize2x.BWD_MAX_ROWS and p.grid <= (wave or resize2x.BWD_WAVE)
    if c * itemsize % 16 == 0 and not address:
        assert p.vec * itemsize == 16
    dy = np.random.default_rng(12).normal(size=(n, 2 * h, 2 * w, c))
    got, writes = _emulate_upsample_bwd(dy, p)
    assert np.array_equal(writes, np.ones_like(writes))
    want = resize2x.plain_backward(torch.from_numpy(dy)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("shape", [(2, 8, 8, 4), (1, 16, 8, 4), (2, 12, 10, 3), (1, 1, 5, 2)])
def test_upsample2x_matches_jax(shape):
    x = np.random.default_rng(11).uniform(-1, 1, shape).astype(np.float32)
    got = upsample2x(torch.from_numpy(x)).numpy()
    n, h, w, c = shape
    assert got.shape == (n, 2 * h, 2 * w, c)
    for ref in (jax_upsample2x(jnp.asarray(x)), upsample2x_ac_pallas(jnp.asarray(x), interpret=True)):
        np.testing.assert_allclose(got, np.asarray(ref), rtol=1e-5, atol=1e-6)


def test_cpu_dispatch_and_refusals():
    """A CPU tensor takes the plain path (no launch is counted); inputs the
    kernels do not take raise; asking for CUDA without a card raises."""
    from uegan_tpu_torch.cli import resolve_device

    before = (gam_mean_std.launches, upsample2x.launches)
    x = torch.randn(2, 4, 4, 8)
    gam_mean_std(x)
    upsample2x(x)
    assert (gam_mean_std.launches, upsample2x.launches) == before
    with pytest.raises(TypeError):
        gam_mean_std(x.double())
    with pytest.raises(ValueError):
        upsample2x(x.permute(0, 3, 1, 2))  # not contiguous NHWC
    with pytest.raises(ValueError):
        upsample2x(x[0])  # rank 3
    if torch.cuda.is_available():
        assert resolve_device("cuda").type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            resolve_device("cuda")
    assert resolve_device("cpu").type == "cpu"


@pytest.mark.parametrize("flags", [
    {"mode": "train", "g_norm_fun": "InstanceNorm"}, {"is_test_nima": True}, {"tile_size": 512},
    {"mesh_spatial": 2},
    {"test_keep_aspect": True}, {"quantized_inference": "int8", "strip_rows": 8},
    {"quantized_inference": "int8_pallas", "tile_size": 512}, {"g_use_sn": True},
    {"strip_rows": 8},
])
def test_options_outside_the_slice_raise(flags):
    from uegan_tpu_torch.cli import check_supported
    from uegan_tpu_torch.config import Config

    check_supported(Config(mode="test", is_test_nima=False))
    check_supported(Config(mode="test", is_test_nima=False, packed_inference=False, strip_rows=8))
    for qi in ("int8", "int8_pallas"):
        check_supported(Config(mode="test", is_test_nima=False, quantized_inference=qi))
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        check_supported(Config(**{"mode": "test", "is_test_nima": False, **flags}))


@pytest.mark.parametrize("argv", [[], ["--mode", "test", "--packed_inference", "false",
                                       "--gpu_ids", "0", "--strip_rows", "-1"]])
def test_config_equals_jax_field_by_field(argv):
    """The port's copy of the config parses a command line to the same
    fields and values as the JAX package's."""
    import dataclasses

    from uegan_tpu.config import get_config as jax_get_config
    from uegan_tpu_torch.config import get_config

    got, want = get_config(argv), jax_get_config(argv)
    names = [f.name for f in dataclasses.fields(got)]
    assert names == [f.name for f in dataclasses.fields(want)]
    for name in names:
        assert getattr(got, name) == getattr(want, name), name
        assert type(getattr(got, name)) is type(getattr(want, name)), name
    with pytest.raises(ValueError):
        get_config(["--quantized_inference", "int4"])


@pytest.mark.parametrize("norm_fun", ["none", "BatchNorm"])
def test_bridge_round_trip_is_bit_exact(norm_fun):
    """numpy state dict -> flax tree (import_generator) -> torch state dict
    (from_flax) gives back the same bits, under names the port's Generator
    loads strictly."""
    g = Generator(conv_dim=8, norm_fun=norm_fun)
    sd = fan_in_normal_state(g, seed=5)
    back = generator_state_dict(import_generator(sd))
    assert sorted(back) == sorted(sd)
    for k, v in sd.items():
        assert back[k].dtype == torch.float32
        np.testing.assert_array_equal(back[k].numpy(), v, err_msg=k)
    g.load_state_dict(back, strict=True)


def test_port_imports_no_jax():
    """A fresh interpreter that imports the port's entry points loads no jax
    module and no module of the JAX package."""
    code = ("import sys; import uegan_tpu_torch.cli, uegan_tpu_torch.train.tester, "
            "uegan_tpu_torch.models.generator, uegan_tpu_torch.infer.packed, "
            "uegan_tpu_torch.ops.s2d_fuse, uegan_tpu_torch.data.pipeline, "
            "uegan_tpu_torch.infer.quantized, uegan_tpu_torch.ops.conv_int8, "
            "uegan_tpu_torch.ops.packed_conv_int8, uegan_tpu_torch.ops.packed_conv, "
            "uegan_tpu_torch.train.trainer, uegan_tpu_torch.train.step, "
            "uegan_tpu_torch.train.state, uegan_tpu_torch.train.image_pool, "
            "uegan_tpu_torch.train.schedules, uegan_tpu_torch.models.discriminator, "
            "uegan_tpu_torch.models.vgg, uegan_tpu_torch.losses.gan, "
            "uegan_tpu_torch.losses.perceptual, uegan_tpu_torch.losses.reconstruction, "
            "uegan_tpu_torch.ops.spectral_norm, uegan_tpu_torch.ops.pooling, "
            "uegan_tpu_torch.convert.from_flax, uegan_tpu_torch.utils.checkpoint; "
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', "
            "'uegan_tpu') or m.startswith('jax_')); "
            "assert not bad, bad")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = REPO
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
