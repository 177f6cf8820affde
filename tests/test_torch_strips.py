"""PyTorch port: the exact H-strip executor (uegan_tpu_torch/infer/strips.py)
against the JAX package's on the same weights, and against the port's own
direct packed forward: the helpers (pad rows, slabs, halo refixes, the
per-strip resize matrices, the slab conv, the strip and chunk pickers), the
bf16/f32 executor unchunked, chunked and entry-chunked, the int8 executor
(hybrid and all-int8 entry), and make_fast_eval's routing.  The u8 PNGs of
the strip route are held to quantizing its float output in
tests/test_torch_native.py.

Weights are N(0, 1/fan_in) from a numpy seed, carried to flax through
uegan_tpu.convert.torch_import; cd 8, f32, CPU, one torch thread.  Each JAX
executor is jitted once, in a module fixture.  On the CPU the port runs the
plain versions of kernels B, C and D; chip_smoke.py holds the kernels
against them on the card.
"""

from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from uegan_tpu.convert.torch_import import import_generator
from uegan_tpu.infer import packed as jpacked
from uegan_tpu.infer import quantized as jquant
from uegan_tpu.infer import strips as jstrips
from uegan_tpu.models.generator import Generator as JaxGenerator
from uegan_tpu_torch.config import Config
from uegan_tpu_torch.infer import packed, quantized, strips
from uegan_tpu_torch.models.generator import Generator
from uegan_tpu_torch.models.initializers import fan_in_normal_state, init_weights
from uegan_tpu_torch.utils.seed import setup_seed

CD = 8


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
    """(flax params, port Generator in eval mode, its packed kernels), cd 8."""
    g = Generator(conv_dim=CD)
    sd = fan_in_normal_state(g, seed=1990)
    g.load_state_dict({k: torch.from_numpy(v) for k, v in sd.items()})
    return import_generator(sd)["params"], g.eval(), packed.pack_generator_params(
        g.state_dict(), CD)


@pytest.fixture(scope="module")
def jax_strips(weights):
    """JAX make_strip_eval on the bridged weights, one jit per (strip rows,
    chunk) and input shape, memoized: (r, cs, x) -> output."""
    params = weights[0]
    bundle = SimpleNamespace(g_model=JaxGenerator(conv_dim=CD))
    pk = jpacked.pack_generator_params(params, CD)
    fns = {}

    def run(r, cs, x):
        if (r, cs) not in fns:
            fns[(r, cs)] = jax.jit(jstrips.make_strip_eval(bundle, pk, r, cs))
        return np.asarray(fns[(r, cs)](params, jnp.asarray(x)))

    return run


def _x(shape, seed=3):
    return np.random.default_rng(seed).uniform(-1, 1, shape + (3,)).astype(np.float32)


def _psnr(a, b) -> float:
    mse = float(np.mean((np.asarray(a, np.float64) - np.asarray(b, np.float64)) ** 2))
    return 10.0 * np.log10(4.0 / max(mse, 1e-12))  # range [-1, 1]: peak 2


# ---------------------------------------------------------------------------
# helpers against JAX's
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("c", [None, 3, [2, 3]])
def test_pad_rows_slabs_and_refix_match_jax(c):
    """Reflect pad rows (unpacked, and packed with their phase mix per
    part), overlapping slabs, the row-extended map and its chunk windows,
    and the border-halo refix, each equal to JAX's bit for bit."""
    ctot = 4 * (sum(c) if isinstance(c, list) else c) if c is not None else 5
    x = np.random.default_rng(2).standard_normal((2, 24, 5, ctot)).astype(np.float32)
    t, j = torch.from_numpy(x), jnp.asarray(x)
    if c is None:
        want = jstrips._pad_rows_top_bot(j, 3)
    else:
        want = jstrips._packed_pad_rows_top_bot(j, 3, c)
    for got, w in zip(strips.pad_rows(t, 3, c), want):
        np.testing.assert_array_equal(got.numpy(), np.asarray(w))
    sl = strips.slabs(t, 4, 6, 3, c)
    np.testing.assert_array_equal(sl.numpy(), np.asarray(jstrips._slabs(j, 4, 6, 3, c)))
    xe = strips.extend_rows(t, 3, c)
    np.testing.assert_array_equal(xe.numpy(), np.asarray(jstrips._extend_rows(j, 3, c)))
    np.testing.assert_array_equal(strips.slabs_chunk(xe, 1, 2, 6, 3).numpy(),
                                  np.asarray(jstrips._slabs_chunk(jnp.asarray(xe.numpy()),
                                                                  1, 2, 6, 3)))
    want = jstrips._refix_outer_slab_halos(jnp.asarray(sl.numpy()), 2, 4, 3, c=c)
    got = strips.refix_halos(sl.clone(), 2, range(4), 4, 3, c)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    # a chunk of the middle strips keeps its halos; a last chunk refixes its bottom
    ids = jnp.asarray([2, 3])
    chunk = sl.view(2, 4, *sl.shape[1:])[:, 2:].reshape(4, *sl.shape[1:])
    want = jstrips._refix_exit_halos(jnp.asarray(chunk.numpy()), 2, ids, 4, 3, c)
    got = strips.refix_halos(chunk.clone(), 2, range(2, 4), 4, 3, c)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("hp,s,r", [(64, 4, 16), (56, 4, 14), (96, 3, 32)])
def test_strip_resize_matrices_match_jax(hp, s, r):
    """The per-strip H matrices of up3 (banded) and up4 equal JAX's, and the
    two-tap column resize equals a product with the dense W matrix."""
    m = strips._M_EXIT
    np.testing.assert_array_equal(strips._strip_resize_matrices(hp, s, r, m),
                                  jstrips._strip_resize_matrices(hp, s, r, m))
    got, want = strips._strip_up3_matrices(hp, s, r, m), jstrips._strip_up3_matrices(hp, s, r, m)
    np.testing.assert_array_equal(got[0], want[0])
    assert got[1:] == want[1:]
    t = np.random.default_rng(1).standard_normal((2, 3, r, 5)).astype(np.float32)
    dense = np.einsum("pw,nhwc->nhpc", packed._interp_matrix_np(r, 2 * r).astype(np.float64), t)
    np.testing.assert_allclose(strips.resize2x_cols(torch.from_numpy(t), torch.float32).numpy(),
                               dense, rtol=0, atol=1e-6)


@pytest.mark.parametrize("k,pad,stride,parts", [(7, 3, 1, [3]), (3, 1, 2, [4]),
                                                (3, 1, 1, [2, 3])])
def test_slab_conv_matches_jax_on_rows_off_the_h_edges(k, pad, stride, parts):
    """The slab conv (W packed reflect, H zero pad; parts concatenated into
    its buffer) equals JAX's ``packed_conv(h_fixups=False)`` on every row
    its H edge does not reach: the rest is the margin the halos discard."""
    rng = np.random.default_rng(5)
    cin, cout = sum(parts), 6
    xs = [rng.standard_normal((2, 12, 8, 4 * c)).astype(np.float32) for c in parts]
    kern = rng.standard_normal((k, k, cin, cout)).astype(np.float32)
    bias = rng.standard_normal((cout,)).astype(np.float32)
    kp, s0 = (packed.pack_kernel_s1 if stride == 1 else packed.pack_kernel_s2)(kern, pad)
    if len(parts) > 1:
        kp = packed.interleave_input_channels(kp, parts)
    c_in = parts if len(parts) > 1 else parts[0]
    want = jpacked.packed_conv(jnp.concatenate([jnp.asarray(a) for a in xs], -1),
                               jnp.asarray(kp), s0, c_in, jnp.asarray(bias), jnp.float32,
                               h_fixups=False, act=jpacked.leaky)
    got = strips.slab_conv([torch.from_numpy(a) for a in xs],
                           torch.from_numpy(kp).permute(3, 2, 0, 1), s0, c_in,
                           torch.from_numpy(bias), torch.float32, act=packed.leaky)
    assert got.shape == want.shape
    s1 = kp.shape[0] - 1 - s0
    rows = slice(s0, got.shape[1] - s1)
    np.testing.assert_allclose(got[:, rows].numpy(), np.asarray(want)[:, rows], rtol=1e-5,
                               atol=1e-5)


def test_pickers_match_jax():
    """pick_strip_rows and pick_strip_chunks are JAX's, over a grid of
    packed heights, batches and slab shapes (pure Python)."""
    for hp in list(range(512, 4200, 2)) + [6000, 8192]:
        for n in (1, 2, 4, 8):
            assert strips.pick_strip_rows(hp, n) == jstrips.pick_strip_rows(hp, n), (hp, n)
    for n in (1, 2, 4):
        for s in (2, 3, 4, 8, 16, 24, 32, 64):
            for wp in (256, 1024, 2048, 4096, 6144):
                for hs in (140, 76):
                    assert (strips.pick_strip_chunks(n, s, hs, wp)
                            == jstrips.pick_strip_chunks(n, s, hs, wp)), (n, s, hs, wp)


# ---------------------------------------------------------------------------
# the executor against JAX, and against the port's direct packed forward
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("shape,r,cs,entry_chunked", [
    ((1, 112, 64), 14, -1, False),  # 4 strips; a divisor that is not a multiple of 16
    ((1, 96, 64), 16, 2, False),    # 3 strips, chunked 2 -> 1 strip a chunk
    ((1, 96, 64), 16, 2, True),     # the same, enc1/enc2 recomputed per chunk
])
def test_strip_eval_matches_jax(weights, jax_strips, shape, r, cs, entry_chunked):
    """The port's executor against JAX's make_strip_eval on the same
    weights, within 1e-5 (JAX's entry-chunked output is its resident
    chunked output bit for bit, tests/test_strips.py)."""
    _, g, pk = weights
    x = _x(shape)
    got = strips.make_strip_eval(g, pk, r, cs, entry_chunked=entry_chunked)(torch.from_numpy(x))
    want = jax_strips(r, cs, x)
    assert got.shape == want.shape and got.dtype == torch.float32
    assert float(np.abs(want - x).mean()) > 0.05  # the residual is not ~0
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)


@pytest.fixture(scope="module")
def amplified():
    """G at the config's init (orthogonal, gain 0.02, seed 1990) with every
    weight x 8, and its packed kernels: the amplified border that exposes a
    missing halo refix (tests/test_strips.py:44-69)."""
    g = Generator(conv_dim=CD)
    init_weights(g, "orthogonal", 0.02, setup_seed(1990))
    g.load_state_dict({k: v * 8.0 for k, v in g.state_dict().items()})
    return g.eval(), packed.pack_generator_params(g.state_dict(), CD)


@pytest.mark.parametrize("shape,cs", [((1, 128, 64), -1), ((1, 128, 64), 2), ((2, 64, 64), -1),
                                      ((2, 64, 64), 1)])
def test_strip_border_rows_exact_scaled(amplified, shape, cs):
    """With amplified weights the strips (unchunked and chunked) equal the
    port's own direct packed forward within 1e-5, border rows included;
    without the halo refixes the border rows miss by about 2e-4."""
    g, pk = amplified
    x = torch.from_numpy(_x(shape, seed=4))
    with torch.inference_mode():
        want = packed.make_packed_eval(g, pk)(x)
    got = strips.make_strip_eval(g, pk, 16, cs)(x)
    assert float((want - x).abs().mean()) > 1e-5  # the border rows' error would show
    torch.testing.assert_close(got, want, rtol=0, atol=1e-5)


def test_chunked_entry_chunked_and_slab_unpack(weights, monkeypatch):
    """On the CPU: the chunked exit within 1e-6 of the unchunked one; the
    entry-chunked path bit-equal to the resident chunked one, and inert
    without a chunked exit; the per-slab unpack (``_SLAB_UNPACK_MIN``
    shrunk: kernel D on each slab's window of kept rows) bit-equal to the
    full-height one; make_strip_fast_eval packs G's weights as the callers
    do."""
    _, g, pk = weights
    x = torch.from_numpy(_x((2, 96, 64), seed=6))
    un = strips.make_strip_eval(g, pk, 16, -1)(x)
    ch = strips.make_strip_eval(g, pk, 16, 1)(x)
    torch.testing.assert_close(ch, un, rtol=0, atol=1e-6)
    assert torch.equal(strips.make_strip_eval(g, pk, 16, 1, entry_chunked=True)(x), ch)
    assert torch.equal(strips.make_strip_eval(g, pk, 16, -1, entry_chunked=True)(x), un)
    assert torch.equal(strips.make_strip_fast_eval(g, 16, -1)(x), un)
    monkeypatch.setattr(strips, "_SLAB_UNPACK_MIN", 8)
    assert torch.equal(strips.make_strip_eval(g, pk, 16, -1)(x), un)


def test_int8_strips_match_jax(weights):
    """The int8 executor (bf16 entry, int8 exit: the tables' default) on the
    JAX tables against JAX's make_int8_strip_eval, both in bf16: >= 40 dB
    and max |d| <= 0.05; the all-int8 entry >= 30 dB from the bf16 strips
    and not the hybrid's output (tests/test_quantized.py:233-237)."""
    params, g, pk = weights
    bundle = SimpleNamespace(g_model=JaxGenerator(conv_dim=CD, dtype=jnp.bfloat16))
    x = _x((2, 64, 64), seed=5)
    jt = jquant.build_quant_tables(bundle, params, x)
    want = np.asarray(jax.jit(jstrips.make_int8_strip_eval(bundle, jt, 16))(
        params, None, jnp.asarray(x)), np.float32)
    tabs = quantized.build_quant_tables(g, scales=jt["sc"])
    assert tabs["entry_int8"] is False
    got = strips.make_int8_strip_eval(g, tabs, 16)(torch.from_numpy(x))
    assert got.dtype == torch.bfloat16 and got.shape == x.shape
    got = got.float().numpy()
    psnr, dmax = _psnr(got, want), float(np.abs(got - want).max())
    assert psnr >= 40.0 and dmax <= 0.05, (psnr, dmax)
    bf = strips.make_strip_eval(quantized.bf16_interior(g), pk, 16)(torch.from_numpy(x))
    bf = bf.float().numpy()
    assert 30.0 <= _psnr(got, bf) < 100.0
    full = strips.make_int8_strip_eval(g, dict(tabs, entry_int8=True), 16)(torch.from_numpy(x))
    full = full.float().numpy()
    assert _psnr(full, bf) >= 30.0
    assert not np.array_equal(full, got)


def test_make_fast_eval_routes_to_strips(weights):
    """A forced --strip_rows that passes the gate takes the strips (their
    output bit for bit); one that does not divide the packed height runs
    the direct packed forward, as in JAX; -1 never strips."""
    _, g, pk = weights
    x = torch.from_numpy(_x((1, 64, 64), seed=7))
    with torch.inference_mode():
        direct = packed.make_packed_eval(g, pk)(x)
    want = strips.make_strip_eval(g, pk, 16, 0)(x)
    assert not torch.equal(want, direct)
    assert torch.equal(packed.make_fast_eval(g, Config(strip_rows=16))(x), want)
    assert torch.equal(packed.make_fast_eval(g, Config(strip_rows=14))(x), direct)  # 32 % 14
    assert torch.equal(packed.make_fast_eval(g, Config(strip_rows=-1))(x), direct)
    int8 = packed.make_fast_eval(g, Config(strip_rows=16, quantized_inference="int8_pallas"),
                                 calib_batch=x)
    tabs = quantized.build_quant_tables(g, calib_batch=x)
    assert torch.equal(int8(x), strips.make_int8_strip_eval(g, tabs, 16)(x))
