"""PyTorch port: the reflect-pad op (ops/reflect_pad.py) on the CPU.

Its plain forward against ``F.pad`` of the concat, its index rule against
numpy's reflect, its plain backward against float64 autograd, the kernel's
tap walk and word stepping (csrc/reflect_pad.cu) mirrored in Python, and
``conv2d_reflect`` on channel parts against the same call on their concat.
The kernel itself runs only on a card; chip_smoke.py holds it bit-equal to
these plain versions there.
"""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from uegan_tpu_torch.ops import reflect_pad as rp
from uegan_tpu_torch.ops.conv import conv2d_reflect

CL = torch.channels_last


def _parts(shape, c2, dtype, seed=0):
    gen = torch.Generator().manual_seed(seed)
    n, c1, h, w = shape
    x = torch.randn(n, c1, h, w, generator=gen).to(dtype).contiguous(memory_format=CL)
    y = None if not c2 else torch.randn(n, c2, h, w, generator=gen).to(dtype).contiguous(
        memory_format=CL)
    return x, y


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("pad", [1, 3])
@pytest.mark.parametrize("c2", [0, 5])
def test_plain_is_f_pad_of_the_concat(c2, pad, dtype):
    x, y = _parts((2, 4, 7, 9), c2, dtype)
    t = x if y is None else torch.cat([x, y], dim=1)
    want = F.pad(t.float(), (pad, pad, pad, pad), mode="reflect").to(dtype)
    for got in (rp.plain(x, y, pad), rp.reflect_pad([x] if y is None else [x, y], pad)):
        assert got.shape == want.shape and got.dtype == dtype
        assert got.is_contiguous(memory_format=CL)
        assert torch.equal(got, want)


@pytest.mark.parametrize("n", [1, 2, 3])
@pytest.mark.parametrize("pad", [1, 2, 3, 5])
def test_index_rule_is_numpys_reflect_for_any_pad(n, pad):
    """Pads as wide as the map or wider (which F.pad refuses) follow numpy."""
    a = np.arange(2 * 3 * n * (n + 1), dtype=np.float32).reshape(2, 3, n, n + 1)
    want = np.pad(a, ((0, 0), (0, 0), (pad, pad), (pad, pad)), mode="reflect")
    np.testing.assert_array_equal(rp.reflect_indices(n, pad).numpy(),
                                  np.pad(np.arange(n), pad, mode="reflect"))
    x = torch.from_numpy(a).contiguous(memory_format=CL)
    for got in (rp.plain(x, None, pad), rp.reflect_pad([x], pad),
                rp.reflect_pad([x[:, :1], x[:, 1:]], pad)):
        np.testing.assert_array_equal(got.numpy(), want)


def _kernel_taps(y: int, n: int, p: int) -> list:
    """csrc/reflect_pad.cu:for_each_tap, step for step."""
    out = [y + p]
    if p < n and p < y < n - 1 - p:
        return out
    if n == 1:
        return out + [i + p for i in range(-p, p + 1) if i != 0]
    period = 2 * (n - 1)

    def ceil_div(a, b):
        return (a + b - 1) // b if a >= 0 else -(-a // b)

    i = min(y + period * ceil_div(-p - y, period), -y + period * ceil_div(y - p, period))
    while i <= n - 1 + p:
        if i != y:
            out.append(i + p)
        # C's remainder truncates toward zero: (i - y) % period == 0 alike
        i += (period if y == n - 1 else 2 * (n - 1 - y)) if (i - y) % period == 0 else 2 * y
    return out


def test_kernel_tap_walk_matches_the_index_rule():
    """Every padded position read back by exactly the dx element it came
    from, centre first and the rest ascending, at n 1..12 and pads 0..14."""
    for n in range(1, 13):
        for p in range(15):
            t = rp.taps(n, p)
            src = rp.reflect_indices(n, p).numpy()
            for y in range(n):
                walk = _kernel_taps(y, n, p)
                assert walk == [int(v) for v in t[y] if v >= 0], (n, p, y)
                assert sorted(walk) == list(np.flatnonzero(src == y)), (n, p, y)


@pytest.mark.parametrize("cw", [1, 3, 8, 24, 64, 255, 256, 300])
def test_kernel_word_stepping_is_divmod(cw):
    """The forward and backward carry (pixel, word) by the block's stride of
    256 words with no division: it must stay divmod(j, cw)."""
    threads = 256
    dq, dr = divmod(threads, cw)
    for t in (0, 1, 100, 255):
        ox, k = divmod(t, cw)
        for j in range(t, 40 * threads, threads):
            assert (ox, k) == divmod(j, cw), (cw, t, j)
            k += dr
            ox += dq
            if k >= cw:
                k -= cw
                ox += 1


@pytest.mark.parametrize("shape,c2,pad", [((2, 3, 6, 5), 4, 1), ((1, 2, 5, 7), 0, 3),
                                          ((2, 2, 3, 4), 3, 2), ((1, 3, 2, 1), 2, 3)])
def test_plain_backward_matches_f64_autograd(shape, c2, pad):
    """Within one float32 rounding of float64 autograd of the plain pad, and
    float64 through it equal to autograd (the sums exact at these sizes)."""
    x, y = _parts(shape, c2, torch.float64, seed=1)
    xs = [x.clone().requires_grad_()] + ([] if y is None else [y.clone().requires_grad_()])
    out = rp.plain(*xs, None, pad) if len(xs) == 1 else rp.plain(*xs, pad)
    dy = torch.randn(out.shape, generator=torch.Generator().manual_seed(2), dtype=torch.float64)
    want = torch.autograd.grad(out, xs, dy)
    got64 = rp.plain_backward(dy, pad, shape[1])
    got32 = rp.plain_backward(dy.float().contiguous(memory_format=CL), pad, shape[1])
    assert len(got64) == len(got32) == len(xs)
    for g64, g32, w in zip(got64, got32, want):
        assert g32.dtype == torch.float32 and g32.is_contiguous(memory_format=CL)
        torch.testing.assert_close(g64, w, rtol=1e-12, atol=1e-12)
        assert float((g32.double() - w).abs().max()) <= 4 * 2.0 ** -24 * float(w.abs().max())


@pytest.mark.parametrize("route", ["op", "reflect_pad"])
def test_the_ops_backward_is_plain_backward(route):
    """Through the custom op (its CPU impl), called itself or by
    ``reflect_pad`` on CPU tensors that need a gradient, the registered
    backward returns plain_backward's parts, bit for bit, in bfloat16."""
    x, y = _parts((2, 8, 6, 5), 8, torch.bfloat16, seed=3)
    x.requires_grad_()
    y.requires_grad_()
    out = rp.reflect_pad_op(x, y, 1) if route == "op" else rp.reflect_pad([x, y], 1)
    assert "uegan_torch_reflect_pad" in type(out.grad_fn).__name__
    dy = torch.randn(out.shape, generator=torch.Generator().manual_seed(4)).to(torch.bfloat16)
    gx, gy = torch.autograd.grad(out, (x, y), dy)
    want = rp.plain_backward(dy.contiguous(memory_format=CL), 1, 8)
    assert torch.equal(gx, want[0]) and torch.equal(gy, want[1])


def test_one_backward_serves_both_autograd_routes():
    """The eager card route (``_ReflectPad``) and the op's registered autograd
    differentiate through the one ``_backward``."""
    assert rp._ReflectPad.backward is rp._backward


@pytest.mark.parametrize("k,dtype", [(3, torch.float32), (7, torch.float32), (3, torch.bfloat16)])
def test_conv2d_reflect_on_parts_is_the_call_on_the_concat(k, dtype):
    u, g = _parts((2, 6, 9, 8), 6, torch.float32, seed=5)
    w = torch.randn(5, 12, k, k, generator=torch.Generator().manual_seed(6))
    b = torch.randn(5, generator=torch.Generator().manual_seed(7))
    want = conv2d_reflect(torch.cat([u, g], dim=1), w, b, dtype=dtype)
    with torch.no_grad():
        assert torch.equal(conv2d_reflect((u, g), w, b, dtype=dtype), want)
    # the CPU gradient path (the op, whose registered backward is plain_backward)
    ur, gr = u.clone().requires_grad_(), g.clone().requires_grad_()
    got = conv2d_reflect((ur, gr), w, b, dtype=dtype)
    assert torch.equal(got, want)
    got.float().sum().backward()
    cat = torch.cat([u, g], dim=1).requires_grad_()
    conv2d_reflect(cat, w, b, dtype=dtype).float().sum().backward()
    assert torch.equal(ur.grad, cat.grad[:, :6]) and torch.equal(gr.grad, cat.grad[:, 6:])


def test_word_width_takes_what_channels_and_pointers_allow():
    assert rp.word_bytes(2, 64, 64, 0) == 16
    assert rp.word_bytes(2, 3, 0, 0) == 2  # D's 3-channel bf16 input
    assert rp.word_bytes(4, 3, 0, 0) == 4
    assert rp.word_bytes(2, 12, 4, 0) == 8
    assert rp.word_bytes(2, 64, 64, 2) == 2
    assert rp.word_bytes(4, 64, 0, 8) == 8


def test_refusals():
    x, y = _parts((2, 4, 6, 6), 4, torch.float32)
    with pytest.raises(ValueError, match="one or two parts"):
        rp.reflect_pad([x, y, y], 1)
    with pytest.raises(ValueError, match="channels-last"):
        rp._launch(x.contiguous(), None, 1)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        rp._launch(x.double().contiguous(memory_format=CL), None, 1)
    with pytest.raises(ValueError, match="differ beyond their channels"):
        rp._launch(x, y[:, :, :5].contiguous(memory_format=CL), 1)
    with pytest.raises(ValueError, match="non-empty rank-4"):
        rp._launch(x[:0], None, 1)
    with pytest.raises(ValueError, match="outside the kernel"):
        rp._launch(x, None, -1)
    with pytest.raises(ValueError, match="reflect_pad_backward: dy"):
        rp._launch_backward(x, 4, 4)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        rp._launch_backward(x.half(), 1, 2)
