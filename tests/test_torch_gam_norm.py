"""PyTorch port: the GAM's instance norm at inference as the op
``uegan_torch::gam_norm`` (ops/gam_norm.py, on the card the norm layers'
forward pair of csrc/norm_act.cu).

On the CPU, at the verify fixture's sizes (cd 8, 32 px), one torch thread:
the op's CPU form is ``instance_norm`` bit for bit on an interior map and on
the packed ga1 view; the packed forward gives the bits it gave with the
PyTorch chain in its place, and calls the op five times; the apply kernel's
back-to-front walk, mirrored in Python, writes every pixel once; a trace
records the op (``torch.export``), on fake CUDA tensors without a launch;
the CUDA impl raises where the kernels cannot be built, and a call that
autograd would record is refused.  On a card (the
``card`` marker; it skips here): the kernel pair against the plain form in
float64, float32 and bfloat16.
"""

import numpy as np
import pytest
import torch

from uegan_tpu_torch.infer import packed
from uegan_tpu_torch.models.generator import Generator
from uegan_tpu_torch.models.initializers import fan_in_normal_state
from uegan_tpu_torch.ops import _build, gam_norm as gn, gam_stats, norm_act
from uegan_tpu_torch.ops.norms import instance_norm

CD, HW, B = 8, 32, 2
DTYPES = [torch.float32, torch.bfloat16]


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One torch thread while this file runs, restored after it."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _map(shape, dtype, seed=5):
    gen = torch.Generator().manual_seed(seed)
    return (torch.randn(shape, generator=gen) * 2 + 0.5).to(dtype)


def _old_packed_instance_norm(xp, c, eps=1e-5):
    """ga1's norm as the packed forward ran it before the op: the PyTorch
    chain over the (N, H/2, W/2, 4, C) view."""
    n, hp, wp, _ = xp.shape
    acc = xp.float().reshape(n, hp, wp, 4, c)
    mean = acc.mean(dim=(1, 2, 3), keepdim=True)
    sq = (acc * acc).mean(dim=(1, 2, 3), keepdim=True)
    var = torch.clamp(sq - mean * mean, min=0.0)
    y = (acc - mean) * torch.rsqrt(var + eps)
    return y.reshape(n, hp, wp, 4 * c).to(xp.dtype)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("where", ["interior", "packed"])
def test_cpu_form_is_instance_norm_bit_for_bit(where, dtype):
    """The op's CPU impl, and the wrapper, equal ``instance_norm`` of the
    NCHW view bit for bit: at ga2's place (an NHWC conv output), and on the
    packed ga1 map's (N, H/2, W/2 * 4, C) view, where ``packed_instance_norm``
    also equals the chain the packed forward ran before."""
    if where == "interior":
        x = _map((B, HW // 2, HW // 2, 2 * CD), dtype)
        got_op = torch.ops.uegan_torch.gam_norm(x, 1e-5)
        got = gn.gam_norm(x)
    else:
        xp = _map((B, HW // 2, HW // 2, 4 * CD), dtype)
        x = xp.view(B, HW // 2, HW // 2 * 4, CD)
        got_op = torch.ops.uegan_torch.gam_norm(x, 1e-5)
        got = packed.packed_instance_norm(xp, CD).view(x.shape)
        assert torch.equal(got, _old_packed_instance_norm(xp, CD).view(x.shape))
    want = instance_norm(x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    assert got.dtype == dtype and got.is_contiguous() and got_op.is_contiguous()
    assert torch.equal(got_op, want) and torch.equal(got, want)


@pytest.mark.parametrize("dtype", DTYPES)
def test_packed_forward_unchanged_and_calls_the_op_five_times(dtype, monkeypatch):
    """``make_packed_eval`` gives the bits it gave with the PyTorch chain as
    its GAM norm (ga2 .. ga5 by ``instance_norm`` on the NCHW conv output,
    ga1 by the 5-d chain), and calls ``gam_norm`` five times a forward."""
    g = Generator(conv_dim=CD, dtype=dtype)
    g.load_state_dict({k: torch.from_numpy(v) for k, v in fan_in_normal_state(g, 11).items()})
    g.eval()
    fwd = packed.make_packed_eval(g, packed.pack_generator_params(g.state_dict(), CD))
    x = torch.rand((B, HW, HW, 3), generator=torch.Generator().manual_seed(2)) * 2 - 1
    with torch.inference_mode():
        before = gn.gam_norm.launches
        y = fwd(x)
        assert gn.gam_norm.launches - before == 5
        monkeypatch.setattr(packed, "gam_norm_eval", lambda t, w: instance_norm(
            torch.nn.functional.conv2d(t.to(w.dtype), w)))
        monkeypatch.setattr(packed, "packed_instance_norm", _old_packed_instance_norm)
        assert torch.equal(fwd(x), y)


def _apply_walk(p, hw):
    """The pixels each (split, thread row) of norm_act's forward apply
    kernel writes, in the kernel's order: from the last step of the run back
    to the first."""
    out = []
    step = p.rows * gam_stats.UNROLL
    for s in range(p.splits):
        p0 = s * p.chunk
        p1 = min(p0 + p.chunk, hw)
        for r in range(p.rows):
            if p0 + r >= p1:
                continue
            q0 = p0 + r + (p1 - 1 - p0 - r) // step * step
            starts = range(q0, p0 - 1, -step)
            assert starts[-1] == p0 + r  # the walk ends on the stats loop's first step
            out += [q for a in starts for q in range(a, a + step, p.rows) if q < p1]
    return np.asarray(out, np.int64)


@pytest.mark.parametrize("n,hw,c", [(16, 1024, 512), (16, 4096, 256), (1, 16384, 32),
                                    (2, 1, 5), (2, 120, 12), (3, 777, 64), (1, 5000, 3)])
def test_apply_walk_writes_every_pixel_once(n, hw, c):
    """The forward apply's back-to-front walk writes each pixel of an image
    once and stays inside its split's run, on the plan of the norm layers
    (the image's own batch) and of the GAM norm (a batch of PLAN_IMAGES)."""
    for groups in (n, gn.PLAN_IMAGES):
        p = gam_stats.split_plan(groups, hw, c, 2)
        pix = _apply_walk(p, hw)
        assert np.array_equal(np.bincount(pix, minlength=hw), np.ones(hw, np.int64))
    plan = norm_act._plan(torch.Size((n, c, 1, hw)), torch.bfloat16, True, 0, gn.PLAN_IMAGES)
    assert (plan.splits, plan.chunk) == (p.splits, p.chunk)


class _Norm(torch.nn.Module):
    def forward(self, x):
        return gn.gam_norm(x) * 2


def test_export_records_the_op_and_counts_no_launch():
    """``torch.export`` of a module that calls ``gam_norm`` records the op
    (its fake kernel runs, nothing is counted), and the program computes
    what the eager module does."""
    x = _map((B, 8, 8, 16), torch.float32)
    before = gn.gam_norm.launches
    prog = torch.export.export(_Norm(), (x,))
    assert gn.gam_norm.launches == before
    ops = [str(n.target) for n in prog.graph.nodes if n.op == "call_function"]
    assert "uegan_torch.gam_norm.default" in ops, ops
    assert torch.equal(prog.module()(x), _Norm()(x))


def test_fake_cuda_traces_and_the_cuda_impl_never_falls_back(monkeypatch):
    """On fake CUDA tensors the op runs its fake kernel (shape, dtype, no
    launch, no library built); the CUDA impl raises where the library cannot
    be built; a call that autograd would record is refused, on a card and
    on the CPU."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    before, lib = gn.gam_norm.launches, _build._lib
    with FakeTensorMode():
        y = torch.ops.uegan_torch.gam_norm(torch.empty(B, 4, 4, 32, device="cuda",
                                                       dtype=torch.bfloat16), 1e-5)
        with pytest.raises(RuntimeError, match="no backward"):
            gn.gam_norm(torch.empty(B, 4, 4, 32, device="cuda", requires_grad=True))
    assert (tuple(y.shape), y.dtype, y.device.type) == ((B, 4, 4, 32), torch.bfloat16, "cuda")
    assert gn.gam_norm.launches == before and _build._lib is lib
    with pytest.raises(RuntimeError, match="no backward"):
        gn.gam_norm(_map((B, 4, 4, 8), torch.float32).requires_grad_())
    assert gn.gam_norm.launches == before

    def no_library():
        raise RuntimeError("nvcc not found")

    monkeypatch.setattr(_build, "load", no_library)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        gn._launch(_map((B, 4, 4, 32), torch.float32), 1e-5)
    with pytest.raises(ValueError, match="contiguous"):
        gn._launch(_map((B, 4, 4, 32), torch.float32).transpose(1, 2), 1e-5)


# (shape, misaligned): C from 32 to 512 at the GAM sites, one pixel, pixel
# counts that no thread row or word count divides, narrow words (C = 3, 12),
# a map starting one element past 16 bytes, and the packed ga1 view
CARD_CASES = [((4, 64, 64, 32), False), ((4, 32, 32, 64), False), ((2, 16, 16, 128), False),
              ((2, 16, 16, 256), False), ((2, 8, 8, 512), False), ((3, 1, 1, 64), False),
              ((2, 1, 1, 5), False), ((2, 13, 7, 32), False), ((2, 5, 3, 12), False),
              ((1, 37, 11, 3), False), ((2, 24, 24, 64), True), ((2, 64, 256, 32), False)]


@pytest.mark.card
def test_pair_on_the_card_matches_the_plain_form():
    """The kernel pair against the plain form run in float64: within 1e-5 in
    float32, within one bf16 ulp in bfloat16; two calls give the same bits,
    and an image alone the bits it gets in a batch; the packed view through
    ``packed_instance_norm``."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    gen = torch.Generator(device="cuda").manual_seed(7)
    for shape, misaligned in CARD_CASES:
        for dtype in DTYPES:
            x = (torch.randn(shape, generator=gen, device="cuda") * 2 + 1).to(dtype)
            if misaligned:
                x = torch.empty(x.numel() + 1, dtype=dtype, device="cuda")[1:].view(
                    shape).copy_(x)
            before = gn.gam_norm.launches
            got = gn.gam_norm(x)
            again = gn.gam_norm(x)
            assert gn.gam_norm.launches - before == 2
            want = gn.plain(x.double())
            torch.cuda.synchronize()
            assert torch.equal(got.view(torch.uint8), again.view(torch.uint8)), shape
            assert _close(got, want, dtype), (shape, dtype,
                                              float((got.double() - want).abs().max()))
    # an image's output is the same alone as in a batch (the plan's partition
    # of an image does not depend on the batch)
    x = (torch.randn((16, 32, 32, 64), generator=gen, device="cuda")).to(torch.bfloat16)
    y = gn.gam_norm(x)
    assert all(torch.equal(gn.gam_norm(x[i:i + 1].clone())[0], y[i]) for i in (0, 9, 15))
    xp = (torch.randn((2, 64, 64, 4 * 32), generator=gen, device="cuda")).to(torch.bfloat16)
    got = packed.packed_instance_norm(xp, 32)
    want = gn.plain(xp.double().view(2, 64, 256, 32)).view(xp.shape)
    assert _close(got, want, torch.bfloat16)


def _close(got, want, dtype) -> bool:
    """float32: within 1e-5 plus 1e-5 of each value; bfloat16: within one
    ulp of each value, at least 1e-5 (outputs that cancel to about 0 keep
    the f32 statistics' round-off), as chip_smoke.py holds kernel A."""
    d = (got.double() - want).abs()
    if dtype == torch.float32:
        return bool((d <= 1e-5 + 1e-5 * want.abs()).all())
    ulp = torch.exp2(torch.floor(torch.log2(want.abs().clamp_min(2.0 ** -126))) - 7)
    return bool((d <= ulp.clamp_min(1e-5)).all())
