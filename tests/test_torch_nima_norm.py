"""PyTorch port, NIMA's train-mode BatchNorms on the norm_act pair
(``ops/norm_act.py``, ``csrc/norm_act.cu``): the pair with ReLU6 (``cap``),
ReLU (slope 0, ``strict``) and no activation (slope 1), running statistics
by flax's rule (``unbiased=False``), against torch's autograd of the same
chain in float64, z exactly at 0 and at 6 included; the NIMA train step on
the CPU against the benchmark's plain reference
(``portbench/reference/nima_train.py``); the 53 norm calls a train forward
and backward (and none in eval mode) against ``portbench/counts/nima.py``;
the training loop's spans and step counter.  On a card (the ``card``
marker; it skips here) the kernel pair at NIMA's 53 maps at B=128 against
the plain form run in float64.  No JAX here: the JAX parity of the step is
``tests/test_torch_nima_train.py``'s.
"""

import math

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from uegan_tpu_torch.models.nima import NIMA
from uegan_tpu_torch.nima_train.train import make_nima_train_step, train_batch
from uegan_tpu_torch.ops import norm_act as na
from uegan_tpu_torch.utils import spans

# name: (norm_act's activation arguments, torch's activation)
ACTS = {"relu6": ({"slope": 0.0, "cap": 6.0}, lambda z: torch.clamp(z, 0.0, 6.0)),
        "relu": ({"slope": 0.0, "strict": True}, F.relu),
        "none": ({"slope": 1.0}, lambda z: z)}


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One torch thread while this file runs, restored after it."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _chain(x, w, b, rm, rv, act, eps):
    """Train-mode BatchNorm from its two-pass statistics and the activation,
    in float64 under autograd; flax's running statistics (momentum 0.9, the
    biased variance) moved in place."""
    mean = x.mean(dim=(0, 2, 3), keepdim=True)
    var = torch.square(x - mean).mean(dim=(0, 2, 3), keepdim=True)
    with torch.no_grad():
        rm.copy_(0.9 * rm + 0.1 * mean.flatten())
        rv.copy_(0.9 * rv + 0.1 * var.flatten())
    z = (x - mean) / torch.sqrt(var + eps) * w.view(1, -1, 1, 1) + b.view(1, -1, 1, 1)
    return ACTS[act][1](z)


def _boundary_case(gen):
    """Channels 0-1 of x hold +-1 in equal numbers (mean 0, biased variance
    1), so that with eps 0 their z is exactly w * (+-1) + b: channel 0 has
    w = b = 3 (z at 0 and 6), channel 1 w = 6, b = 0 (z at -6 and 6); the
    other channels are random."""
    n, c, h, w = 2, 4, 4, 3
    x = torch.randn(n, c, h, w, generator=gen, dtype=torch.float64) * 2 + 0.5
    signs = torch.tensor([1.0, -1.0] * (n * h * w // 2), dtype=torch.float64)
    for ch in (0, 1):
        x[:, ch] = signs[torch.randperm(n * h * w, generator=gen)].view(n, h, w)
    weight = torch.tensor([3.0, 6.0, 1.3, 0.8], dtype=torch.float64)
    bias = torch.tensor([3.0, 0.0, 0.2, -0.4], dtype=torch.float64)
    return x, weight, bias, 0.0


def _random_case(gen):
    x = torch.randn(3, 5, 6, 4, generator=gen, dtype=torch.float64) * 2 + 0.7
    weight = 1 + 0.3 * torch.randn(5, generator=gen, dtype=torch.float64)
    bias = 0.3 * torch.randn(5, generator=gen, dtype=torch.float64)
    return x, weight, bias, 1e-5


@pytest.mark.parametrize("case", ["random", "boundary"])
@pytest.mark.parametrize("act", sorted(ACTS))
def test_pair_with_cap_and_biased_stats_matches_torch_f64(act, case):
    """``norm_act`` under autograd (the plain versions on the CPU) with the
    activation's arguments and ``unbiased=False``: y, the running mean and
    the biased running variance, dx, dweight and dbias equal torch's
    autograd of the chain within 1e-12; at z exactly 0 and 6 the gradient
    follows torch.clamp (passes at both ends) and F.relu (none at 0)."""
    gen = torch.Generator().manual_seed(11 if case == "random" else 12)
    x0, w0, b0, eps = (_random_case if case == "random" else _boundary_case)(gen)
    c = x0.shape[1]
    x0 = x0.to(memory_format=torch.channels_last)
    rm0 = 0.1 * torch.randn(c, generator=gen, dtype=torch.float64)
    rv0 = 1 + torch.rand(c, generator=gen, dtype=torch.float64)
    dy = torch.randn(x0.shape, generator=gen, dtype=torch.float64)

    leaves = [t.clone().requires_grad_(True) for t in (x0, w0, b0)]
    rm, rv = rm0.clone(), rv0.clone()
    want = _chain(*leaves, rm, rv, act, eps)
    want_grads = torch.autograd.grad(want, leaves, dy)

    got_in = [t.clone().requires_grad_(True) for t in (x0, w0, b0)]
    got_rm, got_rv = rm0.clone(), rv0.clone()
    y = na.norm_act(got_in[0], got_in[1], got_in[2], got_rm, got_rv, False, momentum=0.1,
                    eps=eps, unbiased=False, **ACTS[act][0])
    got_grads = torch.autograd.grad(y, got_in, dy)
    if case == "boundary":
        z = (x0[:, :2] * w0[:2].view(1, -1, 1, 1) + b0[:2].view(1, -1, 1, 1))
        assert {float(v) for v in z.unique()} == {-6.0, 0.0, 6.0}
    for name, a, e in (("y", y, want), ("running_mean", got_rm, rm), ("running_var", got_rv, rv),
                       ("dx", got_grads[0], want_grads[0]), ("dweight", got_grads[1],
                                                            want_grads[1]),
                       ("dbias", got_grads[2], want_grads[2])):
        np.testing.assert_allclose(a.detach().numpy(), e.detach().numpy(), rtol=1e-12,
                                   atol=1e-12, err_msg=name)


def _seeded(seed: int, hw: int, n: int):
    from portbench.drivers import nima_train as drv

    cpu = torch.device("cpu")
    weights = drv.seeded_weights(seed, cpu)
    images, targets = drv.seeded_examples({"examples": n, "image_hw": hw}, seed, cpu)
    return weights, images, targets


def test_step_matches_the_plain_reference():
    """One float32 train step at B = 4, 32 px on the benchmark's seeded
    weights (dropout 0.75 from the same seeded generator on both sides): the
    port (the plain versions) against portbench/reference/nima_train.py's
    ReferenceTrainer.  The loss within rel 1e-6; each leaf's gradient within
    1e-4 of the larger of its norm and the median leaf's (measured 6e-6: at
    32 px the last stages normalize 4 values a channel, and the two sides'
    float32 sums differ in order); the running statistics within 1e-6
    (measured: the same bits); the parameters after Adam's first step within
    2 lr, and all but 1e-3 of the elements within 1e-5 (Adam's first step
    moves an element by about lr in the sign of its gradient, which
    round-off decides where the gradient nearly cancels; measured 0.05%)."""
    from portbench.reference.nima_train import ReferenceTrainer

    weights, images, targets = _seeded(5, 32, 4)
    lr = 3e-4
    model = NIMA(dropout_rate=0.75).load_reference(weights)
    opt = torch.optim.Adam(model.parameters(), lr=lr, eps=1e-8)
    step = make_nima_train_step(model, opt, torch.Generator().manual_seed(8))
    ref = ReferenceTrainer(weights, 8, lr=lr)
    x, t = torch.from_numpy(images), torch.from_numpy(targets)
    loss, want = step(x, t), ref.step(x, t)
    np.testing.assert_allclose(float(loss), float(want), rtol=1e-6)

    grads, want_grads = {k: p.grad for k, p in model.named_parameters()}, ref.last_grads()
    assert set(grads) == set(want_grads) and len(grads) == 2 + 53 * 3
    med = float(np.median([float(g.norm()) for g in want_grads.values()]))
    for k, g in want_grads.items():
        assert float((grads[k] - g).norm()) <= 1e-4 * max(float(g.norm()), med), k
    state, stats = model.state_dict(), ref.running_stats()
    assert len(stats) == 2 * 53
    for k, v in stats.items():
        np.testing.assert_allclose(state[k].numpy(), v.numpy(), rtol=0, atol=1e-6, err_msg=k)
        assert not torch.equal(state[k], weights[k]), k  # the step moved it
    n_all = n_off = 0
    for k, v in ref.leaves.items():
        d = (state[k] - v.detach()).abs()
        assert float(d.max()) <= 2 * lr, (k, float(d.max()))
        n_all += d.numel()
        n_off += int((d > 1e-5).sum())
    assert n_off <= 1e-3 * n_all, (n_off, n_all)


def test_norm_calls_a_train_forward_and_backward():
    """A train-mode forward makes one norm_act call a BN, 53, and its
    backward 53 (``portbench/counts/nima.py``'s maps, in order and shape);
    an eval-mode forward makes none and leaves the running statistics."""
    from portbench.counts import nima as counts

    weights, images, _ = _seeded(6, 32, 2)
    model = NIMA().load_reference(weights)
    x = torch.from_numpy(images)
    seen = []
    real = na.norm_act

    def spy(y, *a, **k):
        seen.append(tuple(y.shape))
        return real(y, *a, **k)

    import uegan_tpu_torch.models.nima as nima_mod

    before = (na.norm_act.launches, na.norm_act_backward.launches)
    nima_mod.norm_act, saved = spy, nima_mod.norm_act
    try:
        model.train()
        model(x, generator=torch.Generator().manual_seed(1)).sum().backward()
        model.eval()
        stats = {k: v.clone() for k, v in model.state_dict().items() if "running" in k}
        with torch.no_grad():
            model(x)
    finally:
        nima_mod.norm_act = saved
    assert (na.norm_act.launches - before[0], na.norm_act_backward.launches - before[1]) \
        == (53, 53)
    assert seen == counts.bn_maps(32, 2)
    assert all(torch.equal(v, model.state_dict()[k]) for k, v in stats.items())


def test_loop_body_spans_and_counter():
    """``train_batch`` runs the upload, the step and the loss read under the
    spans ``nima.to_device``, ``nima.step`` (over ``nima.forward``,
    ``nima.backward`` and ``nima.optim`` twice) and ``nima.loss_read``, and
    returns the loss as a float; the step counts its calls in ``.steps``."""
    weights, images, targets = _seeded(7, 32, 2)
    model = NIMA().load_reference(weights)
    opt = torch.optim.Adam(model.parameters(), lr=3e-4, eps=1e-8)
    step = make_nima_train_step(model, opt, torch.Generator().manual_seed(2))
    spans.enable(True)
    try:
        t0 = spans.recorded()[-1].end_ns if spans.recorded() else 0
        losses = [train_batch(step, images, targets, torch.device("cpu")) for _ in range(2)]
    finally:
        spans.enable(False)
    assert step.steps == 2 and all(isinstance(v, float) and math.isfinite(v) for v in losses)
    rec = [s for s in spans.recorded(start_ns=t0) if s.name.startswith("nima.")]
    roots = [s.name for s in rec if s.parent is None]
    assert roots == ["nima.to_device", "nima.step", "nima.loss_read"] * 2
    by_id = {s.id: s for s in rec}
    kids = sorted(s.name for s in rec if s.parent is not None
                  and by_id[s.parent].name == "nima.step")
    assert kids == sorted(["nima.optim", "nima.forward", "nima.backward", "nima.optim"] * 2)


class StandInGraph:
    """``StepGraph`` on the CPU: the capture keeps the step, copies of its
    inputs and its generators, and each replay refills the inputs and runs
    the step on them."""

    supports = staticmethod(lambda device: True)
    made: list = []

    def __init__(self, step, images, targets, generators=()):
        self.step, self.generators = step, list(generators)
        self.images, self.targets = images.clone(), targets.clone()
        StandInGraph.made.append(self)

    def fits(self, images, targets):
        return images.shape == self.images.shape and targets.shape == self.targets.shape

    def replay(self, images, targets):
        self.images.copy_(images)
        self.targets.copy_(targets)
        return self.step(self.images, self.targets)


class Capturable:
    """A CPU Adam whose groups read as capturable, as a card's do."""

    def __init__(self, opt):
        self.opt = opt
        self.param_groups = [dict(g, capturable=True) for g in opt.param_groups]

    def zero_grad(self, set_to_none=True):
        self.opt.zero_grad(set_to_none=set_to_none)

    def step(self):
        self.opt.step()


def test_step_replays_after_one_eager_step(monkeypatch):
    """With a capturable optimizer the step runs eagerly once, captures its
    second call (the dropout generator registered) and replays from there
    on; it runs eagerly on another batch size, under a profiler that
    records host ops with their shapes and through ``.eager``, and never
    captures with a plain optimizer.  Each path gives the eager step's
    losses (a stand-in graph that runs the step at each replay)."""
    import uegan_tpu_torch.nima_train.train as train_mod
    from torch.profiler import ProfilerActivity, profile

    from uegan_tpu_torch.nima_train.train import make_nima_optimizer

    monkeypatch.setattr(train_mod, "StepGraph", StandInGraph)
    monkeypatch.setattr(StandInGraph, "made", [])
    weights, images, targets = _seeded(9, 32, 4)
    batches = [(torch.from_numpy(images), torch.from_numpy(targets))] * 5
    batches.insert(3, (batches[0][0][:2], batches[0][1][:2]))

    def run(capturable: bool):
        model = NIMA().load_reference(weights)
        opt = make_nima_optimizer(model, 3e-4)
        assert opt.defaults["capturable"] is False  # on the CPU
        gen = torch.Generator().manual_seed(4)
        step = make_nima_train_step(model, Capturable(opt) if capturable else opt, gen)
        losses = []
        spans.enable(True)
        try:
            t0 = spans.recorded()[-1].end_ns if spans.recorded() else 0
            for k, (x, t) in enumerate(batches):
                if k == 4:
                    with profile(activities=[ProfilerActivity.CPU], record_shapes=True):
                        losses.append(float(step(x, t)))
                else:
                    losses.append(float(step(x, t)))
            losses.append(float(step.eager(*batches[0])))
        finally:
            spans.enable(False)
        rec = [s for s in spans.recorded(start_ns=t0) if s.name.startswith("nima.")]
        roots = [s for s in rec if s.name == "nima.step"]
        kids = [[s.name for s in rec if s.parent == r.id and s.name != "nima.optim"]
                for r in roots]
        return losses, step, kids, gen

    want, plain, plain_kids = run(False)[:3]
    got, step, kids, gen = run(True)
    assert got == want
    assert (plain.steps, plain.captures, plain.replays) == (7, 0, 0)
    assert (step.steps, step.captures, step.replays) == (7, 1, 3)
    phases = ["nima.forward", "nima.backward"]
    assert plain_kids == [phases] * 7
    assert kids == [phases, ["nima.capture", "nima.replay"], ["nima.replay"], phases, phases,
                    ["nima.replay"], phases]
    assert [g.generators for g in StandInGraph.made] == [[gen]]


# ---------------------------------------------------------------------------
# on a card


@pytest.mark.card
def test_pair_on_the_card_at_nima_maps():
    """The kernel pair at NIMA's 53 maps at B=128, 224 px, in bfloat16 (and
    the first eight in float32), each with its BN's activation and flax's
    running statistics, against the plain form run in float64 on the same
    input, by ``chip_smoke.py``'s rules for the pair (``norm_check``): y, the
    running statistics and dx within one bf16 ulp of each value plus 1e-4 of
    the tensor's scale (float32: 1e-5 of each value plus 1e-4 of the
    scale), dx leaving out the elements whose float64 z lies within 1e-4 of
    0 or of the cap, where the derivative may fall either way, and dweight,
    dbias within 1e-5 of their magnitude plus what those elements may
    carry."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from portbench.counts import nima as counts
    from portbench.reference import nima_train as ref

    acts = [ACTS[c.act][0] for block in ref.blocks() for c in block.convs]
    gen = torch.Generator(device="cuda").manual_seed(5)
    for i, (shape, act) in enumerate(zip(counts.bn_maps(224, 128), acts)):
        for dtype in (torch.bfloat16,) + ((torch.float32,) if i < 8 else ()):
            _check_on_card(shape, dict(act), dtype, gen)
            torch.cuda.empty_cache()


def _close(got, want, dtype) -> bool:
    d = (got.double() - want).abs()
    scale = float(want.abs().max())
    if dtype == torch.float32:
        return bool((d <= 1e-4 * scale + 1e-5 * want.abs()).all())
    ulp = torch.exp2(torch.floor(torch.log2(want.abs().clamp_min(2.0 ** -126))) - 7)
    return bool((d <= ulp + 1e-4 * scale).all())


def _check_on_card(shape, act, dtype, gen):
    c = shape[1]
    slope, cap, strict = act["slope"], act.get("cap", math.inf), act.get("strict", False)
    x = (torch.randn(shape, generator=gen, device="cuda") * 1.5 + 0.3).to(dtype).contiguous(
        memory_format=torch.channels_last)
    w = 1 + 0.2 * torch.randn(c, generator=gen, device="cuda")
    b = 0.2 * torch.randn(c, generator=gen, device="cuda")
    rm = 0.1 * torch.randn(c, generator=gen, device="cuda")
    rv = 1 + torch.rand(c, generator=gen, device="cuda")
    dy = torch.randn(shape, generator=gen, device="cuda").to(dtype).contiguous(
        memory_format=torch.channels_last)
    got_rm, got_rv = rm.clone(), rv.clone()
    y, st = na._launch(x, w, b, got_rm, got_rv, False, slope, 0.1, 1e-5, cap=cap,
                       unbiased=False)
    dx, dw, db = na._launch_backward(dy, x, w, b, st, False, slope, 1e-5, cap, strict)
    x64, w64, b64, dy64 = x.double(), w.double(), b.double(), dy.double()
    rm64, rv64 = rm.double(), rv.double()
    y64, mean64, var64 = na.plain(x64, w64, b64, rm64, rv64, False, slope, 0.1, 1e-5, cap,
                                  False)
    dx64, dw64, db64 = na.plain_backward(dy64, x64, w64, b64, mean64, var64, False, slope,
                                         1e-5, cap, strict)
    torch.cuda.synchronize()
    tag = (shape, dtype, act)
    assert _close(y, y64, dtype) and _close(got_rm, rm64, torch.float32) \
        and _close(got_rv, rv64, torch.float32), tag
    xh = (x64 - mean64.view(1, -1, 1, 1)) * torch.rsqrt(var64.view(1, -1, 1, 1) + 1e-5)
    z = xh * w64.view(1, -1, 1, 1) + b64.view(1, -1, 1, 1)
    at0, atcap = z.abs() < 1e-4, (z - cap).abs() < 1e-4
    assert _close(torch.where(at0 | atcap, dx64.to(dx.dtype), dx), dx64, dtype), tag
    flip = dy64.abs() * (at0 * (1 - slope) + atcap)
    dims = (0, 2, 3)
    mag = (dy64.abs() * (xh.abs() + 1)).sum(dim=dims)
    for got, want, allow in ((dw, dw64, (flip * xh.abs()).sum(dim=dims)),
                             (db, db64, flip.sum(dim=dims))):
        assert bool(((got.double() - want).abs() <= 1e-5 * mag + allow + 1e-6).all()), tag
