"""PyTorch port: when the train step replays its CUDA graph, on the CPU.

The graph itself runs only on a card (``chip_smoke.py`` phase 6d holds it
bit-equal to the eager step there).  Here a stand-in for it, which runs the
step eagerly at each replay, takes its place, so that the decision the step
makes (eager while the pool fills, on another input shape and under a
profiler that records host ops with their shapes; the graph dropped when the
state's optimizer state is replaced), its counters and its spans show on
the CPU.  Also the optimizers as the CPU builds them, and a checkpoint of a
capturable optimizer's state."""

import time

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from uegan_tpu_torch.config import Config
from uegan_tpu_torch.train import step as step_mod
from uegan_tpu_torch.train.schedules import load_optimizer_state, make_optimizer, optimizer_state
from uegan_tpu_torch.train.state import create_train_state, load_checkpoint, save_checkpoint
from uegan_tpu_torch.utils import spans
from uegan_tpu_torch.utils.checkpoint import load_pth

FLAGS = dict(g_conv_dim=8, d_conv_dim=8, image_size=48, resize_size=32, train_batch_size=2,
             pool_size=2, compute_dtype="float32", packed_train=False, g_ema_decay=0.999)


@pytest.fixture(autouse=True)
def one_thread():
    was, n = spans.enabled(), torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    spans.enable(was)
    torch.set_num_threads(n)


class StandInGraph:
    """``step.StepGraph`` on the CPU: the capture keeps the step and copies of
    its inputs, and each replay refills them and runs the step on them."""

    supports = staticmethod(lambda device: True)
    fits = step_mod.StepGraph.fits

    def __init__(self, step, raw, exp, generators=()):
        self.step, self.raw, self.exp = step, raw.clone(), exp.clone()

    def replay(self, raw, exp):
        self.raw.copy_(raw)
        self.exp.copy_(exp)
        return self.step(self.raw, self.exp)


def _children(records):
    """Each train.step's direct children's names, in order."""
    roots = [s for s in records if s.name == "train.step"]
    return [[s.name for s in records if s.parent == r.id] for r in roots]


def test_replays_once_the_pool_is_full_and_eager_otherwise(monkeypatch):
    assert not step_mod.StepGraph.supports(torch.device("cpu"))
    monkeypatch.setattr(step_mod, "StepGraph", StandInGraph)
    state = create_train_state(Config(**FLAGS), "cpu", (32, 32), 2)
    fn = step_mod.make_train_step(state)
    gen = torch.Generator().manual_seed(3)
    batches = [tuple(torch.rand((2, 32, 32, 3), generator=gen) * 2 - 1 for _ in range(2))
               for _ in range(6)]
    spans.enable()
    t0 = time.time_ns()
    fn(*batches[0])  # the pool of 2 fills
    fn(*batches[1])  # captured, then replayed
    metrics, images = fn(*batches[2])
    assert images["fake_exp"].shape == (2, 32, 32, 3) and metrics["G/Total"].ndim == 0
    fn(*(t[:1] for t in batches[3]))  # another batch size
    with profile(activities=[ProfilerActivity.CPU], record_shapes=True):
        assert step_mod.host_ops_recorded()
        fn(*batches[4])
    with profile(activities=[ProfilerActivity.CPU]):  # host ops without their shapes
        assert not step_mod.host_ops_recorded()
    assert not step_mod.host_ops_recorded()
    # a resume replaces D's optimizer state: the graph is dropped and taken again
    load_optimizer_state(state.d_opt, optimizer_state(state.d_opt))
    fn(*batches[5])
    spans.enable(False)
    assert (fn.captures, fn.replays, fn.eager_steps, state.step) == (2, 3, 3, 6)
    phases = _children(spans.recorded(t0, time.time_ns()))
    eager = phases[0]
    assert eager[:3] == ["train.g_forward", "train.pool", "train.d_update"]
    assert phases == [eager, ["train.capture", "train.replay"], ["train.replay"], eager, eager,
                      ["train.capture", "train.replay"]]


def test_cpu_optimizers_are_plain_adams():
    params = [torch.nn.Parameter(torch.randn(3, 2)), torch.nn.Parameter(torch.randn(4))]
    opt = make_optimizer(iter(params), "adam", 2e-4, 0.5, 0.999, 1e-4)
    plain = torch.optim.Adam(params, lr=2e-4, betas=(0.5, 0.999), eps=1e-8, weight_decay=1e-4)
    assert opt.defaults == plain.defaults
    assert opt.defaults["capturable"] is False and opt.param_groups[0]["lr"] == 2e-4


def test_checkpoint_round_trips_a_capturable_optimizers_state(tmp_path):
    """A capturable Adam (as a card builds it) writes what a plain one writes,
    and a resume restores its moments and step counts and keeps it
    capturable, with its own learning-rate tensor; a plain Adam reads the
    same file."""
    state = create_train_state(Config(**FLAGS), "cpu", (32, 32), 2)
    gen = torch.Generator().manual_seed(4)

    def capturable(model):
        return torch.optim.Adam(model.parameters(), lr=torch.tensor(1e-4), betas=(0.5, 0.999),
                                eps=1e-8, weight_decay=1e-4, capturable=True)

    state.g_opt, state.d_opt = capturable(state.g), capturable(state.d)
    for opt in (state.g_opt, state.d_opt):  # moments as a step would leave them
        for p in opt.param_groups[0]["params"]:
            opt.state[p] = {"step": torch.tensor(3.0),
                            "exp_avg": torch.randn(p.shape, generator=gen),
                            "exp_avg_sq": torch.rand(p.shape, generator=gen)}
    saved = [(opt, {p: dict(opt.state[p]) for p in opt.param_groups[0]["params"]})
             for opt in (state.g_opt, state.d_opt)]
    ckpt = load_pth(save_checkpoint(state, str(tmp_path / "x.pth"), 1))
    for key in ("g_optimizer", "d_optimizer"):
        group, = ckpt[key]["param_groups"]
        assert group["lr"] == pytest.approx(1e-4) and group["capturable"] is False
    state.g_opt, state.d_opt = capturable(state.g), capturable(state.d)  # a fresh run's
    own_lr = state.g_opt.param_groups[0]["lr"]
    load_checkpoint(state, ckpt)
    assert state.g_opt.param_groups[0]["lr"] is own_lr
    for got, (_, want) in zip((state.g_opt, state.d_opt), saved):
        assert got.param_groups[0]["capturable"] is True
        for p in got.param_groups[0]["params"]:
            for k, v in want[p].items():
                assert torch.equal(got.state[p][k], v), k
            assert got.state[p]["step"].dtype == torch.float32
    plain = make_optimizer(state.g.parameters(), "adam", 1e-4)  # the CPU's own Adam
    load_optimizer_state(plain, ckpt["g_optimizer"])
    assert plain.param_groups[0]["capturable"] is False
    assert plain.param_groups[0]["lr"] == pytest.approx(1e-4)
