"""Each cell's run with its timed path broken underneath comes out not
correct: the harness's look for a card skipped, the rest of a run driven on
the CPU at a tiny size, once sound (correct) and once for each fault the
cell can have: an answer altered where it is produced, half of the batch
left out, and for training a step that leaves its state unchanged, or,
under spectral norm in G, one that leaves G's u and v where they were.  The
cells run on one card, so no exchange between cards can be left out.  The
limits are the cells' own (``portbench/limits``).  The train cells run the
program in float32 here, so that the sound run stays inside limits set for
bfloat16 at full size."""

import numpy as np
import pytest
import torch

from portbench.tests.test_portbench_harness import TINY_ENHANCE, tiny_run

TINY_TRAIN = dict(batch=4, image_hw=32, pairs=16, pool_size=4, trace_start_s=0.1,
                  trace_seconds=0.2)


@pytest.fixture(autouse=True)
def few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def correct(workload, traffic_kw, config_kw, seconds=0.6):
    import json

    rc, line, _ = tiny_run(workload, False, traffic_kw, config_kw, seconds=seconds)
    assert rc == 0
    return json.loads(line)["correct"]


def alter_one_image(out: np.ndarray) -> np.ndarray:
    out = out.copy()
    out[0] = 255 - out[0]
    return out


def drop_half(out: np.ndarray) -> np.ndarray:
    """Half of the rows left out: the other half's results stand in for them."""
    out = out.copy()
    half = out.shape[0] // 2
    out[half:2 * half] = out[:half]
    return out


@pytest.mark.parametrize("fault", [None, alter_one_image, drop_half])
def test_enhance(monkeypatch, fault):
    from uegan_tpu_torch.train.tester import Tester

    if fault is not None:
        real = Tester.enhance_u8
        monkeypatch.setattr(Tester, "enhance_u8", lambda self, b: fault(real(self, b)))
    assert correct("g32_enhance512_b16", TINY_ENHANCE, {"g_conv_dim": 8}) is (fault is None)


@pytest.mark.parametrize("fault", [None, "unchanged", "half_batch"])
@pytest.mark.parametrize("workload", ["g32_train256", "g32sn_train256"])
def test_train(monkeypatch, workload, fault):
    import uegan_tpu_torch.train.step as step_mod

    if fault == "unchanged":  # the optimizers take no step
        monkeypatch.setattr(torch.optim.Adam, "step", lambda self, closure=None: None)
    elif fault == "half_batch":  # the step sees only the first half of its rows
        real = step_mod.make_train_step

        def make(state):
            step = real(state)
            return lambda raw, exp: step(raw[:raw.shape[0] // 2], exp[:exp.shape[0] // 2])
        monkeypatch.setattr(step_mod, "make_train_step", make)
    ok = correct(workload, TINY_TRAIN, {"g_conv_dim": 8, "d_conv_dim": 8,
                                        "compute_dtype": "float32"})
    assert ok is (fault is None)


def test_sn_vectors_left_in_place(monkeypatch):
    """G's power iterations skipped (D's run): G's u and v stay where they were."""
    import uegan_tpu_torch.train.step as step_mod
    from uegan_tpu_torch.models.blocks import SpectralConv2d

    real = step_mod.make_train_step

    def make(state):
        for m in state.g.modules():
            if isinstance(m, SpectralConv2d) and m.use_sn:
                m.forward = (lambda x, dtype, update_sn=True, sn_branches=1, fwd=m.forward:
                             fwd(x, dtype, False, sn_branches))
        return real(state)
    monkeypatch.setattr(step_mod, "make_train_step", make)
    assert correct("g32sn_train256", TINY_TRAIN, {"g_conv_dim": 8, "d_conv_dim": 8,
                                                  "compute_dtype": "float32"}) is False
