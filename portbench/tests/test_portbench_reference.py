"""The benchmark's plain reference against the port's CPU path (cd 8, dd 8,
32 px, float32), within the tolerances the port's own tests hold it to
against JAX (tests/test_torch_generator.py, test_torch_train_step.py,
test_torch_sn.py): the G forward 3e-4; two train steps' losses rel 1e-4,
the parameters after each step 1e-5 but for at most 1e-4 of them where
Adam divides a nearly cancelling gradient; G's u and v 1e-5.  And neither
the reference nor the harness's entry loads JAX or the JAX package."""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from portbench.harness.weights import make_nets
from portbench.reference import nets
from portbench.reference.train import LOSS_NAMES, ReferenceTrainer

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
CD, HW, B, POOL = 8, 32, 2, 4
PORT_LOSSES = dict(zip(LOSS_NAMES, ("D/Total", "G/Total", "G/adv_loss", "G/percep_loss",
                                    "G/idt_loss")))


@pytest.fixture(autouse=True)
def few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("sn", [False, True])
def test_specs_are_the_ports_state_dicts(sn):
    from uegan_tpu_torch.models.discriminator import Discriminator
    from uegan_tpu_torch.models.generator import Generator
    from uegan_tpu_torch.models.vgg import VGG19Features

    for spec, model in ((nets.g_spec(32, sn), Generator(32, use_sn=sn)),
                        (nets.d_spec(32), Discriminator(32)), (nets.vgg_spec(), VGG19Features())):
        assert spec == {k: tuple(v.shape) for k, v in model.state_dict().items()}


@pytest.mark.parametrize("sn", [False, True])
def test_generator_forward(sn):
    from uegan_tpu_torch.models.generator import Generator

    w = make_nets({"G": nets.g_spec(CD, sn)}, 7, "cpu", fixed_uv=("G",))["G"]
    g = Generator(CD, use_sn=sn)
    g.load_state_dict(w)
    g.eval()
    x = torch.rand((B, HW, HW, 3), generator=torch.Generator().manual_seed(3)) * 2 - 1
    state = {k: v for k, v in w.items() if k.endswith(("weight_u", "weight_v"))}
    with torch.no_grad():
        got, want = g(x), nets.g_forward(w, state, x, nets.Numerics("f32"))
    assert float((got - want).abs().max()) <= 3e-4
    assert float((want - x).abs().mean()) > 0.05  # the weights move the output


def check_params(got: dict, want: dict, grads: dict, step: int) -> None:
    """After step 1 every parameter within 1e-5 where the step's gradient is
    not nearly cancelling; after step 2 each within 2 lr; at most 1e-4 of
    them over 1e-5 (tests/test_torch_train_step.py's rules)."""
    n_off = n_all = 0
    for k, w in want.items():
        d = (got[k] - w).abs()
        if step == 1:
            far = float(torch.where(grads[k].abs() < 1e-6, 0.0, d).max())
            assert far <= 1e-5, (step, k, far)
        else:
            assert float(d.max()) <= 2 * (4e-4 if k.startswith("D:") else 1e-4), (step, k)
        n_off += int((d > 1e-5).sum())
        n_all += d.numel()
    assert n_off <= 1e-4 * n_all, (step, n_off, n_all)


@pytest.mark.parametrize("sn", [False, True])
def test_two_train_steps(sn):
    from uegan_tpu_torch.config import Config
    from uegan_tpu_torch.train.state import create_train_state
    from uegan_tpu_torch.train.step import make_train_step

    seed = 2 ** 31 + 17
    w = make_nets({"G": nets.g_spec(CD, sn), "D": nets.d_spec(CD), "VGG": nets.vgg_spec()},
                  seed, "cpu", fixed_uv=("G",))
    cfg = Config(mode="train", g_conv_dim=CD, d_conv_dim=CD, image_size=2 * HW, resize_size=HW,
                 train_batch_size=B, pool_size=POOL, compute_dtype="float32", g_use_sn=sn,
                 seed=seed, is_print_network=False).validate()
    state = create_train_state(cfg, "cpu", (HW, HW), 1000)
    for net, key in ((state.g, "G"), (state.d, "D"), (state.vgg, "VGG")):
        net.load_state_dict(w[key])
    step = make_train_step(state)
    ref = ReferenceTrainer(w["G"], w["D"], w["VGG"], (HW, HW), POOL, seed + 1)
    gen = torch.Generator().manual_seed(5)
    for k in range(2):
        raw = torch.rand((B, HW, HW, 3), generator=gen) * 2 - 1
        exp = torch.rand((B, HW, HW, 3), generator=gen) * 2 - 1
        got = {n: float(v) for n, v in step(raw, exp)[0].items()}
        want = ref.step(raw, exp)
        for n in LOSS_NAMES:
            assert got[PORT_LOSSES[n]] == pytest.approx(float(want[n]), rel=1e-4), (n, k)
        port = {f"G:{n}": p.detach() for n, p in state.g.named_parameters()}
        port.update({f"D:{n}": p.detach() for n, p in state.d.named_parameters()})
        check_params(port, ref.leaves(), ref.last_grads(), k + 1)
        if sn:
            for n, v in ref.g_uv().items():
                assert float((state.g.state_dict()[n] - v).abs().max()) <= 1e-5, (n, k)


def loaded_tops(code: str) -> set:
    out = subprocess.run([sys.executable, "-c", code + "\nimport sys\n"
                          "print(sorted({m.split('.')[0] for m in sys.modules}))"],
                         cwd=REPO, capture_output=True, text=True, check=True,
                         env=dict(os.environ, PYTHONPATH=REPO))
    return set(eval(out.stdout.strip().splitlines()[-1]))


def test_no_jax_loaded():
    tops = loaded_tops("import portbench.reference.nets, portbench.reference.train\n"
                       "import portbench.run, portbench.readings\n"
                       "from portbench.harness import core\n"
                       "for n in ('enhance', 'train'): core.driver(n)\n"
                       "import uegan_tpu_torch.train.tester, uegan_tpu_torch.train.step")
    assert not tops & {"jax", "jaxlib", "flax", "uegan_tpu"}, tops
    assert "uegan_tpu_torch" in tops  # the whole name is compared, not its prefix


def test_reference_imports_nothing_of_the_program():
    tops = loaded_tops("import portbench.reference.nets, portbench.reference.train")
    assert not tops & {"uegan_tpu_torch", "uegan_tpu", "jax"}, tops


@pytest.mark.card
def test_reference_on_the_card_matches_the_cpu():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    w = make_nets({"G": nets.g_spec(32, False)}, 11, "cpu")["G"]
    x = (torch.rand((2, 64, 64, 3), generator=torch.Generator().manual_seed(1)) * 255).to(
        torch.uint8)
    cpu = nets.enhance_u8(w, x)
    card = nets.enhance_u8({k: v.cuda() for k, v in w.items()}, x.cuda()).cpu()
    assert int((cpu.int() - card.int()).abs().max()) <= 1
    assert np.mean(cpu.numpy() != card.numpy()) < 1e-3
