"""PyTorch port against the JAX package on the same weights: the GAM, the
generator forward, and ``--mode test`` end to end.

Weights are N(0, 1/fan_in) from a numpy seed, carried to flax through
uegan_tpu.convert.torch_import.  No JAX model is initialized here: flax's
orthogonal init of a generator costs far more than these tests.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from uegan_tpu.convert.torch_import import import_generator
from uegan_tpu.data.pipeline import device_normalize, get_test_loader
from uegan_tpu.models.blocks import GAM as JaxGAM
from uegan_tpu.models.generator import Generator as JaxGenerator
from uegan_tpu.utils.image_io import device_quantize_u8
from uegan_tpu_torch.models.blocks import to_nchw, to_nhwc
from uegan_tpu_torch.models.generator import Generator
from uegan_tpu_torch.models.initializers import fan_in_normal_state
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
def jax_forward(weights):
    """Jitted JAX forward -> (output, tanh residual before the add and clip)."""
    model = JaxGenerator(conv_dim=CD)
    is_head = lambda mdl, method: mdl.name == "dec5_1"

    @jax.jit
    def fwd(params, x):
        out, state = model.apply({"params": params}, x, train=False, update_sn=False,
                                 capture_intermediates=is_head)
        return out, jnp.tanh(state["intermediates"]["dec5_1"]["__call__"][0])

    return lambda x: fwd(weights[1], x)


def test_gam_matches_jax(weights):
    _, params, g = weights
    x = np.random.default_rng(7).normal(0.0, 1.0, (2, 16, 16, 2 * CD)).astype(np.float32)
    want = JaxGAM(out_nc=2 * CD).apply({"params": params["ga2"]}, jnp.asarray(x))
    with torch.inference_mode():
        got = to_nhwc(g.ga2(to_nchw(torch.from_numpy(x))))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-5)


def test_generator_forward_matches_jax(weights, jax_forward):
    x = np.random.default_rng(8).uniform(-1, 1, (2, 32, 32, 3)).astype(np.float32)
    want_out, want_res = jax_forward(jnp.asarray(x))
    g = weights[2]
    with torch.inference_mode():
        res = g.residual(torch.from_numpy(x))
        out = g(torch.from_numpy(x))
    # the seeded weights keep the residual far from zero, so the output is
    # not just the input
    assert float(np.abs(np.asarray(want_res)).mean()) > 0.05
    np.testing.assert_allclose(res.numpy(), np.asarray(want_res), rtol=0, atol=3e-4)
    np.testing.assert_allclose(out.numpy(), np.asarray(want_out), rtol=0, atol=3e-4)


def test_generator_parameter_count():
    g = Generator(conv_dim=32, device="meta")
    assert sum(p.numel() for p in g.parameters()) == 4_158_435


def test_cli_test_mode_matches_jax(weights, jax_forward, tmp_path, monkeypatch):
    """``python -m uegan_tpu_torch --mode test --packed_inference false`` (the
    canonical forward) on the vendored fixture: its PNGs are within one gray
    level of the JAX forward + device quantize on the same batch, and its
    PSNR/SSIM CSVs agree with the JAX metrics run over the same PNGs."""
    from uegan_tpu.metrics.psnr import calc_psnr as jax_calc_psnr
    from uegan_tpu.metrics.ssim import calc_ssim as jax_calc_ssim
    from uegan_tpu_torch import cli

    sd = weights[0]
    models = tmp_path / "results" / "UEGAN-FiveK" / "models"
    models.mkdir(parents=True)
    ckpt = {"G_net": {k: torch.from_numpy(v) for k, v in sd.items()}, "D_net": {},
            "epoch": 92.0, "g_optimizer": {}, "d_optimizer": {},
            "lr_scheduler_g": {}, "lr_scheduler_d": {}}
    torch.save(ckpt, str(models / "UEGAN-FiveK_rahinge_92.pth"))
    label_dir = os.path.join(FIXTURE, "label") + os.sep
    monkeypatch.setenv("UEGAN_TORCH_DEVICE", "cpu")
    res = cli.run([
        "--mode", "test", "--test_img_dir", FIXTURE, "--test_label_dir", label_dir,
        "--save_root_dir", str(tmp_path / "results"), "--g_conv_dim", str(CD),
        # batch 3 > 2 images: the tail batch is padded and cropped back
        "--test_img_size", "32", "--val_batch_size", "3", "--pretrained_model", "92",
        "--compute_dtype", "float32", "--is_test_nima", "false",
        "--is_test_psnr_ssim", "true", "--num_workers", "1", "--packed_inference", "false",
    ])
    assert res["n_images"] == 2

    batch = next(iter(get_test_loader(FIXTURE, img_size=32, batch_size=2, num_workers=1,
                                      process_id=0, process_count=1, emit="uint8")))
    want = np.asarray(device_quantize_u8(jax_forward(device_normalize(jnp.asarray(batch["img_raw"])))[0]))
    out_dir = tmp_path / "results" / "UEGAN-FiveK" / "test" / "test_results"
    assert sorted(os.listdir(out_dir)) == [f"{n}_92.00_testFakeExp.png" for n in batch["img_name"]]
    for i, name in enumerate(batch["img_name"]):
        got = read_png_rgb(str(out_dir / f"{name}_92.00_testFakeExp.png")).astype(np.int16)
        assert np.abs(got - want[i].astype(np.int16)).max() <= 1, name

    csv = lambda p: (tmp_path / p).read_text().splitlines()
    jax_calc_psnr(str(out_dir), label_dir, str(tmp_path / "jax_psnr"), 92.0, verbose=False)
    assert csv("results/psnr_test_results/PSNR_epoch_92.0.csv") == csv("jax_psnr/PSNR_epoch_92.0.csv")
    jax_calc_ssim(str(out_dir), label_dir, str(tmp_path / "jax_ssim"), 92.0, verbose=False)
    for a, b in zip(csv("results/ssim_test_results/SSIM_epoch_92.0.csv"),
                    csv("jax_ssim/SSIM_epoch_92.0.csv"), strict=True):
        name_a, _, va = a.partition(",")
        name_b, _, vb = b.partition(",")
        assert name_a == name_b
        if name_a != "image_name":
            assert abs(float(va) - float(vb)) <= 2e-6, (a, b)
