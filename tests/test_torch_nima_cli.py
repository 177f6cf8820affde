"""PyTorch port, NIMA behind the CLIs: ``calc_nima`` and the standalone
scorer ``metrics/nima_cli.py`` against the JAX package's on one PNG folder
with one reference ``.pth`` in f32; ``python -m uegan_tpu_torch --mode
test`` with ``--is_test_nima true`` (the JAX default) against JAX's
``calc_nima`` on the port's own output folder; and ``--mode train`` for one
epoch with NIMA and the on-device PSNR/SSIM on, against JAX's
``psnr_batch`` and ``ssim_batch`` on the same arrays.
"""

import csv
import os

import numpy as np
import pytest
import torch
from PIL import Image

from uegan_tpu.metrics import nima_cli as jax_nima_cli
from uegan_tpu.metrics.nima import calc_nima as jax_calc_nima
from uegan_tpu.metrics.psnr import psnr_batch as jax_psnr_batch
from uegan_tpu.metrics.ssim import ssim_batch as jax_ssim_batch
from uegan_tpu_torch.metrics import nima_cli
from uegan_tpu_torch.metrics.nima import calc_nima, init_nima
from uegan_tpu_torch.models.generator import Generator
from uegan_tpu_torch.models.initializers import fan_in_normal_state
from uegan_tpu_torch.models.nima import save_nima_pth

from tests.test_torch_nima import nima_weights

FIXTURE = os.path.join(os.path.dirname(os.path.abspath(__file__)), "fixtures", "verify_fivek")


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One torch thread while this file runs (the suite runs several workers
    on a few cores), restored after it so other files keep their setting."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def nima_pth(tmp_path_factory):
    return save_nima_pth(nima_weights(seed=3), str(tmp_path_factory.mktemp("nima") / "nima.pth"))


@pytest.fixture(scope="module")
def png_dir(tmp_path_factory):
    """Five PNGs of other sizes and aspects (portrait, landscape, small,
    gray), made with numpy."""
    d = tmp_path_factory.mktemp("pngs")
    rng = np.random.default_rng(8)
    for i, (h, w) in enumerate([(40, 60), (300, 200), (256, 256), (90, 33), (64, 64)]):
        img = (rng.random((h, w, 3)) * 255).astype(np.uint8)
        Image.fromarray(img if i != 4 else img[:, :, 0]).save(d / f"im{i}.png")
    return str(d)


def _rows(path: str):
    with open(path) as f:
        return list(csv.reader(f))


def assert_csvs_close(got: str, want: str, atol: float = 1e-4) -> None:
    """Same rows and first column; every number within ``atol``."""
    a, b = _rows(got), _rows(want)
    assert len(a) == len(b) and [r[0] for r in a] == [r[0] for r in b], (a, b)
    for ra, rb in zip(a, b):
        assert len(ra) == len(rb)
        for x, y in zip(ra[1:], rb[1:]):
            try:
                fx, fy = float(x), float(y)
            except ValueError:
                assert x == y
                continue
            assert abs(fx - fy) <= atol, (ra, rb)


def test_calc_nima_matches_jax(png_dir, nima_pth, tmp_path):
    """The same images in the same order, every CSV value within 1e-4, and
    the Average and total lines, with the average over N and (legacy) N-1;
    the port scores its last chunk unpadded (batch 2 over 5 images)."""
    for epoch, legacy in ((1, False), (2, True)):
        avg = calc_nima(png_dir, str(tmp_path / "port"), epoch, weights_path=nima_pth,
                        batch_size=2, legacy_average=legacy, verbose=False,
                        model=init_nima(nima_pth, device="cpu"))
        javg = jax_calc_nima(png_dir, str(tmp_path / "jax"), epoch, weights_path=nima_pth,
                             batch_size=2, legacy_average=legacy, verbose=False)
        assert abs(avg - javg) <= 1e-4
        name = f"NIMA_epoch_{epoch}__mean_std.csv"
        assert_csvs_close(str(tmp_path / "port" / name), str(tmp_path / "jax" / name))
    rows = _rows(str(tmp_path / "port" / "NIMA_epoch_1__mean_std.csv"))
    assert [r[0] for r in rows] == ["image_name"] + [f"im{i}.png" for i in range(5)] + ["Average"]
    total = "NIMA_total_results_epoch_mean_std.csv"
    assert_csvs_close(str(tmp_path / "port" / total), str(tmp_path / "jax" / total))
    assert [r[0] for r in _rows(str(tmp_path / "port" / total))] == ["1", "2"]


def test_nima_cli_csv_matches_jax(png_dir, nima_pth, tmp_path, monkeypatch):
    """``python -m uegan_tpu_torch.metrics.nima_cli`` writes JAX's CSV (names,
    order, values within 1e-4), on the CPU when UEGAN_TORCH_DEVICE asks."""
    monkeypatch.setenv("UEGAN_TORCH_DEVICE", "cpu")
    got, want = str(tmp_path / "port.csv"), str(tmp_path / "jax.csv")
    nima_cli.main(["--test_images", png_dir, "--model", nima_pth, "--out", got, "--batch", "4"])
    jax_nima_cli.main(["--test_images", png_dir, "--model", nima_pth, "--out", want,
                       "--batch", "4"])
    assert_csvs_close(got, want)
    assert len(_rows(got)) == 6


def _g_checkpoint(root) -> None:
    g = Generator(conv_dim=8)
    sd = {k: torch.from_numpy(v) for k, v in fan_in_normal_state(g, seed=1990).items()}
    models = root / "UEGAN-FiveK" / "models"
    models.mkdir(parents=True)
    torch.save({"G_net": sd}, str(models / "UEGAN-FiveK_rahinge_92.pth"))


def test_mode_test_with_nima_matches_jax_calc_nima(nima_pth, tmp_path, monkeypatch, capsys):
    """``--mode test`` with ``--is_test_nima true --nima_weights`` in f32:
    the port's NIMA CSVs equal JAX's calc_nima run on the port's own output
    folder (the two packages' PNGs differ by up to 1 u8), within 1e-4."""
    from uegan_tpu_torch import cli

    monkeypatch.setenv("UEGAN_TORCH_DEVICE", "cpu")
    root = tmp_path / "results"
    _g_checkpoint(root)
    test_dir = os.path.join(FIXTURE, "test")
    res = cli.run(["--mode", "test", "--test_img_dir", test_dir,
                   "--test_label_dir", os.path.join(test_dir, "label") + os.sep,
                   "--save_root_dir", str(root), "--g_conv_dim", "8", "--test_img_size", "32",
                   "--val_batch_size", "2", "--pretrained_model", "92",
                   "--compute_dtype", "float32", "--is_test_nima", "true",
                   "--nima_weights", nima_pth, "--nima_dtype", "float32", "--num_workers", "1"])
    assert res["n_images"] == 2 and "Avg. NIMA" in capsys.readouterr().out
    out_dir = str(root / "UEGAN-FiveK" / "test" / "test_results")
    javg = jax_calc_nima(out_dir, str(tmp_path / "jax"), 92.0, weights_path=nima_pth,
                         verbose=False)
    assert abs(res["nima"] - javg) <= 1e-4
    for name in ("NIMA_epoch_92.0__mean_std.csv", "NIMA_total_results_epoch_mean_std.csv"):
        assert_csvs_close(str(root / "nima_test_results" / name), str(tmp_path / "jax" / name))


def test_mode_train_with_nima_and_on_device_metrics(tmp_path, monkeypatch, capsys):
    """``--mode train`` one epoch on the JAX defaults for NIMA (on, bf16,
    seeded) and on-device metrics (on): nima_val_results/ with the best-epoch
    line, and the on-device PSNR and SSIM line, whose values equal JAX's
    psnr_batch and ssim_batch on the same arrays (1e-4 dB, 2e-6)."""
    import uegan_tpu_torch.train.trainer as trainer_mod
    from uegan_tpu_torch import cli

    seen = []

    def record(name, fn):
        def wrapped(pred, target, **kw):
            out = fn(pred, target, **kw)
            seen.append((name, pred.numpy().copy(), target.numpy().copy(), kw, out.numpy()))
            return out
        return wrapped

    monkeypatch.setattr(trainer_mod, "psnr_batch", record("psnr", trainer_mod.psnr_batch))
    monkeypatch.setattr(trainer_mod, "ssim_batch", record("ssim", trainer_mod.ssim_batch))
    monkeypatch.setenv("UEGAN_TORCH_DEVICE", "cpu")
    root = str(tmp_path / "results")
    res = cli.run(["--mode", "train", "--train_img_dir", os.path.join(FIXTURE, "train"),
                   "--val_img_dir", os.path.join(FIXTURE, "val"),
                   "--val_label_dir", os.path.join(FIXTURE, "val", "label") + os.sep,
                   "--save_root_dir", root, "--g_conv_dim", "8", "--d_conv_dim", "8",
                   "--image_size", "48", "--resize_size", "32", "--test_img_size", "32",
                   "--train_batch_size", "2", "--val_batch_size", "2", "--total_epochs", "1",
                   "--num_epochs_start_val", "0", "--val_each_epochs", "1", "--pool_size", "4",
                   "--info_step", "1", "--sample_step", "2", "--compute_dtype", "float32",
                   "--num_workers", "1"])
    out = capsys.readouterr().out
    assert res["steps"] == 2
    assert [s[0] for s in seen] == ["psnr", "ssim"]
    for name, pred, target, kw, got in seen:
        assert kw == {"crop_border": 4} and pred.shape == target.shape == (2, 32, 32, 3)
        assert pred.dtype == target.dtype == np.float32 and 0 <= pred.min() <= pred.max() <= 255
        jfn = jax_psnr_batch if name == "psnr" else jax_ssim_batch
        want = np.asarray(jfn(pred, target, crop_border=4))
        # SSIM: 2e-6, tests/test_torch_generator.py's bound for the SSIM CSVs;
        # on these arrays JAX's f32 SSIM is 1.2e-6 from a float64 one
        np.testing.assert_allclose(got, want, atol=1e-4 if name == "psnr" else 2e-6, rtol=0)
    line = (f"====== On-device Avg. PSNR: {np.mean(seen[0][4]):>.4f} dB, "
            f"SSIM: {np.mean(seen[1][4]):>.4f} ======")
    assert line in out and "Avg. NIMA" in out
    nima_dir = os.path.join(root, "nima_val_results")
    assert sorted(os.listdir(nima_dir)) == ["NIMA_epoch_1.0__mean_std.csv",
                                             "NIMA_total_results_epoch_mean_std.csv"]
    total = _rows(os.path.join(nima_dir, "NIMA_total_results_epoch_mean_std.csv"))
    assert total[0][0] == "1.0" and total[-1][0] == "Best epoch:1.0"
    assert total[-1][1] == total[0][1]
