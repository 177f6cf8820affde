"""PyTorch port: native-resolution inference (``--test_keep_aspect``) and
overlap tiles (``--tile_size``): the pad/crop helpers and the shape-bucketing
test loader against the JAX package's, the host tile stitch against JAX's,
the port's device stitch against its host stitch, and the ``--mode test``
CLI at native size (through the strips) and in tiles.

No JAX program is compiled here: the helpers are numpy on both sides.  cd 8,
f32, CPU, one torch thread.
"""

import os

import numpy as np
import pytest
import torch
from PIL import Image

from uegan_tpu.data.pipeline import get_test_loader as jax_get_test_loader
from uegan_tpu.infer import native as jnative
from uegan_tpu.infer import tiles as jtiles
from uegan_tpu_torch.config import Config
from uegan_tpu_torch.data.pipeline import _Loader, get_test_loader
from uegan_tpu_torch.infer import native, packed, tiles
from uegan_tpu_torch.models.generator import Generator
from uegan_tpu_torch.models.initializers import fan_in_normal_state
from uegan_tpu_torch.utils.image_io import normalize_u8, quantize_u8, read_png_rgb, to_uint8

CD = 8


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One torch thread while this file runs (the suite runs several workers
    on a few cores), restored after it so other files keep their setting."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _write_folder(root, sizes):
    """A FiveK-layout test folder, label/ and raw/ of the given (h, w) sizes."""
    rng = np.random.default_rng(7)
    for d in ("label", "raw"):
        os.makedirs(os.path.join(root, d), exist_ok=True)
        for i, (h, w) in enumerate(sizes):
            arr = rng.integers(0, 255, (h, w, 3), dtype=np.uint8)
            Image.fromarray(arr).save(os.path.join(root, d, f"img{i:02d}.png"))


# ---------------------------------------------------------------------------
# pad / crop and the loader, against JAX's
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("shape,bucket", [((2, 70, 41, 3), 64), ((1, 5, 3, 3), 64),
                                          ((3, 50, 90, 3), 64), ((1, 64, 128, 3), 64),
                                          ((1, 17, 33, 3), 10)])
def test_native_helpers_match_jax(shape, bucket):
    """round_up, pad_to_grid (a 5x3 input needs chained reflect pads),
    crop_back and enhance_native equal JAX's on the same arrays."""
    x = np.random.default_rng(1).integers(0, 255, shape, dtype=np.uint8)
    for n in (1, shape[1], shape[2], 65, 500):
        assert native.round_up(n, bucket) == jnative.round_up(n, bucket)
    got, hw = native.pad_to_grid(x, bucket)
    want, jhw = jnative.pad_to_grid(x, bucket)
    assert hw == jhw == shape[1:3]
    assert got.shape[1] % 16 == 0 and got.shape[2] % 16 == 0
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(native.crop_back(got, hw), x)
    fn = lambda b: 255 - b
    np.testing.assert_array_equal(native.enhance_native(fn, x, bucket),
                                  jnative.enhance_native(fn, x, bucket))


@pytest.mark.parametrize("emit", ["uint8", "float32"])
def test_keep_native_loader_matches_jax(tmp_path, emit):
    """The keep_native test loader's batches equal the JAX loader's on a
    mixed-size folder: names, order, shapes and bytes."""
    _write_folder(str(tmp_path), [(48, 80), (48, 80), (64, 48), (48, 80), (64, 48), (32, 32)])
    got = list(get_test_loader(str(tmp_path), batch_size=2, num_workers=2, emit=emit,
                               keep_native=True))
    want = list(jax_get_test_loader(str(tmp_path), batch_size=2, num_workers=2, emit=emit,
                                    keep_native=True, process_id=0, process_count=1))
    assert [b["img_name"] for b in got] == [b["img_name"] for b in want]
    assert [b["img_raw"].shape for b in got] == [(2, 48, 80, 3), (1, 48, 80, 3),
                                                 (2, 64, 48, 3), (1, 32, 32, 3)]
    for a, b in zip(got, want):
        for k in ("img_raw", "img_exp"):
            assert a[k].dtype == b[k].dtype
            np.testing.assert_array_equal(a[k], b[k])
    with pytest.raises(ValueError, match="test/val"):
        _Loader(None, batch_size=2, train=True, keep_native=True)


# ---------------------------------------------------------------------------
# overlap tiles
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("hw,tile,overlap", [((100, 70), 64, 8), ((200, 300), 64, 8),
                                             ((20, 30), 64, 8), ((96, 160), 32, 0)])
def test_tiles_match_jax_and_device_stitch(hw, tile, overlap):
    """enhance_tiled equals JAX's for a numpy enhancer (tile batches of 8,
    the tail padded; images smaller than a tile reflect-padded), and the
    device stitch equals the host stitch."""
    img = np.random.default_rng(2).uniform(-1, 1, hw + (3,)).astype(np.float32)
    calls = []

    def fn(b):
        calls.append(b.shape[0])
        return np.tanh(b * 1.5) * 0.9

    got = tiles.enhance_tiled(fn, img, tile, overlap)
    n_port = list(calls)
    want = jtiles.enhance_tiled(fn, img, tile, overlap)
    assert got.shape == img.shape and n_port == calls[len(n_port):]
    np.testing.assert_array_equal(got, want)
    dev = tiles.make_device_tiled_enhancer(lambda t: torch.tanh(t * 1.5) * 0.9, hw, tile,
                                           overlap)(torch.from_numpy(img))
    np.testing.assert_allclose(dev.numpy(), got, rtol=0, atol=1e-6)


# ---------------------------------------------------------------------------
# the CLI
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def native_run(tmp_path_factory):
    """A mixed-size test folder (40x56 twice, 72x48) and a .pth of seeded
    cd-8 weights: (folder, save root, Generator)."""
    root = tmp_path_factory.mktemp("native")
    data = root / "test"
    _write_folder(str(data), [(40, 56), (40, 56), (72, 48)])
    g = Generator(conv_dim=CD)
    sd = fan_in_normal_state(g, seed=1990)
    g.load_state_dict({k: torch.from_numpy(v) for k, v in sd.items()})
    models = root / "results" / "UEGAN-FiveK" / "models"
    models.mkdir(parents=True)
    torch.save({"G_net": {k: torch.from_numpy(v) for k, v in sd.items()}},
               str(models / "UEGAN-FiveK_rahinge_92.pth"))
    return data, root / "results", g.eval()


def _cli(data, save, extra, monkeypatch):
    from uegan_tpu_torch import cli

    monkeypatch.setenv("UEGAN_TORCH_DEVICE", "cpu")
    res = cli.run(["--mode", "test", "--test_img_dir", str(data),
                   "--test_label_dir", str(data / "label") + os.sep, "--save_root_dir", str(save),
                   "--g_conv_dim", str(CD), "--test_img_size", "32", "--val_batch_size", "2",
                   "--pretrained_model", "92", "--compute_dtype", "float32",
                   "--is_test_nima", "false", "--is_test_psnr_ssim", "true",
                   "--num_workers", "1", "--test_keep_aspect", "true"] + extra)
    out_dir = save / "UEGAN-FiveK" / "test" / "test_results"
    return res, {f.split("_")[0]: read_png_rgb(str(out_dir / f)) for f in os.listdir(out_dir)}


def test_cli_native_resolution_through_the_strips(native_run, monkeypatch):
    """``--mode test --test_keep_aspect true --strip_rows 16``: PNGs at
    their native sizes (not the 32x32 squash), bit-equal to the port's own
    enhance_native over make_fast_eval (each batch padded to val_batch_size
    and quantized on the device, as the Tester runs it); both buckets (64 x
    64 and 128 x 64) go through the strips."""
    data, save, g = native_run
    res, pngs = _cli(data, save, ["--strip_rows", "16"], monkeypatch)
    assert res["n_images"] == 3 and np.isfinite(res["psnr"])
    assert {k: v.shape for k, v in pngs.items()} == {"img00": (40, 56, 3), "img01": (40, 56, 3),
                                                     "img02": (72, 48, 3)}
    fast = packed.make_fast_eval(g, Config(strip_rows=16, compute_dtype="float32"))

    def enhance_u8(b):
        x = np.concatenate([b, np.zeros((2 - len(b),) + b.shape[1:], b.dtype)])
        return quantize_u8(fast(normalize_u8(torch.from_numpy(x)))).numpy()[:len(b)]

    for names in (["img00", "img01"], ["img02"]):
        raw = np.stack([read_png_rgb(str(data / "raw" / f"{n}.png")) for n in names])
        want = native.enhance_native(enhance_u8, raw)
        for n, w in zip(names, want):
            np.testing.assert_array_equal(pngs[n], w)


def test_cli_tiles(native_run, monkeypatch):
    """``--tile_size 32 --tile_overlap 4`` (with ``--test_keep_aspect``):
    each PNG is the host tiling over the canonical eval step, quantized on
    the host, as the JAX Tester's tile route."""
    data, save, g = native_run
    res, pngs = _cli(data, save, ["--tile_size", "32", "--tile_overlap", "4"], monkeypatch)
    assert res["n_images"] == 3
    step = packed.make_eval_step(g)
    fn = lambda b: step(torch.from_numpy(np.ascontiguousarray(b))).float().numpy()
    for n in ("img00", "img02"):
        raw = read_png_rgb(str(data / "raw" / f"{n}.png"))
        padded, hw = native.pad_to_grid(raw[None])
        img = (padded[0].astype(np.float32) / 255.0 - 0.5) / 0.5
        want = to_uint8(np.clip((tiles.enhance_tiled(fn, img, 32, 4) + 1.0) / 2.0, 0.0, 1.0))
        np.testing.assert_array_equal(pngs[n], native.crop_back(want[None], hw)[0])
