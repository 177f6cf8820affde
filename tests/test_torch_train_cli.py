"""PyTorch port, train slice: ``python -m uegan_tpu_torch --mode train`` on
the vendored fixture with the verify flags (cd 8, 32 px, batch 2, 2
epochs) on the CPU, with and without train-mode norm layers (instance norm
in G, batch norm in D), a resume from its checkpoint, and the ``.pth`` it writes
read back by the port's ``--mode test`` and by the JAX Tester's ``.pth``
reader (uegan_tpu.convert.torch_import.import_uegan_checkpoint), whose
generator forward gives the same PNGs."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from uegan_tpu.convert.torch_import import import_uegan_checkpoint
from uegan_tpu.data.pipeline import device_normalize, get_test_loader
from uegan_tpu.models.generator import Generator as JaxGenerator
from uegan_tpu.utils.image_io import device_quantize_u8
from uegan_tpu_torch.utils.image_io import read_png_rgb

FIXTURE = os.path.join(os.path.dirname(os.path.abspath(__file__)), "fixtures", "verify_fivek")
KEYS = ["D_net", "G_net", "d_optimizer", "epoch", "g_optimizer", "lr_scheduler_d",
        "lr_scheduler_g"]


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One torch thread while this file runs (the suite runs several workers
    on a few cores), restored after it so other files keep their setting."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _train_argv(root: str, epochs: int, resume: int = 0,
                norms: tuple = ("none", "none")) -> list:
    return ["--mode", "train", "--g_norm_fun", norms[0], "--d_norm_fun", norms[1],
            "--train_img_dir", os.path.join(FIXTURE, "train"),
            "--val_img_dir", os.path.join(FIXTURE, "val"),
            "--val_label_dir", os.path.join(FIXTURE, "val", "label") + os.sep,
            "--save_root_dir", root, "--g_conv_dim", "8", "--d_conv_dim", "8",
            "--image_size", "48", "--resize_size", "32", "--test_img_size", "32",
            "--train_batch_size", "2", "--val_batch_size", "2", "--total_epochs", str(epochs),
            "--num_epochs_start_val", "0", "--val_each_epochs", "1", "--pool_size", "4",
            "--info_step", "1", "--sample_step", "2", "--compute_dtype", "float32",
            "--is_test_nima", "false", "--is_test_psnr_ssim", "true", "--num_workers", "1",
            "--pretrained_model", str(resume)]


@pytest.mark.parametrize("norms", [("none", "none"), ("InstanceNorm", "BatchNorm")],
                         ids=lambda n: n[0] if n[0] == "none" else "g_in_d_bn")
def test_cli_train_then_test_and_jax_reads_the_pth(tmp_path, monkeypatch, capsys, norms):
    """The default configuration, and train-mode norm layers in G and D
    (the running statistics in the ``.pth``, restored bit-equal by a resume,
    a reference ``.pth`` with ``num_batches_tracked`` loaded; ``--mode
    test`` normalizes with them on the canonical route, as JAX's generator
    in eval mode does)."""
    from uegan_tpu_torch import cli
    from uegan_tpu_torch.train import trainer as trainer_mod

    monkeypatch.setenv("UEGAN_TORCH_DEVICE", "cpu")
    root = str(tmp_path / "results")
    res = cli.run(_train_argv(root, 2, norms=norms))
    out = capsys.readouterr().out
    assert res["steps"] == 4
    assert out.count("D/Total:") == 4 and "Avg. PSNR" in out
    assert all(np.isfinite(v) for v in res["last_losses"].values())
    models = os.path.join(root, "UEGAN-FiveK", "models")
    assert sorted(os.listdir(models)) == ["UEGAN-FiveK_rahinge_1.pth", "UEGAN-FiveK_rahinge_2.pth"]
    pth = os.path.join(models, "UEGAN-FiveK_rahinge_2.pth")
    ckpt = torch.load(pth, map_location="cpu", weights_only=True)
    assert sorted(ckpt) == KEYS and ckpt["epoch"] == 2.0
    assert "d1.0.1.weight_orig" in ckpt["D_net"] and ckpt["g_optimizer"]["state"]
    samples = os.listdir(os.path.join(root, "UEGAN-FiveK", "samples"))
    assert len(samples) == 4  # steps 2 and 4, two images each
    for csv in ("psnr_val_results/PSNR_total_results_epoch_avgpsnr.csv",
                "ssim_val_results/SSIM_total_results_epoch_avgssim.csv"):
        assert open(os.path.join(root, csv)).read().splitlines()[-1].startswith("Best epoch: ")

    stats = [k for k in ckpt["G_net"] if k.endswith(("running_mean", "running_var"))]
    assert len(stats) == (18 if norms[0] != "none" else 0)
    assert len([k for k in ckpt["D_net"] if k.endswith("running_var")]) == (
        5 if norms[1] != "none" else 0)

    # resume at epoch 2 (step 4) for one more epoch; the loaded state holds
    # the checkpoint's running statistics bit for bit
    restored = {}
    real_load = trainer_mod.load_checkpoint

    def load_and_keep(state, loaded):
        real_load(state, loaded)
        restored.update({f"G_net.{k}": v.clone() for k, v in state.g.state_dict().items()})
        restored.update({f"D_net.{k}": v.clone() for k, v in state.d.state_dict().items()})
    monkeypatch.setattr(trainer_mod, "load_checkpoint", load_and_keep)
    res = cli.run(_train_argv(root, 3, resume=2, norms=norms))
    assert res["steps"] == 6
    assert "loaded trained models (epochs: 2.0)" in capsys.readouterr().out
    for net in ("G_net", "D_net"):
        for k, v in ckpt[net].items():
            if k.endswith(("running_mean", "running_var")):
                assert torch.equal(restored[f"{net}.{k}"], v), k
    if norms[0] != "none":  # a reference .pth keeps torch's num_batches_tracked beside them
        from uegan_tpu_torch.config import get_config
        from uegan_tpu_torch.train.state import create_train_state, load_checkpoint

        state = create_train_state(get_config(_train_argv(root, 2, norms=norms)), "cpu",
                                   (32, 32), 2)
        ref = {**ckpt, "G_net": dict(ckpt["G_net"]), "D_net": dict(ckpt["D_net"])}
        ref["G_net"]["enc1.main.2.num_batches_tracked"] = torch.tensor(4)
        ref["D_net"]["d1.0.2.num_batches_tracked"] = torch.tensor(20)
        load_checkpoint(state, ref)
        assert torch.equal(state.d.d1[0][2].running_var, ckpt["D_net"]["d1.0.2.running_var"])

    # the port's --mode test reads the epoch-2 checkpoint
    test_dir = os.path.join(FIXTURE, "test")
    cli.run(["--mode", "test", "--g_norm_fun", norms[0], "--test_img_dir", test_dir,
             "--test_label_dir", os.path.join(test_dir, "label") + os.sep,
             "--save_root_dir", root, "--g_conv_dim", "8", "--test_img_size", "32",
             "--val_batch_size", "2", "--pretrained_model", "2", "--compute_dtype", "float32",
             "--is_test_nima", "false", "--is_test_psnr_ssim", "true", "--num_workers", "1"])
    out_dir = os.path.join(root, "UEGAN-FiveK", "test", "test_results")

    # the JAX Tester's .pth reader and its generator give the same PNGs
    conv = import_uegan_checkpoint(pth, g_use_sn=False, d_use_sn=True)
    assert conv["epoch"] == 2.0 and "spectral" in conv["d_vars"]
    batch = next(iter(get_test_loader(test_dir, img_size=32, batch_size=2, num_workers=1,
                                      process_id=0, process_count=1, emit="uint8")))
    fwd = jax.jit(lambda v, x: JaxGenerator(conv_dim=8, norm_fun=norms[0]).apply(
        v, device_normalize(x), train=False, update_sn=False))
    want = np.asarray(device_quantize_u8(fwd(conv["g_vars"], jnp.asarray(batch["img_raw"]))))
    for i, name in enumerate(batch["img_name"]):
        got = read_png_rgb(os.path.join(out_dir, f"{name}_2.00_testFakeExp.png"))
        assert np.abs(got.astype(np.int16) - want[i].astype(np.int16)).max() <= 1, name


def test_sigterm_checkpoints_at_the_next_step_and_resumes(tmp_path, monkeypatch, capsys):
    """SIGTERM during training: the Trainer saves a checkpoint at the next
    step boundary (epoch 0.5 after one of two steps) and stops;
    ``--pretrained_model -1`` resumes from it at step 1."""
    import signal

    from uegan_tpu_torch import cli
    from uegan_tpu_torch.train import trainer as trainer_mod

    monkeypatch.setenv("UEGAN_TORCH_DEVICE", "cpu")
    root = str(tmp_path / "results")
    real_make = trainer_mod.make_train_step

    def make_with_sigterm(state):
        step = real_make(state)

        def step_then_sigterm(raw, exp):
            out = step(raw, exp)
            if state.step == 1:
                os.kill(os.getpid(), signal.SIGTERM)
            return out
        return step_then_sigterm

    monkeypatch.setattr(trainer_mod, "make_train_step", make_with_sigterm)
    res = cli.run(_train_argv(root, 1))
    assert res["steps"] == 1
    assert "preemption checkpoint saved" in capsys.readouterr().out
    models = os.path.join(root, "UEGAN-FiveK", "models")
    assert os.listdir(models) == ["UEGAN-FiveK_rahinge_0.5.pth"]
    monkeypatch.setattr(trainer_mod, "make_train_step", real_make)
    res = cli.run(_train_argv(root, 1, resume=-1))
    assert res["steps"] == 2
    assert "loaded trained models (epochs: 0.5)" in capsys.readouterr().out


@pytest.mark.parametrize("flag", [["--remat", "true"], ["--cache_data", "true"]])
def test_unported_train_flags_raise(flag, tmp_path, monkeypatch):
    """JAX's --remat and --cache_data are not ported: a train run that asks
    for one stops before it starts, naming the ROADMAP item, rather than
    running without it."""
    from uegan_tpu_torch import cli

    monkeypatch.setenv("UEGAN_TORCH_DEVICE", "cpu")
    with pytest.raises(NotImplementedError, match="ROADMAP queue 1 item 6"):
        cli.run(_train_argv(str(tmp_path / "results"), 1) + flag)
    assert not os.path.exists(tmp_path / "results")


def test_profile_dir_writes_a_trace_and_the_step_timing_line(tmp_path, monkeypatch, capsys):
    """``--profile_dir``: a one-step run (batch 4 of the fixture's 4 pairs,
    no validation) writes the profiler's trace of its step there and ends
    with JAX's step timing line, with each phase's p50 read from the spans."""
    import ast
    import json

    from uegan_tpu_torch import cli

    monkeypatch.setenv("UEGAN_TORCH_DEVICE", "cpu")
    prof_dir = tmp_path / "profile"
    res = cli.run(_train_argv(str(tmp_path / "results"), 1) + [
        "--train_batch_size", "4", "--num_epochs_start_val", "1",
        "--profile_dir", str(prof_dir)])
    assert res["steps"] == 1
    trace, = os.listdir(prof_dir)
    assert trace == "steps_0-0.pt.trace.json"
    events = json.loads((prof_dir / trace).read_text())["traceEvents"]
    assert any(e.get("name") == "aten::convolution" for e in events)
    line, = [ln for ln in capsys.readouterr().out.splitlines() if ln.startswith("=== step timing")]
    timing = ast.literal_eval(line[len("=== step timing: "):-len(" ===")])
    assert {"mean_s", "p50_s", "p90_s", "steps_per_s"} <= set(timing)
    for name in ("train.g_forward", "train.d_backward", "train.g_optim", "trainer.fetch",
                 "trainer.to_device", "trainer.post_step"):
        assert timing[f"{name}_p50_ms"] > 0, name
    assert 0 < timing["train.g_backward_p50_ms"] < 1e3 * timing["p50_s"]
