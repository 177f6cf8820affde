"""PyTorch port, train slice: the whole train step against the JAX package's
``make_train_step`` (``packed_train=False``, the bit-canonical step), two
steps from the same numpy-seeded weights on the vendored fixture's batches.

The JAX state is built from the bridged weights (no ``create_train_state``:
its jitted init of G, D and VGG costs more than this whole test), and its
step is jitted once.  cd 8, dd 8, 32 px, batch 2, float32, pool size 4, so
both steps only fill the pool and no random draw enters the comparison.
The JAX steps run once for the file, keeping an EMA of G: a second case
saves JAX's state after step 1 to orbax, exports it with ``orbax_to_pth.py
--weights live`` and resumes the port from that ``.pth`` into step 2; a
third holds the port's EMA to JAX's and follows it through the ``.pth``
into ``--mode test``.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from uegan_tpu.config import Config as JaxConfig
from uegan_tpu.convert.torch_import import import_discriminator, import_generator
from uegan_tpu.data.pipeline import get_train_loader as jax_train_loader
from uegan_tpu.train.image_pool import pool_init
from uegan_tpu.train.schedules import make_optimizer as jax_make_optimizer
from uegan_tpu.train.state import ModelBundle, TrainState, build_models
from uegan_tpu.train.step import make_train_step as jax_make_train_step
from uegan_tpu.utils.checkpoint import CheckpointManager
from uegan_tpu_torch.config import Config
from uegan_tpu_torch.convert.from_flax import discriminator_state_dict, generator_state_dict
from uegan_tpu_torch.models.initializers import fan_in_normal_state
from uegan_tpu_torch.train.state import create_train_state, load_checkpoint
from uegan_tpu_torch.train.step import make_train_step
from uegan_tpu_torch.utils.checkpoint import load_pth

from tests.test_torch_train import jax_vgg_params

FIXTURE = os.path.join(os.path.dirname(os.path.abspath(__file__)), "fixtures", "verify_fivek",
                       "train")
FLAGS = dict(g_conv_dim=8, d_conv_dim=8, image_size=48, resize_size=32, train_batch_size=2,
             pool_size=4, compute_dtype="float32", packed_train=False)
EMA_DECAY = 0.999  # JAX's steps keep an EMA of G; it changes nothing else of a step


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One torch thread while this file runs (the suite runs several workers
    on a few cores), restored after it so other files keep their setting."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jax_state(sds: dict, steps_per_epoch: int, g_ema_decay: float = 0.0):
    cfg = JaxConfig(**FLAGS, g_ema_decay=g_ema_decay)
    g_model, d_model, vgg_model = build_models(cfg)
    g_tx = jax_make_optimizer("adam", cfg.g_lr, steps_per_epoch)
    d_tx = jax_make_optimizer("adam", cfg.d_lr, steps_per_epoch)
    bundle = ModelBundle(g_model, d_model, vgg_model, {"params": jax_vgg_params(sds["vgg"])},
                         g_tx, d_tx, cfg, steps_per_epoch)
    put = lambda tree: jax.tree_util.tree_map(jnp.asarray, tree)
    g_params = put(import_generator(sds["g"])["params"])
    d_vars = put(import_discriminator(sds["d"], use_sn=True))
    state = TrainState(step=jnp.zeros((), jnp.int32), g_params=g_params,
                       d_params=d_vars["params"], g_extra={},
                       d_extra={"spectral": d_vars["spectral"]}, g_opt=g_tx.init(g_params),
                       d_opt=d_tx.init(d_vars["params"]), pool=pool_init(4, (32, 32, 3)),
                       rng=jax.random.PRNGKey(0),
                       g_ema=jax.tree_util.tree_map(jnp.copy, g_params) if g_ema_decay else None)
    return state, jax.jit(jax_make_train_step(bundle))


def _check_params(name: str, model: torch.nn.Module, want: dict, lr: float, wd: float,
                  share: float = 1e-4) -> None:
    """Parameters after step 1 within 1e-5 of JAX's.  Adam's first step moves
    each element by lr * g / (|g| + 1e-8): where the gradient (with the
    weight decay) nearly cancels, |g| < 1e-6, a 1e-8 difference of two f32
    gradients moves the step by up to lr.  So an element may miss 1e-5 only
    there, by no more than the most a step can move, 2 lr, and such elements
    must be under ``share`` of all (1e-4 by default)."""
    got = model.state_dict()
    grads = dict(model.named_parameters())
    n_all = n_off = 0
    for k, w in want.items():
        d = (got[k] - w).abs()
        if k not in grads:  # spectral-norm u, v
            assert float(d.max()) <= 1e-5, (name, k, float(d.max()))
            continue
        p = grads[k]
        # the step's gradient with its decay term (taken at the updated
        # parameter, which is 1e-4 of it away from the one the step saw)
        cancels = (p.grad + wd * p.detach()).abs() < 1e-6
        off = d > 1e-5
        assert bool((cancels | ~off).all()), (name, k, float(d[~cancels].max()))
        assert float(d.max()) <= 2 * lr, (name, k, float(d.max()))
        n_all += d.numel()
        n_off += int(off.sum())
    assert n_off <= share * n_all, (name, n_off, n_all)


@pytest.fixture(scope="module")
def run():
    """The fixture's batches, the numpy-seeded weights, and JAX's two steps
    from them, with an EMA of G kept: the state after each step (on the
    host, without the EMA), each step's metrics and the EMA after each step."""
    jl = jax_train_loader(FIXTURE, img_size=48, resize_size=32, batch_size=2, num_workers=1,
                          process_id=0, process_count=1)
    batches = list(jl)
    probe = create_train_state(Config(**FLAGS), "cpu", (32, 32), len(batches))
    sds = {"g": fan_in_normal_state(probe.g, seed=1), "d": fan_in_normal_state(probe.d, seed=2),
           "vgg": fan_in_normal_state(probe.vgg, seed=3)}
    jstate, jstep = _jax_state(sds, len(batches), EMA_DECAY)
    states, metrics, emas = [], [], []
    for b in batches:
        jstate, jm, _ = jstep(jstate, jnp.asarray(b["img_raw"]), jnp.asarray(b["img_exp"]))
        host = jax.device_get(jstate)
        states.append(host.replace(g_ema=None))
        emas.append(host.g_ema)
        metrics.append({k: float(v) for k, v in jm.items()})
    return batches, sds, states, metrics, emas


def _port_state(sds: dict, steps_per_epoch: int, g_ema_decay: float = 0.0):
    cfg = Config(**FLAGS, g_ema_decay=g_ema_decay)
    state = create_train_state(cfg, "cpu", (32, 32), steps_per_epoch)
    for key, m in (("g", state.g), ("d", state.d), ("vgg", state.vgg)):
        m.load_state_dict({k: torch.from_numpy(v) for k, v in sds[key].items()})
    if state.g_ema is not None:  # the EMA starts at the loaded weights, as JAX's
        state.g_ema = {k: p.detach().clone() for k, p in state.g.named_parameters()}
    return cfg, state


def _check_metrics(pm: dict, jm: dict, step: int) -> None:
    assert sorted(pm) == sorted(jm)
    for k, v in jm.items():
        np.testing.assert_allclose(float(pm[k]), v, rtol=1e-4, err_msg=f"{k} step {step}")


def _want(jstate):
    return (generator_state_dict({"params": jstate.g_params}),
            discriminator_state_dict({"params": jstate.d_params, **jstate.d_extra}))


def test_train_step_matches_jax(run):
    """Steps 1 and 2: D/Total, G/Total and the three G terms to rel 1e-4,
    and G's and D's parameters (and D's u, v) after step 1 (_check_params)."""
    batches, sds, jstates, jmetrics, _ = run
    cfg, state = _port_state(sds, len(batches))
    step = make_train_step(state)
    for i, b in enumerate(batches):
        p0 = {k: v.detach().clone() for k, v in state.g.named_parameters()}
        pm, images = step(torch.from_numpy(b["img_raw"]), torch.from_numpy(b["img_exp"]))
        _check_metrics(pm, jmetrics[i], i + 1)
        assert images["fake_exp"].shape == (2, 32, 32, 3)
        if i == 0:
            want_g, want_d = _want(jstates[0])
            _check_params("G", state.g, want_g, cfg.g_lr, cfg.weight_decay)
            _check_params("D", state.d, want_d, cfg.d_lr, cfg.weight_decay)
            moved = max(float((p.detach() - p0[k]).abs().max())
                        for k, p in state.g.named_parameters())
            assert moved > 0.5 * cfg.g_lr  # the step moved G
    assert state.step == 2 and state.pool.count == 4


def test_resume_from_exported_jax_checkpoint_takes_jax_step_2(run, tmp_path):
    """JAX's state after step 1, saved by its CheckpointManager and exported
    with ``--weights live``, resumes the port (weights, D's u/v, both Adam
    moments and counts; the pool starts empty, as on any .pth resume, and at
    step 2 of pool 4 and batch 2 the pool only fills); step 2 then matches
    JAX's step 2: losses to rel 1e-4 and the parameters after it by
    _check_params, which Adam's second step reaches only through the
    exported moments and step count."""
    import orbax_to_pth

    batches, sds, jstates, jmetrics, _ = run
    jcfg = JaxConfig(**FLAGS, checkpoint_async=False)
    ckpt = CheckpointManager(str(tmp_path / "jax"), jcfg).save(jstates[0], 1 / len(batches))
    pth = orbax_to_pth.export_checkpoint(ckpt, str(tmp_path / "port"), weights="live")
    cfg, state = _port_state(sds, len(batches))
    load_checkpoint(state, load_pth(pth))
    state.step = 1
    for opt in (state.g_opt, state.d_opt):
        assert all(float(s["step"]) == 1.0 for s in opt.state.values())
    b = batches[1]
    pm, _ = make_train_step(state)(torch.from_numpy(b["img_raw"]), torch.from_numpy(b["img_exp"]))
    _check_metrics(pm, jmetrics[1], 2)
    want_g, want_d = _want(jstates[1])
    _check_params("G", state.g, want_g, cfg.g_lr, cfg.weight_decay)
    _check_params("D", state.d, want_d, cfg.d_lr, cfg.weight_decay)


def _check_ema(ema: dict, want: dict, lr: float) -> None:
    """The EMA of G against JAX's by _check_params's rule: each element
    within 1e-5, but for at most 1e-4 of them, each within 2 lr (the
    parameters it averages miss 1e-5 only where Adam divides a nearly
    cancelling gradient)."""
    n_all = n_off = 0
    for k, w in want.items():
        d = (ema[k] - w).abs()
        assert float(d.max()) <= 2 * lr, (k, float(d.max()))
        n_all += d.numel()
        n_off += int((d > 1e-5).sum())
    assert n_off <= 1e-4 * n_all, (n_off, n_all)


def test_ema_matches_jax_and_reaches_mode_test(run, tmp_path, monkeypatch):
    """With ``g_ema_decay`` set, the port's EMA of G after steps 1 and 2
    equals JAX's ``make_train_step`` EMA (the Karras warmup); the checkpoint
    keeps it (``G_ema``), a resume with ``g_ema_decay`` restores it and one
    without drops it; and ``--mode test`` on that checkpoint writes the PNGs
    of a forward of the EMA weights (``--ema_eval``, the default), and of
    the live ones under ``--ema_eval false``."""
    from uegan_tpu_torch import cli
    from uegan_tpu_torch.data.pipeline import get_test_loader
    from uegan_tpu_torch.infer.packed import make_fast_eval
    from uegan_tpu_torch.models.generator import Generator
    from uegan_tpu_torch.train.state import save_checkpoint
    from uegan_tpu_torch.utils.checkpoint import EMA_KEY, generator_state
    from uegan_tpu_torch.utils.image_io import normalize_u8, quantize_u8, read_png_rgb

    batches, sds, _, _, jemas = run
    cfg, state = _port_state(sds, len(batches), EMA_DECAY)
    step = make_train_step(state)
    for i, b in enumerate(batches):
        step(torch.from_numpy(b["img_raw"]), torch.from_numpy(b["img_exp"]))
        want = generator_state_dict({"params": jemas[i]})
        _check_ema(state.g_ema, {k: want[k] for k in state.g_ema}, cfg.g_lr)
    # the live weights far from their average, as adversarial training can
    # drive them, so that the two --mode test runs below tell them apart
    with torch.no_grad():
        for p in state.g.parameters():
            p.mul_(1.5)

    root = str(tmp_path / "results")
    models = os.path.join(root, cfg.version, cfg.model_save_path)
    os.makedirs(models)
    pth = save_checkpoint(state, os.path.join(models, "UEGAN-FiveK_rahinge_2.pth"), 2.0)
    ckpt = load_pth(pth)
    assert all(torch.equal(ckpt[EMA_KEY][k], v) for k, v in state.g_ema.items())
    _, resumed = _port_state(sds, len(batches), EMA_DECAY)
    load_checkpoint(resumed, ckpt)
    assert all(torch.equal(resumed.g_ema[k], v) for k, v in state.g_ema.items())
    _, plain = _port_state(sds, len(batches))
    load_checkpoint(plain, ckpt)
    assert plain.g_ema is None

    monkeypatch.setenv("UEGAN_TORCH_DEVICE", "cpu")
    test_dir = os.path.join(os.path.dirname(FIXTURE), "test")
    loader = get_test_loader(test_dir, img_size=32, batch_size=2, num_workers=1, emit="uint8")
    pngs = {}
    for ema_eval in ("true", "false"):
        out = os.path.join(root, f"ema_{ema_eval}")
        cli.run(["--mode", "test", "--test_img_dir", test_dir, "--save_root_dir", root,
                 "--test_result_path", f"ema_{ema_eval}", "--g_conv_dim", "8",
                 "--test_img_size", "32", "--val_batch_size", "2", "--pretrained_model", "2",
                 "--compute_dtype", "float32", "--is_test_nima", "false",
                 "--is_test_psnr_ssim", "false", "--ema_eval", ema_eval])
        g = Generator(conv_dim=8)
        g.load_state_dict(generator_state(ckpt, ema=ema_eval == "true"))
        fn = make_fast_eval(g.eval(), Config(g_conv_dim=8, compute_dtype="float32"))
        for batch in loader:
            with torch.inference_mode():
                want = quantize_u8(fn(normalize_u8(torch.from_numpy(batch["img_raw"])))).numpy()
            for name, w in zip(batch["img_name"], want):
                got = read_png_rgb(os.path.join(root, cfg.version, f"ema_{ema_eval}",
                                                "test_results", f"{name}_2.00_testFakeExp.png"))
                np.testing.assert_array_equal(got, w, err_msg=f"{name} ema_eval {ema_eval}")
                pngs[name, ema_eval] = got
    assert any(not np.array_equal(pngs[k, "true"], pngs[k, "false"]) for k, _ in pngs)
