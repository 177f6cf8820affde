"""PyTorch port, spectral norm in the generator (``--g_use_sn true``) against
the JAX package on the same numpy-seeded weights, bridged through
uegan_tpu.convert.torch_import: the eval forward, one train-mode forward's
power iteration, two unfused train steps (JAX's ``fuse_g`` is off under
spectral norm: G(raw), the D update, then G(exp), so G's u and v advance
twice a step), the ``.pth`` round trip, and ``--mode test``.

cd 8, dd 8, 32 px, batch 2, float32, pool size 4 (both steps only fill the
pool, so no random draw enters the comparison), as
tests/test_torch_train_step.py.  JAX's two steps run once for the file,
with an EMA of G kept.
"""

import copy
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from uegan_tpu.config import Config as JaxConfig
from uegan_tpu.convert.torch_import import import_discriminator, import_generator
from uegan_tpu.data.pipeline import device_normalize
from uegan_tpu.data.pipeline import get_test_loader as jax_test_loader
from uegan_tpu.data.pipeline import get_train_loader as jax_train_loader
from uegan_tpu.infer.packed import make_fast_eval as jax_make_fast_eval
from uegan_tpu.models.generator import Generator as JaxGenerator
from uegan_tpu.train.image_pool import pool_init
from uegan_tpu.train.schedules import make_optimizer as jax_make_optimizer
from uegan_tpu.train.state import ModelBundle, TrainState, build_models
from uegan_tpu.train.step import make_train_step as jax_make_train_step
from uegan_tpu_torch.config import Config
from uegan_tpu_torch.convert.from_flax import discriminator_state_dict, generator_state_dict
from uegan_tpu_torch.models.blocks import SpectralConv2d
from uegan_tpu_torch.models.generator import Generator
from uegan_tpu_torch.models.initializers import fan_in_normal_state
from uegan_tpu_torch.train.state import create_train_state, load_checkpoint, save_checkpoint
from uegan_tpu_torch.train.step import make_train_step
from uegan_tpu_torch.utils.checkpoint import load_pth
from uegan_tpu_torch.utils.image_io import read_png_rgb

from tests.test_torch_train import jax_vgg_params
from tests.test_torch_train_step import _check_ema, _check_metrics, _check_params

CD = 8
FIXTURE = os.path.join(os.path.dirname(os.path.abspath(__file__)), "fixtures", "verify_fivek")
FLAGS = dict(g_conv_dim=CD, d_conv_dim=CD, image_size=48, resize_size=32, train_batch_size=2,
             pool_size=4, compute_dtype="float32", packed_train=False, g_use_sn=True,
             g_ema_decay=0.999)
# the convs JAX normalizes (uegan_tpu/convert/torch_import.py:108-123)
SN_PREFIXES = ([f"enc{i}.main.1" for i in range(1, 6)]
               + [f"upsample{i}.1.main.1" for i in range(1, 5)]
               + [f"dec{i}.main.1" for i in range(1, 5)] + [f"ga{i}.fuse.0" for i in range(1, 6)])


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One torch thread while this file runs (the suite runs several workers
    on a few cores), restored after it so other files keep their setting."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jax_vars(g_sd: dict) -> dict:
    return jax.tree_util.tree_map(jnp.asarray, import_generator(g_sd, use_sn=True))


@pytest.fixture(scope="module")
def weights():
    """(numpy state dict of an SN generator, its flax variables, port G)."""
    g = Generator(conv_dim=CD, use_sn=True)
    sd = fan_in_normal_state(g, seed=1991)
    g.load_state_dict({k: torch.from_numpy(v) for k, v in sd.items()})
    return sd, _jax_vars(sd), g


@pytest.fixture(scope="module")
def jax_g():
    """JAX's SN generator, jitted: (variables, x, train) -> (out, spectral)."""
    model = JaxGenerator(conv_dim=CD, use_sn=True)

    def apply(variables, x, train):
        if train:
            return model.apply(variables, x, train=True, update_sn=True, mutable=["spectral"])
        return model.apply(variables, x, train=False, update_sn=False), variables
    return jax.jit(apply, static_argnums=2)


def test_sn_generator_names_and_init():
    """SN sits where JAX puts it, under torch.nn.utils.spectral_norm's
    names, with v over the GAM fuse conv's 2 nc concat channels; the GAM's
    squeeze/excite and the dec5 head keep plain weights; init_weights fills
    every u and v with unit vectors."""
    from uegan_tpu_torch.models.initializers import init_weights

    g = Generator(conv_dim=CD, use_sn=True)
    sn = sorted(n for n, m in g.named_modules() if isinstance(m, SpectralConv2d))
    assert sn == sorted(SN_PREFIXES)
    sd = g.state_dict()
    for p in SN_PREFIXES:
        assert f"{p}.weight" not in sd and f"{p}.bias" in sd
        assert sd[f"{p}.weight_v"].numel() == sd[f"{p}.weight_orig"][0].numel()
    assert sd["ga3.fuse.0.weight_v"].shape == (2 * 4 * CD,)
    for k in ("ga1.conv.0.weight", "ga1.conv.2.weight", "dec5.0.main.1.weight",
              "dec5.1.main.1.weight"):
        assert k in sd
    init_weights(g, "orthogonal", 0.02, torch.Generator().manual_seed(0))
    for p in SN_PREFIXES:
        for b in ("weight_u", "weight_v"):
            assert abs(float(torch.linalg.vector_norm(getattr(g.get_submodule(p), b))) - 1) < 1e-6


def test_sn_eval_forward_matches_jax(weights, jax_g):
    """Eval mode (stored u and v, no iteration) equals JAX's
    ``Generator(use_sn=True).apply(..., train=False, update_sn=False)``
    within tests/test_torch_generator.py's 3e-4, and leaves u and v alone."""
    sd, variables, g = weights
    x = np.random.default_rng(8).uniform(-1, 1, (2, 32, 32, 3)).astype(np.float32)
    want, _ = jax_g(variables, jnp.asarray(x), False)
    g.eval()
    with torch.inference_mode():
        got = g(torch.from_numpy(x))
    assert float(np.abs(np.asarray(want) - x).mean()) > 0.05  # not just the input
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=3e-4)
    for k, v in g.state_dict().items():
        np.testing.assert_array_equal(v.numpy(), sd[k], err_msg=k)


def test_sn_train_forward_advances_u_v_as_jax(weights, jax_g):
    """One train-mode forward runs one power iteration in every SN conv:
    u and v equal JAX's ``spectral`` collection after its train-mode apply
    (1e-6), and the output (normalized by the new sigmas) JAX's (3e-4)."""
    sd, variables, _ = weights
    g = Generator(conv_dim=CD, use_sn=True)
    g.load_state_dict({k: torch.from_numpy(v) for k, v in sd.items()})
    x = np.random.default_rng(9).uniform(-1, 1, (2, 32, 32, 3)).astype(np.float32)
    want, mut = jax_g(variables, jnp.asarray(x), True)
    g.train()
    with torch.no_grad():
        got = g(torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=3e-4)
    after = generator_state_dict({"params": variables["params"], **jax.device_get(mut)})
    moved = 0.0
    for p in SN_PREFIXES:
        for b in ("weight_u", "weight_v"):
            k = f"{p}.{b}"
            got_b = g.state_dict()[k].numpy()
            np.testing.assert_allclose(got_b, after[k].numpy(), rtol=0, atol=1e-6, err_msg=k)
            moved = max(moved, float(np.abs(got_b - sd[k]).max()))
    assert moved > 1e-2  # the iteration moved the seeded vectors


def _jax_state(sds: dict, steps_per_epoch: int):
    cfg = JaxConfig(**FLAGS)
    g_model, d_model, vgg_model = build_models(cfg)
    g_tx = jax_make_optimizer("adam", cfg.g_lr, steps_per_epoch)
    d_tx = jax_make_optimizer("adam", cfg.d_lr, steps_per_epoch)
    bundle = ModelBundle(g_model, d_model, vgg_model, {"params": jax_vgg_params(sds["vgg"])},
                         g_tx, d_tx, cfg, steps_per_epoch)
    put = lambda tree: jax.tree_util.tree_map(jnp.asarray, tree)
    g_vars = _jax_vars(sds["g"])
    d_vars = put(import_discriminator(sds["d"], use_sn=True))
    g_params = g_vars["params"]
    state = TrainState(step=jnp.zeros((), jnp.int32), g_params=g_params,
                       d_params=d_vars["params"], g_extra={"spectral": g_vars["spectral"]},
                       d_extra={"spectral": d_vars["spectral"]}, g_opt=g_tx.init(g_params),
                       d_opt=d_tx.init(d_vars["params"]), pool=pool_init(4, (32, 32, 3)),
                       rng=jax.random.PRNGKey(0),
                       g_ema=jax.tree_util.tree_map(jnp.copy, g_params))
    return state, bundle


@pytest.fixture(scope="module")
def run():
    """The fixture's batches, the numpy-seeded weights, and JAX's two SN
    steps from them (``make_train_step`` jitted once): the state after each
    step on the host, each step's metrics, and the bundle."""
    jl = jax_train_loader(os.path.join(FIXTURE, "train"), img_size=48, resize_size=32,
                          batch_size=2, num_workers=1, process_id=0, process_count=1)
    batches = list(jl)
    probe = create_train_state(Config(**FLAGS), "cpu", (32, 32), len(batches))
    sds = {"g": fan_in_normal_state(probe.g, seed=11), "d": fan_in_normal_state(probe.d, seed=12),
           "vgg": fan_in_normal_state(probe.vgg, seed=13)}
    jstate, bundle = _jax_state(sds, len(batches))
    jstep = jax.jit(jax_make_train_step(bundle))
    states, metrics = [], []
    for b in batches:
        jstate, jm, _ = jstep(jstate, jnp.asarray(b["img_raw"]), jnp.asarray(b["img_exp"]))
        states.append(jax.device_get(jstate))
        metrics.append({k: float(v) for k, v in jm.items()})
    return batches, sds, states, metrics, bundle


def _port_state(sds: dict, steps_per_epoch: int):
    cfg = Config(**FLAGS)
    state = create_train_state(cfg, "cpu", (32, 32), steps_per_epoch)
    for key, m in (("g", state.g), ("d", state.d), ("vgg", state.vgg)):
        m.load_state_dict({k: torch.from_numpy(v) for k, v in sds[key].items()})
    state.g_ema = {k: p.detach().clone() for k, p in state.g.named_parameters()}
    return cfg, state


def _check_uv(name: str, model: torch.nn.Module, want: dict) -> None:
    got = model.state_dict()
    keys = [k for k in want if k.endswith(("weight_u", "weight_v"))]
    assert keys
    for k in keys:
        d = float((got[k] - want[k]).abs().max())
        assert d <= 1e-5, (name, k, d)


def _want(js):
    return (generator_state_dict({"params": js.g_params, **js.g_extra}),
            discriminator_state_dict({"params": js.d_params, **js.d_extra}))


def _snapshot(model: torch.nn.Module) -> torch.nn.Module:
    """A copy of ``model`` with its parameters' gradients, as
    ``_check_params`` reads them."""
    frozen = copy.deepcopy(model)
    for (_, p), (_, q) in zip(model.named_parameters(), frozen.named_parameters()):
        q.grad = p.grad.clone()
    return frozen


@pytest.fixture(scope="module")
def port_steps(run):
    """The port's two SN steps from the same weights: (cfg, state after
    step 2, each step's metrics, copies of G and D after step 1)."""
    batches, sds, _, _, _ = run
    cfg, state = _port_state(sds, len(batches))
    step = make_train_step(state)
    metrics, after1 = [], None
    for b in batches:
        pm, images = step(torch.from_numpy(b["img_raw"]), torch.from_numpy(b["img_exp"]))
        assert images["real_exp_idt"].shape == (2, 32, 32, 3)
        metrics.append(pm)
        after1 = after1 or (_snapshot(state.g), _snapshot(state.d))
    return cfg, state, metrics, after1


def test_sn_train_steps_match_jax(run, port_steps):
    """Steps 1 and 2 with ``--g_use_sn true``: the five losses to rel 1e-4;
    G's and D's parameters after step 1 by tests/test_torch_train_step.py's
    rule, G's and D's u and v after each step within 1e-5, and the EMA of G
    (weight_orig averaged) after step 2 by the EMA rule."""
    _, _, jstates, jmetrics, _ = run
    cfg, state, metrics, (g1, d1) = port_steps
    for i, pm in enumerate(metrics):
        _check_metrics(pm, jmetrics[i], i + 1)
    want_g, want_d = _want(jstates[0])
    _check_params("G", g1, want_g, cfg.g_lr, cfg.weight_decay)
    _check_params("D", d1, want_d, cfg.d_lr, cfg.weight_decay)
    want_g2, want_d2 = _want(jstates[1])
    _check_uv("G", state.g, want_g2)
    _check_uv("D", state.d, want_d2)
    ema = generator_state_dict({"params": jstates[1].g_ema, **jstates[1].g_extra})
    assert "enc1.main.1.weight_orig" in state.g_ema
    _check_ema(state.g_ema, {k: ema[k] for k in state.g_ema}, cfg.g_lr)
    assert state.step == 2


def test_sn_pth_round_trip(run, port_steps, tmp_path):
    """save_checkpoint -> load_checkpoint into a fresh state: G_net carries
    weight_orig, u and v; the resumed G's state, EMA and train- and
    eval-mode forwards equal the saved one's; JAX's ``.pth`` reader takes
    G_net with ``g_use_sn=True``."""
    from uegan_tpu.convert.torch_import import import_uegan_checkpoint

    batches, sds, _, _, _ = run
    _, state, _, _ = port_steps
    pth = save_checkpoint(state, str(tmp_path / "UEGAN-FiveK_rahinge_1.pth"), 1.0)
    ckpt = load_pth(pth)
    assert "enc1.main.1.weight_u" in ckpt["G_net"] and "ga1.fuse.0.weight_v" in ckpt["G_net"]
    _, resumed = _port_state(sds, len(batches))
    load_checkpoint(resumed, ckpt)
    for k, v in state.g.state_dict().items():
        assert torch.equal(resumed.g.state_dict()[k], v), k
    assert all(torch.equal(resumed.g_ema[k], v) for k, v in state.g_ema.items())
    x = torch.from_numpy(batches[0]["img_raw"])
    outs = []
    for g in (state.g, resumed.g):
        with torch.no_grad():
            outs.append((g.eval()(x), g.train()(x), g.enc1.main[1].weight_u.clone()))
    for a, b in zip(*outs):
        assert torch.equal(a, b)
    conv = import_uegan_checkpoint(pth, g_use_sn=True)
    assert "spectral" in conv["g_vars"] and "ga5" in conv["g_vars"]["spectral"]


def test_sn_mode_test_matches_jax_tester(run, port_steps, tmp_path, monkeypatch):
    """``--mode test --g_use_sn true --quantized_inference int8`` on the
    port's ``.pth`` after two steps takes the canonical forward of the EMA
    weights with the live u and v, as JAX's Tester routes it
    (uegan_tpu/infer/packed.py:make_fast_eval, where SN leaves the packed
    and int8 forwards): its PNGs are within one gray level of JAX's
    make_fast_eval on JAX's EMA and ``spectral`` after the same two steps.
    The packed, int8 and strip forwards refuse an SN generator, naming
    the flag."""
    from uegan_tpu_torch import cli
    from uegan_tpu_torch.infer import quantized, strips
    from uegan_tpu_torch.infer.packed import make_fast_eval, make_packed_eval

    _, _, jstates, _, bundle = run
    _, state, _, _ = port_steps
    root = tmp_path / "results"
    models = root / "UEGAN-FiveK" / "models"
    models.mkdir(parents=True)
    save_checkpoint(state, str(models / "UEGAN-FiveK_rahinge_2.pth"), 2.0)
    monkeypatch.setenv("UEGAN_TORCH_DEVICE", "cpu")
    test_dir = os.path.join(FIXTURE, "test")
    cli.run(["--mode", "test", "--test_img_dir", test_dir, "--save_root_dir", str(root),
             "--g_conv_dim", str(CD), "--g_use_sn", "true", "--test_img_size", "32",
             "--val_batch_size", "2", "--pretrained_model", "2", "--compute_dtype", "float32",
             "--quantized_inference", "int8", "--is_test_nima", "false",
             "--is_test_psnr_ssim", "false", "--num_workers", "1"])

    js = jstates[1]
    jcfg = JaxConfig(**FLAGS, quantized_inference="int8")
    fn = jax_make_fast_eval(bundle._replace(config=jcfg), js.g_ema, u8_output=True)
    batch = next(iter(jax_test_loader(test_dir, img_size=32, batch_size=2, num_workers=1,
                                      process_id=0, process_count=1, emit="uint8")))
    want = np.asarray(fn(js.g_ema, js.g_extra, device_normalize(jnp.asarray(batch["img_raw"]))))
    out_dir = root / "UEGAN-FiveK" / "test" / "test_results"
    for i, name in enumerate(batch["img_name"]):
        got = read_png_rgb(str(out_dir / f"{name}_2.00_testFakeExp.png")).astype(np.int16)
        assert np.abs(got - want[i].astype(np.int16)).max() <= 1, name

    g = state.g.eval()
    assert make_fast_eval(g, Config(g_use_sn=True)).__name__ == "eval_step"
    for build in (lambda: make_packed_eval(g, {}), lambda: quantized.make_int8_eval(g),
                  lambda: quantized.build_quant_tables(g),
                  lambda: strips.make_strip_fast_eval(g, 16)):
        with pytest.raises(ValueError, match="--g_use_sn true"):
            build()
