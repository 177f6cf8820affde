"""PyTorch port, train slice: each module against the JAX package on the same
numpy-seeded weights and inputs.

Spectral norm, the 2x2 average pool, the discriminator (one and three
spectral-norm branches, and the u/v it leaves), the VGG taps, the six GAN
modes, the reconstruction and perceptual losses, the image pool, the lr
schedule and Adam, the plain versions of kernels A' and B' against
``jax.vjp``, the train loader's batches, the D and VGG weight bridges, and
the port's refusals.  The whole step is in test_torch_train_step.py and the
CLI in test_torch_train_cli.py.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from uegan_tpu.convert.torch_import import import_discriminator, import_vgg19
from uegan_tpu.losses.gan import multiscale_gan_loss as jax_multiscale_gan_loss
from uegan_tpu.losses.perceptual import perceptual_loss as jax_perceptual_loss
from uegan_tpu.losses.reconstruction import multiscale_rec_loss as jax_rec_loss
from uegan_tpu.models.discriminator import Discriminator as JaxDiscriminator
from uegan_tpu.models.vgg import VGG19_CFG
from uegan_tpu.models.vgg import VGG19Features as JaxVGG
from uegan_tpu.models.vgg import normalize_imagenet as jax_normalize_imagenet
from uegan_tpu.ops.norms import feature_mean_std as jax_feature_mean_std
from uegan_tpu.ops.pooling import avg_pool_2x2 as jax_avg_pool_2x2
from uegan_tpu.ops.resize import upsample2x_align_corners as jax_upsample2x
from uegan_tpu.ops.spectral_norm import spectral_normalize as jax_spectral_normalize
from uegan_tpu.ops.spectral_norm import spectral_sigmas as jax_spectral_sigmas
from uegan_tpu.train.image_pool import PoolState, pool_query
from uegan_tpu.train.schedules import make_lr_schedule as jax_lr_schedule
from uegan_tpu.train.schedules import make_optimizer as jax_make_optimizer
from uegan_tpu_torch.convert.from_flax import discriminator_state_dict, vgg_state_dict
from uegan_tpu_torch.losses.gan import multiscale_gan_loss
from uegan_tpu_torch.losses.perceptual import perceptual_loss
from uegan_tpu_torch.losses.reconstruction import multiscale_rec_loss
from uegan_tpu_torch.models.discriminator import Discriminator
from uegan_tpu_torch.models.initializers import fan_in_normal_state
from uegan_tpu_torch.models.vgg import VGG19_CONVS, VGG19Features
from uegan_tpu_torch.ops import _build, gam_stats, resize2x
from uegan_tpu_torch.ops.pooling import avg_pool_2x2
from uegan_tpu_torch.ops.spectral_norm import spectral_normalize, spectral_sigmas
from uegan_tpu_torch.train.image_pool import ImagePool
from uegan_tpu_torch.train.schedules import make_lr_schedule, make_optimizer

DD = 8
FIXTURE = os.path.join(os.path.dirname(os.path.abspath(__file__)), "fixtures", "verify_fivek")


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One torch thread while this file runs (the suite runs several workers
    on a few cores), restored after it so other files keep their setting."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _hwio(w: np.ndarray) -> np.ndarray:
    return np.ascontiguousarray(np.transpose(w, (2, 3, 1, 0)))


def _unit(v: np.ndarray) -> np.ndarray:
    return (v / np.linalg.norm(v)).astype(np.float32)


def jax_vgg_params(sd: dict, seed: int = 4) -> dict:
    """Flax VGG params from the port's state dict; conv5_2 .. conv5_4, which
    the JAX trunk declares but no tap reads, get small random weights."""
    rng = np.random.default_rng(seed)
    at = {name: idx for name, idx, _ in VGG19_CONVS}
    params, cin = {}, 3
    for name, c in VGG19_CFG:
        if name in at:
            params[f"{name}_kernel"] = _hwio(sd[f"features.{at[name]}.weight"])
            params[f"{name}_bias"] = sd[f"features.{at[name]}.bias"]
        else:
            params[f"{name}_kernel"] = (rng.standard_normal((3, 3, cin, c)) * 0.01).astype(
                np.float32)
            params[f"{name}_bias"] = np.zeros(c, np.float32)
        cin = c
    return params


@pytest.fixture(scope="module")
def vgg():
    """(port VGG19Features, flax params) on the same seeded weights."""
    m = VGG19Features()
    sd = fan_in_normal_state(m, seed=3)
    m.load_state_dict({k: torch.from_numpy(v) for k, v in sd.items()})
    return m, jax_vgg_params(sd)


def test_spectral_norm_matches_jax():
    """One power iteration, and the sigmas of three sequential forwards with
    their gradient through W; u and v carry none."""
    rng = np.random.default_rng(11)
    w = rng.standard_normal((16, 8, 3, 3)).astype(np.float32)
    u, v = _unit(rng.standard_normal(16)), _unit(rng.standard_normal(72))
    jw, ju, jv = jax_spectral_normalize(jnp.asarray(_hwio(w)), jnp.asarray(u), jnp.asarray(v))
    pw, pu, pv = spectral_normalize(torch.from_numpy(w), torch.from_numpy(u), torch.from_numpy(v))
    np.testing.assert_allclose(_hwio(pw.numpy()), np.asarray(jw), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(pu.numpy(), np.asarray(ju), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(pv.numpy(), np.asarray(jv), rtol=1e-5, atol=1e-6)

    coef = np.array([1.0, -2.0, 0.5], np.float32)
    jf = lambda k: jnp.dot(jax_spectral_sigmas(k, u, v, 3)[0], coef)
    jsig, ju3, jv3 = jax_spectral_sigmas(jnp.asarray(_hwio(w)), u, v, 3)
    jgrad = jax.grad(jf)(jnp.asarray(_hwio(w)))
    wt = torch.from_numpy(w).requires_grad_()
    psig, pu3, pv3 = spectral_sigmas(wt, torch.from_numpy(u), torch.from_numpy(v), 3)
    (psig @ torch.from_numpy(coef)).backward()
    assert not pu3.requires_grad and not pv3.requires_grad
    np.testing.assert_allclose(psig.detach().numpy(), np.asarray(jsig), rtol=1e-5)
    assert len(set(np.asarray(jsig).tolist())) == 3  # three different sigmas
    np.testing.assert_allclose(pu3.numpy(), np.asarray(ju3), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(pv3.numpy(), np.asarray(jv3), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(_hwio(wt.grad.numpy()), np.asarray(jgrad), rtol=1e-4, atol=1e-6)


@pytest.mark.parametrize("shape", [(2, 8, 8, 3), (1, 7, 9, 2)])
def test_avg_pool_2x2_matches_jax(shape):
    x = np.random.default_rng(12).normal(size=shape).astype(np.float32)
    np.testing.assert_allclose(avg_pool_2x2(torch.from_numpy(x)).numpy(),
                               np.asarray(jax_avg_pool_2x2(jnp.asarray(x))), rtol=0, atol=1e-6)


@pytest.mark.parametrize("branches", [1, 3])
def test_discriminator_matches_jax(branches):
    """D at 32 px (its last stages reflect-pad maps narrower than the pad),
    train mode: the five prediction maps, and u/v after ``branches`` power
    iterations."""
    d = Discriminator(conv_dim=DD)
    sd = fan_in_normal_state(d, seed=2)
    d.load_state_dict({k: torch.from_numpy(v) for k, v in sd.items()})
    d.train()
    variables = import_discriminator(sd, use_sn=True)
    x = np.random.default_rng(13).uniform(-1, 1, (2 * branches, 32, 32, 3)).astype(np.float32)
    want, mut = JaxDiscriminator(conv_dim=DD).apply(
        variables, jnp.asarray(x), train=True, update_sn=True, sn_branches=branches,
        mutable=["spectral"])
    got = d(torch.from_numpy(x), sn_branches=branches)
    assert [tuple(p.shape) for p in got] == [(2 * branches, 1, 32 >> i, 32 >> i)
                                             for i in range(1, 6)]
    for g_i, w_i in zip(got, want, strict=True):
        np.testing.assert_allclose(g_i.detach().permute(0, 2, 3, 1).numpy(), np.asarray(w_i),
                                   rtol=0, atol=1e-5)
    after = d.state_dict()
    for i in range(1, 6):
        for name in ("u", "v"):
            np.testing.assert_allclose(after[f"d{i}.0.1.weight_{name}"].numpy(),
                                       np.asarray(mut["spectral"][f"d{i}"]["conv"][name]),
                                       rtol=1e-5, atol=1e-6)


def test_discriminator_parameter_count():
    d = Discriminator(conv_dim=32, device="meta")
    assert sum(p.numel() for p in d.parameters()) == 4_633_632


def test_vgg_taps_match_jax(vgg):
    m, params = vgg
    x01 = np.random.default_rng(14).uniform(0, 1, (2, 32, 32, 3)).astype(np.float32)
    want = JaxVGG().apply({"params": params}, jax_normalize_imagenet(jnp.asarray(x01)))
    with torch.no_grad():
        got = m(torch.from_numpy(x01))
    assert sorted(got) == sorted(want)
    for tap, w in want.items():
        w = np.asarray(w)
        np.testing.assert_allclose(got[tap].permute(0, 2, 3, 1).numpy(), w, rtol=1e-5,
                                   atol=1e-5 * float(np.abs(w).max()))


@pytest.mark.parametrize("for_d", [True, False])
@pytest.mark.parametrize("mode", ["ls", "original", "w", "hinge", "rahinge", "rals"])
def test_gan_losses_match_jax(mode, for_d):
    rng = np.random.default_rng(15)
    draw = (lambda s: rng.normal(0, 2, s)) if mode == "original" else (lambda s: rng.uniform(-1, 1, s))
    real = [draw((2, 1, 16 >> i, 16 >> i)).astype(np.float32) for i in range(5)]
    fake = [draw((2, 1, 16 >> i, 16 >> i)).astype(np.float32) for i in range(5)]
    want = jax_multiscale_gan_loss([jnp.asarray(a) for a in real],
                                   [jnp.asarray(a) for a in fake], mode, for_d)
    got = multiscale_gan_loss([torch.from_numpy(a) for a in real],
                              [torch.from_numpy(a) for a in fake], mode, for_d)
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("kind", ["l1", "l2", "smoothl1"])
def test_rec_loss_matches_jax(kind):
    rng = np.random.default_rng(16)
    a = rng.normal(0, 1.5, (2, 9, 7, 3)).astype(np.float32)
    b = rng.normal(0, 1.5, (2, 9, 7, 3)).astype(np.float32)
    want = jax_rec_loss(jnp.asarray(a), jnp.asarray(b), kind)
    got = multiscale_rec_loss(torch.from_numpy(a), torch.from_numpy(b), kind)
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)


@pytest.mark.parametrize("split_label", [True, False])
def test_perceptual_loss_and_its_gradient_match_jax(vgg, split_label):
    """The loss, and its gradient through the generated image (JAX's
    relu1_1 runs packed, the port's canonically)."""
    m, params = vgg
    rng = np.random.default_rng(17)
    x01 = rng.uniform(0, 1, (2, 32, 32, 3)).astype(np.float32)
    y01 = rng.uniform(0, 1, (2, 32, 32, 3)).astype(np.float32)
    f = lambda x: jax_perceptual_loss(JaxVGG(), {"params": params}, x, jnp.asarray(y01),
                                      split_label=split_label)
    want, want_grad = jax.value_and_grad(f)(jnp.asarray(x01))
    xt = torch.from_numpy(x01).requires_grad_()
    got = perceptual_loss(m, xt, torch.from_numpy(y01), split_label=split_label)
    got.backward()
    np.testing.assert_allclose(float(got.detach()), float(want), rtol=1e-5)
    g = np.asarray(want_grad)
    np.testing.assert_allclose(xt.grad.numpy(), g, rtol=0, atol=1e-4 * float(np.abs(g).max()))


def _jax_pool_draws(key, b: int, pool_size: int):
    """The uniforms and slots JAX's pool_query draws for a batch of b from key."""
    ps, slots, k = [], [], key
    for _ in range(b):
        k, k_p, k_idx = jax.random.split(k, 3)
        ps.append(float(jax.random.uniform(k_p)))
        slots.append(int(jax.random.randint(k_idx, (), 0, pool_size)))
    return torch.tensor(ps), torch.tensor(slots)


def test_image_pool_matches_jax():
    """Same draws -> the same returned images and the same store, through
    the filling queries and the swap-or-pass queries after them."""
    pool_size, shape = 3, (2, 4, 4, 3)
    jstate = PoolState(images=jnp.zeros((pool_size, 4, 4, 3)), count=jnp.zeros((), jnp.int32))
    pool = ImagePool(pool_size, shape[1:])
    rng = np.random.default_rng(18)
    swapped = passed = 0
    for q in range(6):
        batch = rng.normal(size=shape).astype(np.float32)
        key = jax.random.PRNGKey(q)
        jstate, want = pool_query(jstate, jnp.asarray(batch), key)
        draws = _jax_pool_draws(key, shape[0], pool_size)
        got = pool.query(torch.from_numpy(batch), draws)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        np.testing.assert_array_equal(pool.images.numpy(), np.asarray(jstate.images))
        assert pool.count == int(jstate.count)
        if q >= 2:
            swapped += int((draws[0] > 0.5).sum())
            passed += int((draws[0] <= 0.5).sum())
    assert swapped and passed  # both branches ran


def test_lr_schedule_and_adam_match_optax():
    """The linear decay per epoch, and three coupled-L2 Adam steps (not
    AdamW) against optax's chain on the same gradients."""
    jsched = jax_lr_schedule(4e-4, 3)
    psched = make_lr_schedule(4e-4, 3)
    for step in range(0, 310, 7):
        # JAX takes 1 - (epoch + 1 - 50) / 50 in f32: near the end of the decay
        # that rounding is a few 1e-6 of the factor
        assert psched(step) == pytest.approx(float(jsched(step)), rel=1e-5, abs=1e-12), step
    rng = np.random.default_rng(19)
    p0 = rng.normal(0, 1, (5, 4)).astype(np.float32)
    grads = [rng.normal(0, 1, (5, 4)).astype(np.float32) for _ in range(3)]
    tx = jax_make_optimizer("adam", 1e-2, 1)
    jp, st = jnp.asarray(p0), None
    st = tx.init(jp)
    param = torch.nn.Parameter(torch.from_numpy(p0.copy()))
    opt = make_optimizer([param], "adam", 1e-2)
    sched = make_lr_schedule(1e-2, 1)
    for i, g in enumerate(grads):
        upd, st = tx.update(jnp.asarray(g), st, jp)
        jp = optax.apply_updates(jp, upd)
        for group in opt.param_groups:
            group["lr"] = sched(i)
        param.grad = torch.from_numpy(g)
        opt.step()
        np.testing.assert_allclose(param.detach().numpy(), np.asarray(jp), rtol=1e-6, atol=1e-7)


GAM_BWD_CASES = [((2, 6, 5, 8), False), ((2, 1, 1, 5), False), ((1, 4, 4, 3), True),
                 ((2, 7, 3, 16), True)]


@pytest.mark.parametrize("shape,constant", GAM_BWD_CASES)
def test_gam_backward_plain_matches_jax_vjp(shape, constant):
    """A' (plain): dx from dmean, dstd and the f32 mean and var, against
    jax.vjp of feature_mean_std, at one pixel (hw = 1) and with a constant
    channel; the autograd of the plain forward agrees too."""
    rng = np.random.default_rng(20)
    x = rng.normal(0.5, 1.5, shape).astype(np.float32)
    if constant:
        x[..., 0] = 0.3
    n, _, _, c = shape
    dm = rng.normal(size=(n, 1, 1, c)).astype(np.float32)
    ds = rng.normal(size=(n, 1, 1, c)).astype(np.float32)
    _, vjp = jax.vjp(jax_feature_mean_std, jnp.asarray(x))
    want = np.asarray(vjp((jnp.asarray(dm), jnp.asarray(ds)))[0])
    xt = torch.from_numpy(x)
    mean32, var32 = gam_stats.plain_stats32(xt)
    got = gam_stats.gam_mean_std_backward(xt, mean32, var32, torch.from_numpy(dm),
                                          torch.from_numpy(ds))
    # JAX's vjp adds dmean / hw and two terms of 2 x dvar / (hw - 1) of
    # opposite sign, dvar = dstd / (2 std), and rounds each in f32: where std
    # is about sqrt(eps) (hw = 1, a constant channel) those terms are ~100x
    # the result, so the bound is a few f32 ulps of them beside 1e-5 relative
    hw = shape[1] * shape[2]
    std = np.sqrt(np.maximum(var32.double().numpy(), 0) + 1e-5)
    terms = np.abs(dm) / hw + 2 * np.abs(x) * np.abs(ds) / (2 * std * max(hw - 1, 1))
    bound = 1e-5 * np.abs(want) + 4 * np.finfo(np.float32).eps * terms + 1e-7
    assert np.all(np.abs(got.numpy() - want) <= bound)
    xg = xt.clone().requires_grad_()
    mean, std = gam_stats.gam_mean_std(xg)
    torch.autograd.backward((mean, std), (torch.from_numpy(dm), torch.from_numpy(ds)))
    assert np.all(np.abs(xg.grad.numpy() - want) <= bound)


@pytest.mark.parametrize("shape", [(2, 4, 4, 3), (1, 1, 5, 2), (2, 3, 1, 4), (1, 6, 7, 8)])
def test_upsample_backward_plain_matches_jax_vjp(shape):
    """B' (plain): the transposed interpolation matrices, against jax.vjp
    of the JAX decoder's upsample (resize_bilinear_matmul), H or W = 1
    included; the autograd of the plain forward agrees too."""
    rng = np.random.default_rng(21)
    x = rng.normal(size=shape).astype(np.float32)
    n, h, w, c = shape
    dy = rng.normal(size=(n, 2 * h, 2 * w, c)).astype(np.float32)
    _, vjp = jax.vjp(jax_upsample2x, jnp.asarray(x))
    want = np.asarray(vjp(jnp.asarray(dy))[0])
    got = resize2x.upsample2x_backward(torch.from_numpy(dy))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    xg = torch.from_numpy(x).requires_grad_()
    resize2x.upsample2x(xg).backward(torch.from_numpy(dy))
    np.testing.assert_allclose(xg.grad.numpy(), want, rtol=1e-4, atol=1e-4)


def test_train_loader_batches_equal_jax():
    """Crops, resizes, flips and the epoch order: bit-equal to JAX's loader
    over two epochs of the vendored fixture (uint8 batches)."""
    from uegan_tpu.data.pipeline import get_train_loader as jax_train_loader
    from uegan_tpu_torch.data.pipeline import get_train_loader

    root = os.path.join(FIXTURE, "train")
    kw = dict(img_size=48, resize_size=32, batch_size=2, num_workers=1, emit="uint8")
    jl = jax_train_loader(root, process_id=0, process_count=1, **kw)
    pl = get_train_loader(root, **kw)
    assert len(pl) == len(jl) == 2
    for _ in range(2):
        for a, b in zip(pl, jl, strict=True):
            assert a["img_name"] == b["img_name"]
            for k in ("img_raw", "img_exp"):
                assert a[k].dtype == np.uint8
                np.testing.assert_array_equal(a[k], b[k])


def test_bridges_round_trip_discriminator_and_vgg(vgg, tmp_path):
    """numpy D state dict -> flax (import_discriminator) -> torch
    (discriminator_state_dict) gives back the same bits, which the port's D
    loads strictly; flax VGG params -> torch -> flax (import_vgg19) too."""
    d = Discriminator(conv_dim=DD)
    sd = fan_in_normal_state(d, seed=6)
    back = discriminator_state_dict(import_discriminator(sd, use_sn=True))
    assert sorted(back) == sorted(sd)
    for k, v in sd.items():
        assert np.array_equal(back[k].numpy(), v), k
    d.load_state_dict(back)
    _, params = vgg
    state = vgg_state_dict({"params": params})
    VGG19Features().load_torchvision(state)
    path = str(tmp_path / "vgg19.pth")
    torch.save(state, path)
    again = import_vgg19(path)["params"]
    assert sorted(again) == sorted(params)
    for name, _ in VGG19_CFG:
        for part in ("kernel", "bias"):
            assert np.array_equal(np.asarray(again[f"{name}_{part}"]),
                                  np.asarray(params[f"{name}_{part}"])), name


def test_refuse_grad_and_checkpoint_ambiguity(tmp_path):
    """The shared guard of kernels C-F raises where autograd would need their
    gradient; find_checkpoint raises where a .pth and an orbax directory of
    one epoch both exist."""
    from uegan_tpu_torch.config import Config
    from uegan_tpu_torch.utils.checkpoint import find_checkpoint

    t = torch.zeros(2, requires_grad=True)
    with pytest.raises(RuntimeError, match="no backward"):
        _build.refuse_grad("packed_conv", torch.zeros(2), t)
    with torch.no_grad():
        _build.refuse_grad("packed_conv", t)
    _build.refuse_grad("packed_conv", torch.zeros(2), None)

    cfg = Config()
    stem = tmp_path / "UEGAN-FiveK_rahinge_3"
    torch.save({"G_net": {}}, str(stem) + ".pth")
    assert find_checkpoint(str(tmp_path), cfg, 3) == str(stem) + ".pth"
    stem.mkdir()
    with pytest.raises(RuntimeError, match="orbax_to_pth.py --ckpt"):
        find_checkpoint(str(tmp_path), cfg, 3)


@pytest.mark.parametrize("flags", [{"fused_d": False}, {"split_g_adv": False}])
def test_fused_d_phases_equal_sequential_forwards(flags):
    """One step with the D phases fused (one forward over the branches, each
    scaled by its own iteration's sigma) equals the same step with the
    branches as sequential forwards, and the G update's D(exp), D(fake) as
    one fused forward equals the split default: losses, D's u/v and the
    parameters after the step."""
    from uegan_tpu_torch.config import Config
    from uegan_tpu_torch.train.state import create_train_state
    from uegan_tpu_torch.train.step import make_train_step

    rng = np.random.default_rng(22)
    raw, exp = (torch.from_numpy(rng.uniform(-1, 1, (2, 32, 32, 3)).astype(np.float32))
                for _ in range(2))
    out = []
    for kw in ({}, flags):
        cfg = Config(g_conv_dim=8, d_conv_dim=8, pool_size=4, compute_dtype="float32", **kw)
        state = create_train_state(cfg, "cpu", (32, 32), 1)
        for seed, m in enumerate((state.g, state.d, state.vgg)):
            m.load_state_dict({k: torch.from_numpy(v)
                               for k, v in fan_in_normal_state(m, seed).items()})
        metrics, _ = make_train_step(state)(raw, exp)
        out.append(({k: float(v) for k, v in metrics.items()},
                    {**state.g.state_dict(), **state.d.state_dict()}))
    for k, v in out[0][0].items():
        assert out[1][0][k] == pytest.approx(v, rel=1e-5), k
    for k, v in out[0][1].items():
        np.testing.assert_allclose(out[1][1][k].numpy(), v.numpy(), rtol=0, atol=1e-5, err_msg=k)
