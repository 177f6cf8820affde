"""PyTorch port, NIMA: the MobileNetV2 scorer against the JAX package's
``uegan_tpu.models.nima.NIMA`` on bridged weights, its weight paths (the
reference ``.pth`` both ways and the flax tree), and the small pieces the
slice adds (global average pool, dropout, score statistics, the auxiliary
losses, the batched PSNR and SSIM with a border crop).

MobileNetV2's widths are fixed, so the forward is cut only spatially: B = 2
at 32 and 64 px.  Weights are made with numpy or from the port's seeded
init, and the BN running statistics are made non-trivial (mean U(-0.2,
0.2), var U(0.5, 1.5)) so that the eval semantics are exercised.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from uegan_tpu.convert.torch_import import import_nima
from uegan_tpu.losses import extra as jax_extra
from uegan_tpu.metrics.psnr import psnr_batch as jax_psnr_batch
from uegan_tpu.metrics.ssim import ssim_batch as jax_ssim_batch
from uegan_tpu.models.nima import NIMA as JaxNIMA
from uegan_tpu.models.nima import score_stats as jax_score_stats
from uegan_tpu.ops.pooling import avg_pool as jax_avg_pool
from uegan_tpu_torch.convert.from_flax import nima_state_dict
from uegan_tpu_torch.losses import extra
from uegan_tpu_torch.metrics.psnr import psnr_batch
from uegan_tpu_torch.metrics.ssim import ssim_batch
from uegan_tpu_torch.models.nima import (NIMA, TRUNC_STD, dropout, load_nima_pth, save_nima_pth,
                                         score_stats)
from uegan_tpu_torch.ops.conv import exact_f32
from uegan_tpu_torch.ops.pooling import avg_pool

BUCKETS = np.arange(1, 11, dtype=np.float64)


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One torch thread while this file runs (the suite runs several workers
    on a few cores), restored after it so other files keep their setting."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def nima_weights(seed: int, he: bool = True) -> NIMA:
    """A float32 NIMA in eval mode: the port's seeded init (the JAX init's
    distributions) when ``he``, else numpy N(0, 1/fan_in) kernels; BN
    running statistics non-trivial, from numpy."""
    m = NIMA().seed(torch.Generator().manual_seed(seed)).eval()
    rng = np.random.default_rng(seed)
    with torch.no_grad():
        for name, t in m.state_dict().items():
            if name.endswith("running_mean"):
                t.copy_(torch.from_numpy(rng.uniform(-0.2, 0.2, t.shape).astype(np.float32)))
            elif name.endswith("running_var"):
                t.copy_(torch.from_numpy(rng.uniform(0.5, 1.5, t.shape).astype(np.float32)))
            elif not he and name.endswith("weight") and t.ndim > 1:
                w = rng.standard_normal(t.shape) / np.sqrt(t[0].numel())
                t.copy_(torch.from_numpy(w.astype(np.float32)))
    return m


@pytest.mark.parametrize("hw", [32, 64])
def test_forward_f32_matches_jax(hw, tmp_path):
    """f32, the port's seeded weights through the reference .pth into JAX's
    import_nima: probabilities within 2e-5 (tests/test_reference_oracle.py's
    bound), mean and std within 1e-4."""
    m = nima_weights(seed=hw)
    variables = import_nima(save_nima_pth(m, str(tmp_path / "nima.pth")))
    x = np.random.default_rng(hw + 1).uniform(0.0, 1.0, (2, hw, hw, 3)).astype(np.float32)
    want = np.asarray(jax.jit(lambda b: JaxNIMA().apply(variables, b))(x))
    with torch.no_grad():
        got = m(torch.from_numpy(x))
    assert got.dtype == torch.float32 and got.shape == (2, 10)
    np.testing.assert_allclose(got.numpy(), want, atol=2e-5, rtol=0)
    assert want.max() > 0.2  # the seeded weights give peaked distributions, not uniform ones
    mean, std = score_stats(got)
    jmean, jstd = jax_score_stats(jnp.asarray(want))
    np.testing.assert_allclose(mean.numpy(), np.asarray(jmean), atol=1e-4, rtol=0)
    np.testing.assert_allclose(std.numpy(), np.asarray(jstd), atol=1e-4, rtol=0)


@pytest.mark.parametrize("hw", [32, 64])
def test_forward_bf16_matches_jax_bf16(hw, tmp_path):
    """bf16 convs, f32 BN and softmax on both sides, N(0, 1/fan_in) kernels:
    mean score within 0.005 of JAX in bf16 (measured 6.9e-4 and 1.1e-3; JAX's
    own bf16-vs-f32 bound is 0.3, tests/test_metrics.py), and the port's bf16
    differs from its f32 (it did run bf16).  The He-scaled seeded weights make
    the random net chaotic in bf16, so they would test rounding luck."""
    m = nima_weights(seed=7 + hw, he=False)
    variables = import_nima(save_nima_pth(m, str(tmp_path / "nima.pth")))
    x = np.random.default_rng(hw).uniform(0.0, 1.0, (2, hw, hw, 3)).astype(np.float32)
    want = np.asarray(jax.jit(lambda b: JaxNIMA(dtype=jnp.bfloat16).apply(variables, b))(x))
    m16 = NIMA(dtype=torch.bfloat16).load_reference(m.state_dict()).eval()
    with torch.no_grad():
        got = m16(torch.from_numpy(x))
        f32 = m(torch.from_numpy(x))
    assert got.dtype == torch.float32
    d = np.abs(got.numpy() @ BUCKETS - want @ BUCKETS).max()
    assert d <= 5e-3, d
    assert float((got - f32).abs().max()) > 0


def test_score_stats_matches_jax():
    p = np.random.default_rng(3).dirichlet(np.ones(10), size=5).astype(np.float32)
    mean, std = score_stats(torch.from_numpy(p))
    jmean, jstd = jax_score_stats(jnp.asarray(p))
    np.testing.assert_allclose(mean.numpy(), np.asarray(jmean), rtol=1e-6)
    np.testing.assert_allclose(std.numpy(), np.asarray(jstd), rtol=1e-6)
    mean, std = score_stats(torch.tensor([[0.0] * 9 + [1.0], [1.0] + [0.0] * 9]))
    assert mean.tolist() == [10.0, 1.0] and std.tolist() == [0.0, 0.0]


def test_pth_round_trip_is_bit_equal(tmp_path):
    """port -> .pth -> JAX import_nima -> nima_state_dict -> port is
    bit-equal; the .pth holds the reference's names (with BN's
    num_batches_tracked, which the loader also does without) and loads when
    wrapped under ``state_dict``."""
    m = nima_weights(seed=5)
    path = save_nima_pth(m, str(tmp_path / "nima.pth"))
    sd = load_nima_pth(path)
    assert "base_model.0.0.0.weight" in sd and "base_model.0.17.conv.7.running_var" in sd
    assert "base_model.0.18.1.num_batches_tracked" in sd and sd["head.2.weight"].shape == (10, 1280)
    back = NIMA().load_reference(nima_state_dict(import_nima(path)))
    want = {k: v for k, v in m.state_dict().items() if not k.endswith("num_batches_tracked")}
    got = back.state_dict()
    for k, v in want.items():
        assert torch.equal(got[k], v), k
    wrapped = str(tmp_path / "wrapped.pth")
    torch.save({"state_dict": want}, wrapped)
    again = NIMA().load_reference(load_nima_pth(wrapped)).state_dict()
    assert all(torch.equal(again[k], v) for k, v in want.items())
    with pytest.raises(KeyError, match="not a NIMA state dict"):
        NIMA().load_reference({k: v for k, v in want.items() if not k.startswith("head")})


def test_seeded_init_follows_jax_distributions():
    """he_normal / lecun_normal truncated at two standard deviations of the
    untruncated normal, zero linear bias, BN at identity; seeded draws
    repeat."""
    a = NIMA().seed(torch.Generator().manual_seed(0))
    b = NIMA().seed(torch.Generator().manual_seed(0))
    assert all(torch.equal(x, y) for x, y in zip(a.state_dict().values(), b.state_dict().values()))
    w = a.base_model[0][6].conv[0].weight.detach()  # a 1x1 pw conv, fan_in 32
    scale = np.sqrt(2.0 / 32) / TRUNC_STD
    assert float(w.abs().max()) <= 2 * scale
    assert abs(float(w.std()) - np.sqrt(2.0 / 32)) < 0.05 * np.sqrt(2.0 / 32)
    fc_w, fc_b = a.head[2].weight.detach(), a.head[2].bias.detach()
    assert float(fc_w.abs().max()) <= 2 * np.sqrt(1.0 / 1280) / TRUNC_STD
    assert float(fc_b.abs().max()) == 0.0
    bn = a.base_model[0][0][1]
    assert bool((bn.weight == 1).all() and (bn.bias == 0).all())
    assert bool((bn.running_mean == 0).all() and (bn.running_var == 1).all())


def test_f32_forward_restores_tf32_flags():
    """The f32 forward turns TF32 off for its convs and matmuls and restores
    the process's flags afterwards; bf16 leaves them alone."""
    saved = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
    try:
        torch.backends.cudnn.allow_tf32 = True
        torch.backends.cuda.matmul.allow_tf32 = True
        with exact_f32(torch.float32):
            assert not torch.backends.cudnn.allow_tf32
            assert not torch.backends.cuda.matmul.allow_tf32
        with exact_f32(torch.bfloat16):
            assert torch.backends.cudnn.allow_tf32 and torch.backends.cuda.matmul.allow_tf32
        with torch.no_grad():
            NIMA().eval()(torch.zeros(1, 32, 32, 3))
        assert torch.backends.cudnn.allow_tf32 and torch.backends.cuda.matmul.allow_tf32
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = saved


@pytest.mark.parametrize("dtype", [np.float32, jnp.bfloat16])
def test_avg_pool_matches_jax(dtype):
    x = np.random.default_rng(2).standard_normal((2, 7, 7, 5)).astype(np.float32)
    jx = jnp.asarray(x, dtype)
    want = np.asarray(jax_avg_pool(jx, 7, 7).astype(jnp.float32))
    tx = torch.from_numpy(np.array(jx.astype(jnp.float32))).to(
        torch.float32 if dtype == np.float32 else torch.bfloat16)
    got = avg_pool(tx, 7, 7)
    assert got.dtype == tx.dtype and got.shape == (2, 1, 1, 5)
    np.testing.assert_allclose(got.float().numpy(), want, rtol=1e-6, atol=1e-7)


def test_dropout_keeps_a_quarter_scaled_by_four():
    """NIMA's dropout at rate 0.75: keep share near 0.25, kept values x4,
    the rest 0; the same generator seed draws the same mask."""
    h = torch.rand(64, 1280) + 0.5
    out = dropout(h, 0.75, torch.Generator().manual_seed(1))
    kept = out != 0
    assert abs(float(kept.float().mean()) - 0.25) < 0.01
    assert torch.equal(out[kept], h[kept] * 4.0)
    assert torch.equal(out, dropout(h, 0.75, torch.Generator().manual_seed(1)))
    assert NIMA().dropout_rate == 0.75


def test_extra_losses_match_jax():
    """emd_loss, tv_loss and angular_loss against JAX within 1e-6."""
    rng = np.random.default_rng(4)
    pt = rng.dirichlet(np.ones(10), size=6).astype(np.float32)
    pp = rng.dirichlet(np.ones(10), size=6).astype(np.float32)
    np.testing.assert_allclose(float(extra.emd_loss(torch.from_numpy(pt), torch.from_numpy(pp))),
                               float(jax_extra.emd_loss(jnp.asarray(pt), jnp.asarray(pp))),
                               atol=1e-6, rtol=0)
    x = rng.standard_normal((2, 9, 7, 3)).astype(np.float32)
    y = rng.standard_normal((2, 9, 7, 3)).astype(np.float32)
    np.testing.assert_allclose(float(extra.tv_loss(torch.from_numpy(x), 0.5)),
                               float(jax_extra.tv_loss(jnp.asarray(x), 0.5)), atol=1e-6, rtol=1e-6)
    np.testing.assert_allclose(
        float(extra.angular_loss(torch.from_numpy(x), torch.from_numpy(y))),
        float(jax_extra.angular_loss(jnp.asarray(x), jnp.asarray(y))), atol=1e-6, rtol=1e-6)
    z = np.zeros_like(x)  # a zero vector: the cosine's denominator clamps
    assert np.isfinite(float(extra.angular_loss(torch.from_numpy(z), torch.from_numpy(y))))


def test_psnr_and_ssim_batch_with_crop_match_jax():
    """The on-device validation metrics: psnr_batch and ssim_batch with
    crop_border=4 on the 255 scale against JAX's, 1e-4 dB and 1e-6; an
    exact match clamps the MSE at 1e-12."""
    rng = np.random.default_rng(9)
    a = (rng.random((2, 32, 32, 3)) * 255).astype(np.float32)
    b = np.clip(a + rng.normal(0, 9, a.shape), 0, 255).astype(np.float32)
    got = psnr_batch(torch.from_numpy(a), torch.from_numpy(b), crop_border=4).numpy()
    want = np.asarray(jax_psnr_batch(jnp.asarray(a), jnp.asarray(b), crop_border=4))
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)
    got = ssim_batch(torch.from_numpy(a), torch.from_numpy(b), crop_border=4).numpy()
    want = np.asarray(jax_ssim_batch(jnp.asarray(a), jnp.asarray(b), crop_border=4))
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)
    same = psnr_batch(torch.from_numpy(a), torch.from_numpy(a)).numpy()
    np.testing.assert_allclose(same, 10 * np.log10(255.0 ** 2 / 1e-12), rtol=1e-6)
