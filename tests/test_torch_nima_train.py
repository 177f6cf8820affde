"""PyTorch port, NIMA training: the AVA dataset (files, splits and batches
bit-equal to the JAX package's), one EMD train step in f32 against JAX's
``make_nima_train_step`` on bridged weights (flax BatchNorm semantics: the
biased batch variance, momentum 0.9; optax.adam), and the NIMA training
CLI: ``train_nima`` one epoch on the CPU, its ``nima_best.pth`` read by JAX's
``import_nima``, and ``validate-model`` / ``get-image-score`` against JAX's.
The AVA fixture is made in the test, as tests/test_nima_train.py does.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from PIL import Image

from uegan_tpu.convert.torch_import import import_nima
from uegan_tpu.losses.extra import emd_loss as jax_emd_loss
from uegan_tpu.models.nima import NIMA as JaxNIMA
from uegan_tpu.nima_train import cli as jax_cli
from uegan_tpu.nima_train.dataset import AVADataset as JaxAVADataset
from uegan_tpu.nima_train.dataset import clean_and_split as jax_clean_and_split
from uegan_tpu.nima_train.train import make_nima_train_step as jax_make_nima_train_step
from uegan_tpu_torch.convert.from_flax import nima_state_dict
from uegan_tpu_torch.losses.extra import emd_loss
from uegan_tpu_torch.models.nima import NIMA, load_nima_pth, save_nima_pth
from uegan_tpu_torch.nima_train import cli
from uegan_tpu_torch.nima_train.dataset import AVADataset, clean_and_split, parse_ava_txt
from uegan_tpu_torch.nima_train.train import make_nima_train_step, train_nima

from tests.test_torch_nima import nima_weights


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One torch thread while this file runs (the suite runs several workers
    on a few cores), restored after it so other files keep their setting."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def ava_fixture(tmp_path_factory):
    """12 AVA rows, 11 JPEGs of 48x64 (one image missing, for the cleaning)."""
    root = tmp_path_factory.mktemp("ava")
    img_dir = root / "images"
    img_dir.mkdir()
    rng = np.random.default_rng(3)
    lines = []
    for i in range(12):
        img_id = f"{1000 + i}"
        if i != 11:
            arr = (rng.random((48, 64, 3)) * 255).astype(np.uint8)
            Image.fromarray(arr).save(img_dir / f"{img_id}.jpg")
        counts = rng.integers(0, 50, 10)
        lines.append(f"{i} {img_id} " + " ".join(map(str, counts)) + " 1 22 1396")
    ava_txt = root / "AVA.txt"
    ava_txt.write_text("\n".join(lines))
    return str(ava_txt), str(img_dir), root


def test_ava_splits_and_batches_bit_equal_to_jax(ava_fixture):
    """The same three CSVs (the missing image dropped), and for a seed the
    same train batches (random crop and flip, two epochs) and val batches
    (resize 256, centre crop 224) as the JAX dataset."""
    ava_txt, img_dir, root = ava_fixture
    assert len(parse_ava_txt(ava_txt)) == 12
    ours = clean_and_split(ava_txt, img_dir, str(root / "port"), val_frac=0.2, test_frac=0.1)
    theirs = jax_clean_and_split(ava_txt, img_dir, str(root / "jax"), val_frac=0.2,
                                 test_frac=0.1)
    for a, b in zip(ours, theirs):
        assert open(a).read() == open(b).read()
    assert sum(len(AVADataset(p).rows) for p in ours) == 11
    for train, size, epochs in ((True, 32, (0, 1)), (False, 224, (0,))):
        csv = ours[0] if train else ours[1]
        ds, jds = AVADataset(csv, train=train, size=size), JaxAVADataset(csv, train=train, size=size)
        for epoch in epochs:
            got, want = list(ds.batches(2, epoch=epoch)), list(jds.batches(2, epoch=epoch))
            assert len(got) == len(want) > 0
            for (gi, gt), (wi, wt) in zip(got, want):
                assert gi.shape == (2, size, size, 3) and gi.dtype == np.float32
                assert np.array_equal(gi, wi) and np.array_equal(gt, wt)


def test_train_step_f32_matches_jax(tmp_path):
    """One EMD step, f32, B = 4 at 128 px, dropout_rate 0 on both sides: the
    loss within rel 1e-5; the new running means and variances within rel
    1e-5 but for at most 0.2% of them (within 1e-4); the new parameters
    equal to optax.adam's update of the port's own gradients (2 ulp); the
    gradients within 5e-2 of JAX's in relative L2; and the parameters within
    1e-5 of JAX's but where Adam's first step divides a gradient under 1e-6
    or one the two f32 backward passes differ on by over 10%.

    128 px, not 32: at 32 px the last seven stages see 1x1 maps, so their
    training-mode BatchNorm normalizes 4 values a channel, and f32 rounding
    there is amplified, in JAX as in the port, past rel 1e-5 between the two
    losses; with 4x4 maps (64 values) they agree within it."""
    m = nima_weights(seed=11)
    variables = import_nima(save_nima_pth(m, str(tmp_path / "nima.pth")))
    rng = np.random.default_rng(12)
    x = rng.uniform(0.0, 1.0, (4, 128, 128, 3)).astype(np.float32)
    t = rng.dirichlet(np.ones(10), size=4).astype(np.float32)
    lr = 3e-4

    jmodel = JaxNIMA(dropout_rate=0.0)
    tx = optax.adam(lr)
    params, stats = variables["params"], variables["batch_stats"]
    jstep = jax.jit(jax_make_nima_train_step(jmodel, tx))
    jparams, jstats, _, jloss = jstep(params, stats, tx.init(params), jax.random.PRNGKey(0),
                                      jnp.asarray(x), jnp.asarray(t))

    model = NIMA(dropout_rate=0.0).load_reference(m.state_dict())
    opt = torch.optim.Adam(model.parameters(), lr=lr, eps=1e-8)
    loss = make_nima_train_step(model, opt)(torch.from_numpy(x), torch.from_numpy(t))
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)

    want = nima_state_dict({"params": jax.device_get(jparams),
                            "batch_stats": jax.device_get(jstats)})
    got = model.state_dict()
    stat_keys = [k for k in want if k.endswith(("running_mean", "running_var"))]
    assert len(stat_keys) == 2 * 53  # stem, 17 blocks x 3, head conv
    # running statistics: relative to |value| + the tensor's largest |value|
    # (a channel's mean may cancel to ~0); flax's E[y^2] - E[y]^2 cancels in
    # f32 where a channel's mean is large against its spread, so a few
    # elements (measured: 41 of 34,176, at most 1.62e-5) may pass 1e-5
    n_all = n_off = 0
    for k in stat_keys:
        w = want[k].numpy()
        rel = np.abs(got[k].numpy() - w) / (np.abs(w) + np.abs(w).max())
        assert float(rel.max()) <= 1e-4, (k, float(rel.max()))
        n_all += rel.size
        n_off += int((rel > 1e-5).sum())
        assert not torch.equal(got[k], m.state_dict()[k]), k  # the step moved it
    assert n_off <= 2e-3 * n_all, (n_off, n_all)
    # the optimizer: optax.adam's first update applied to the port's own
    # gradients gives the port's new parameters
    grads = {k: p.grad for k, p in model.named_parameters()}
    torch.save({**nima_state_dict(variables), **grads}, str(tmp_path / "grads.pth"))
    flax_grads = import_nima(str(tmp_path / "grads.pth"))["params"]
    updates, _ = tx.update(flax_grads, tx.init(params), params)
    stepped = nima_state_dict({"params": jax.device_get(optax.apply_updates(params, updates)),
                               "batch_stats": variables["batch_stats"]})
    for k in grads:
        np.testing.assert_allclose(got[k].numpy(), stepped[k].numpy(), atol=1e-7, rtol=2.4e-7,
                                   err_msg=k)

    # the gradients against JAX's (jax.grad of the step's own loss)
    def loss_fn(p):
        probs, _ = jmodel.apply({"params": p, "batch_stats": stats}, jnp.asarray(x), train=True,
                                mutable=["batch_stats"], rngs={"dropout": jax.random.PRNGKey(0)})
        return jax_emd_loss(jnp.asarray(t), probs)

    jgrads = nima_state_dict({"params": jax.device_get(jax.jit(jax.grad(loss_fn))(params)),
                              "batch_stats": variables["batch_stats"]})
    # the same step's gradients in float64 (the port run in f64): f32
    # backward passes through 53 training-mode BatchNorms at B = 4 are
    # ill-conditioned, so the gradients are compared in L2 (measured: port
    # against JAX 2.6e-2, port f32 against f64 8.6e-3)
    m64 = NIMA(dtype=torch.float64, dropout_rate=0.0).load_reference(m.state_dict()).double()
    m64.train()
    emd_loss(torch.from_numpy(t).double(), m64(torch.from_numpy(x).double())).backward()
    grads64 = {k: p.grad for k, p in m64.named_parameters()}

    def rel_l2(a, b):
        num = sum(float(((a[k].double() - b[k].double()) ** 2).sum()) for k in grads)
        return (num / sum(float((b[k].double() ** 2).sum()) for k in grads)) ** 0.5

    assert rel_l2(grads, jgrads) <= 5e-2
    assert rel_l2(grads, grads64) <= 2e-2
    # the new parameters: within 1e-5 of JAX's but where Adam's first step,
    # lr * g / (|g| + 1e-8), divides a gradient under 1e-6 or one the two
    # backward passes do not agree on to 10%; those move by at most 2 lr
    n_all = n_off = 0
    for k in grads:
        d = (got[k] - want[k]).abs()
        unsure = ((grads[k].abs() < 1e-6)
                  | ((grads[k] - jgrads[k]).abs() > 0.1 * jgrads[k].abs()))
        off = d > 1e-5
        assert bool((unsure | ~off).all()), (k, float(d[~unsure].max()))
        assert float(d.max()) <= 2 * lr + 1e-6, (k, float(d.max()))  # + rounding at |p| ~ 1
        n_all += d.numel()
        n_off += int(off.sum())
    assert n_off <= 1e-2 * n_all, (n_off, n_all)  # measured 11,593 of 2,237,770


def _tiny_load(self, index, epoch=0):
    rng = np.random.default_rng(index)
    return rng.random((32, 32, 3)).astype(np.float32), self.rows[index][1]


def test_train_cli_then_jax_reads_the_pth(ava_fixture, tmp_path, monkeypatch, capsys):
    """``train_nima`` one epoch on the CPU (32 px loads, as JAX's own test
    does) writes ``nima_best.pth``, which JAX's import_nima reads to the
    same probabilities; the CLI's prepare-dataset, validate-model and
    get-image-score on that .pth print what JAX's do (1e-4); an orbax
    directory is refused."""
    import uegan_tpu_torch.nima_train.dataset as ds_mod

    monkeypatch.setenv("UEGAN_TORCH_DEVICE", "cpu")
    ava_txt, img_dir, _ = ava_fixture
    splits = str(tmp_path / "splits")
    cli.main(["prepare-dataset", "--path_to_ava_txt", ava_txt, "--path_to_save_csv", splits,
              "--path_to_images", img_dir, "--val_frac", "0.3", "--test_frac", "0.0"])
    assert sorted(os.listdir(splits)) == ["test.csv", "train.csv", "val.csv"]
    with monkeypatch.context() as mp:
        mp.setattr(ds_mod.AVADataset, "load", _tiny_load)
        hist = train_nima(os.path.join(splits, "train.csv"), os.path.join(splits, "val.csv"),
                          str(tmp_path / "out"), epochs=1, batch_size=4, verbose=True,
                          device="cpu")
    assert np.isfinite(hist["best_val"]) and hist["epoch0"] == hist["best_val"]
    assert "[nima] epoch 0: train EMD" in capsys.readouterr().out
    pth = str(tmp_path / "out" / "nima_best.pth")
    variables = import_nima(pth)
    x = np.random.default_rng(1).uniform(0.0, 1.0, (2, 32, 32, 3)).astype(np.float32)
    want = np.asarray(jax.jit(lambda b: JaxNIMA().apply(variables, b))(x))
    with torch.no_grad():
        got = NIMA().load_reference(load_nima_pth(pth)).eval()(torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), want, atol=2e-5, rtol=0)

    img = os.path.join(img_dir, "1000.jpg")
    printed = {}
    for name, main in (("port", cli.main), ("jax", jax_cli.main)):
        capsys.readouterr()
        main(["validate-model", "--path_to_model_weight", pth, "--path_to_save_csv", splits])
        main(["get-image-score", "--path_to_model_weight", pth, "--path_to_image", img])
        printed[name] = capsys.readouterr().out.split()
    port, jx = printed["port"], printed["jax"]
    assert port[:2] == jx[:2] == ["val", "EMD:"] and port[3] == jx[3] == "mean:"
    for i in (2, 4, 6):
        np.testing.assert_allclose(float(port[i]), float(jx[i]), atol=1e-4)
    with pytest.raises(NotImplementedError, match="orbax_to_pth.py --nima"):
        cli.main(["validate-model", "--path_to_model_weight", str(tmp_path / "out"),
                  "--path_to_save_csv", splits])
