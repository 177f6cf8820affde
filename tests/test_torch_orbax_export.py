"""orbax_to_pth.py: JAX orbax checkpoints to the reference .pth the port reads.

A training checkpoint at the verify fixture's widths (cd 8, dd 8, 32 px,
pool 4, with an EMA copy) and a NIMA checkpoint are written by the JAX
package's own savers, with every leaf drawn from a numpy seed (the real
init of G, D and VGG19 costs a minute on one core; the restore template is
the same either way), exported, and read back through JAX's own ``.pth``
importers: the trees must equal the orbax-restored ones bit for bit.
"""

import os
import re

import jax
import numpy as np
import orbax.checkpoint as ocp
import pytest
import torch

import orbax_to_pth
from uegan_tpu.config import Config as JaxConfig
from uegan_tpu.convert.torch_import import (import_discriminator, import_generator,
                                            import_nima, import_uegan_checkpoint)
from uegan_tpu.utils.checkpoint import CheckpointManager, restore_eval_state
from uegan_tpu_torch.config import Config
from uegan_tpu_torch.metrics.nima import init_nima
from uegan_tpu_torch.models.discriminator import Discriminator
from uegan_tpu_torch.models.generator import Generator
from uegan_tpu_torch.utils.checkpoint import find_checkpoint, load_pth

from tests.test_torch_train_step import run  # noqa: F401  (JAX's two steps, a fixture)

FLAGS = dict(g_conv_dim=8, d_conv_dim=8, resize_size=32, pool_size=4, g_ema_decay=0.999,
             checkpoint_async=False)


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One torch thread while this file runs (the suite runs several workers
    on a few cores), restored after it so other files keep their setting."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def seeded_tree(template, seed: int):
    """Numpy leaves of ``template``'s shapes and dtypes from one seed."""
    rng = np.random.default_rng(seed)

    def leaf(s):
        if np.issubdtype(s.dtype, np.floating):
            return rng.standard_normal(s.shape).astype(s.dtype)
        return rng.integers(1, 7, s.shape).astype(s.dtype)
    return jax.tree_util.tree_map(leaf, template)


def assert_trees_equal(got, want) -> None:
    g, gdef = jax.tree_util.tree_flatten(got)
    w, wdef = jax.tree_util.tree_flatten(want)
    assert gdef == wdef, (gdef, wdef)
    for a, b in zip(g, w):
        assert np.asarray(a).dtype == np.asarray(b).dtype
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


@pytest.fixture(scope="module")
def train_ckpt(tmp_path_factory):
    """(config, orbax directory of epoch 2 at step 8) with a distinct EMA copy."""
    cfg = JaxConfig(**FLAGS)
    state = seeded_tree(orbax_to_pth.train_state_template(cfg), seed=10)
    state = state.replace(step=np.int32(8),
                          g_ema=jax.tree_util.tree_map(lambda p: p + 0.01, state.g_params))
    root = tmp_path_factory.mktemp("jax_run")
    return cfg, CheckpointManager(str(root), cfg).save(state, 2)


def test_export_eval_weights_round_trip(train_ckpt, tmp_path):
    """--weights eval: G_net is the EMA copy (what the JAX Tester serves under
    ema_eval), D_net carries the SN kernels and u/v; JAX's importer gives
    the orbax-restored trees back bit for bit; no optimizer state; the
    epoch and the schedulers' state from the name and the step."""
    cfg, path = train_ckpt
    pth = orbax_to_pth.export_checkpoint(path, str(tmp_path))
    assert pth == str(tmp_path / "UEGAN-FiveK_rahinge_2.pth")
    want = jax.device_get(restore_eval_state(path, orbax_to_pth.train_state_template(cfg)))
    conv = import_uegan_checkpoint(pth)
    assert_trees_equal(conv["g_vars"]["params"], want.g_ema)
    assert_trees_equal(conv["g_vars"]["params"], want.g_params)  # the swap JAX's restore made
    assert_trees_equal(conv["d_vars"], {"params": want.d_params, **want.d_extra})
    ckpt = load_pth(pth)
    assert conv["epoch"] == ckpt["epoch"] == 2.0
    assert ckpt["g_optimizer"] == ckpt["d_optimizer"] == {}
    assert ckpt["lr_scheduler_g"] == {"last_epoch": 2, "base_lrs": [cfg.g_lr]}
    assert ckpt["lr_scheduler_d"] == {"last_epoch": 2, "base_lrs": [cfg.d_lr]}
    Generator(conv_dim=8).load_state_dict(ckpt["G_net"])
    Discriminator(conv_dim=8).load_state_dict(ckpt["D_net"])


def test_export_live_weights_and_adam_moments(train_ckpt, tmp_path):
    """--weights live: G_net the live weights; each optimizer's moments,
    by the port's parameter names, bit-equal to optax's mu/nu (read back
    through JAX's importer), step = count, the run's hyperparameters; and
    torch's Adam over the port's models takes both state dicts."""
    cfg, path = train_ckpt
    pth = orbax_to_pth.export_checkpoint(path, str(tmp_path / "live.pth"), weights="live")
    want = jax.device_get(restore_eval_state(path, orbax_to_pth.train_state_template(cfg),
                                             use_ema=False))
    conv = import_uegan_checkpoint(pth)
    assert_trees_equal(conv["g_vars"]["params"], want.g_params)
    assert_trees_equal(conv["d_vars"], {"params": want.d_params, **want.d_extra})
    ckpt = load_pth(pth)
    g, d = Generator(conv_dim=8), Discriminator(conv_dim=8)
    for key, model, lr, adam, importer in (
            ("g_optimizer", g, cfg.g_lr, want.g_opt[1],
             lambda sd: import_generator(sd)["params"]),
            ("d_optimizer", d, cfg.d_lr, want.d_opt[1],
             lambda sd: import_discriminator(
                 {k.replace("weight_orig", "weight"): v for k, v in sd.items()},
                 use_sn=False)["params"])):
        opt = ckpt[key]
        names = [n for n, _ in model.named_parameters()]
        assert sorted(opt["state"]) == list(range(len(names)))
        (group,) = opt["param_groups"]
        assert (group["lr"], tuple(group["betas"]), group["eps"], group["weight_decay"]) == (
            lr, (cfg.beta1, cfg.beta2), 1e-8, cfg.weight_decay)
        for slot, tree in (("exp_avg", adam.mu), ("exp_avg_sq", adam.nu)):
            by_name = {n: opt["state"][i][slot] for i, n in enumerate(names)}
            assert_trees_equal(importer(by_name), tree)
        assert all(float(s["step"]) == float(adam.count) for s in opt["state"].values())
        torch.optim.Adam(model.parameters()).load_state_dict(opt)


def test_export_live_carries_the_ema_and_a_resume_continues_it(run, tmp_path):
    """--weights live of a JAX run with ``g_ema_decay > 0`` writes JAX's
    ``g_ema`` as ``G_ema`` (by parameter name, bit-equal): JAX's state after
    step 1 of tests/test_torch_train_step.py's two steps, saved by its
    CheckpointManager and exported, resumes the port with JAX's average,
    not the live weights; the port's step 2 then equals JAX's (losses rel
    1e-4, parameters and the EMA by that file's rules)."""
    from uegan_tpu_torch.train.state import load_checkpoint
    from uegan_tpu_torch.train.step import make_train_step
    from uegan_tpu_torch.utils.checkpoint import EMA_KEY

    from tests.test_torch_train_step import (EMA_DECAY, _check_ema, _check_metrics,
                                             _check_params, _port_state, _want)
    from tests.test_torch_train_step import FLAGS as STEP_FLAGS

    batches, sds, jstates, jmetrics, jemas = run
    jcfg = JaxConfig(**STEP_FLAGS, g_ema_decay=EMA_DECAY, checkpoint_async=False)
    ckpt_dir = CheckpointManager(str(tmp_path / "jax"), jcfg).save(
        jstates[0].replace(g_ema=jemas[0]), 1 / len(batches))
    pth = orbax_to_pth.export_checkpoint(ckpt_dir, str(tmp_path / "port"), weights="live")
    ckpt = load_pth(pth)
    assert sorted(ckpt[EMA_KEY]) == sorted(n for n, _ in Generator(conv_dim=8).named_parameters())
    assert_trees_equal(import_generator(ckpt[EMA_KEY])["params"], jemas[0])
    assert_trees_equal(import_generator(ckpt["G_net"])["params"], jstates[0].g_params)

    cfg, state = _port_state(sds, len(batches), EMA_DECAY)
    load_checkpoint(state, ckpt)
    assert_trees_equal(import_generator({k: v.numpy() for k, v in state.g_ema.items()})["params"],
                       jemas[0])
    state.step = 1
    b = batches[1]
    pm, _ = make_train_step(state)(torch.from_numpy(b["img_raw"]), torch.from_numpy(b["img_exp"]))
    _check_metrics(pm, jmetrics[1], 2)
    want_g, want_d = _want(jstates[1])
    _check_params("G", state.g, want_g, cfg.g_lr, cfg.weight_decay)
    _check_params("D", state.d, want_d, cfg.d_lr, cfg.weight_decay)
    want_ema = orbax_to_pth.generator_state_dict({"params": jemas[1]})
    _check_ema(state.g_ema, {k: want_ema[k] for k in state.g_ema}, cfg.g_lr)


def test_export_sn_generator_live_and_eval(tmp_path):
    """A ``--g_use_sn true`` run: --weights live writes G's kernels as
    ``weight_orig`` with the ``spectral`` u and v, and its EMA by the same
    parameter names; --weights eval the EMA kernels beside the live u and
    v (JAX applies ``g_ema`` with ``g_extra``).  JAX's importer reads both
    back bit-equal, and the port's SN generator loads them strictly."""
    cfg = JaxConfig(**FLAGS, g_use_sn=True)
    state = seeded_tree(orbax_to_pth.train_state_template(cfg), seed=14)
    state = state.replace(step=np.int32(8),
                          g_ema=jax.tree_util.tree_map(lambda p: p + 0.01, state.g_params))
    path = CheckpointManager(str(tmp_path / "jax_sn"), cfg).save(state, 2)
    want = jax.device_get(restore_eval_state(path, orbax_to_pth.train_state_template(cfg),
                                             use_ema=False))
    assert "spectral" in want.g_extra
    g = Generator(conv_dim=8, use_sn=True)
    for weights, params in (("live", want.g_params), ("eval", want.g_ema)):
        ckpt = load_pth(orbax_to_pth.export_checkpoint(path, str(tmp_path / f"{weights}.pth"),
                                                       weights=weights))
        assert_trees_equal(import_generator(ckpt["G_net"], use_sn=True),
                           {"params": params, **want.g_extra})
        g.load_state_dict(ckpt["G_net"], strict=True)
        if weights == "live":  # parameters only: the SN kernels as weight_orig
            ema = ckpt["G_ema"]
            assert sorted(ema) == sorted(n for n, _ in g.named_parameters())
            assert_trees_equal(import_generator(
                {k.replace("weight_orig", "weight"): v for k, v in ema.items()})["params"],
                want.g_ema)
        else:
            assert "G_ema" not in ckpt


def test_export_nima_round_trip(tmp_path):
    """--nima: JAX's orbax nima_best ({params, batch_stats}) -> the reference
    NIMA .pth, read back bit-equal by JAX's import_nima and loaded by the
    port's init_nima."""
    from uegan_tpu.models.nima import NIMA

    template = jax.eval_shape(lambda k: NIMA().init(k, jax.numpy.zeros((1, 224, 224, 3))),
                              jax.random.PRNGKey(0))
    variables = seeded_tree(template, seed=11)
    src = str(tmp_path / "exp" / "nima_best")
    ckptr = ocp.StandardCheckpointer()
    ckptr.save(src, variables)
    ckptr.wait_until_finished()
    pth = orbax_to_pth.export_nima(src, str(tmp_path / "exported"))
    assert pth == str(tmp_path / "exported" / "nima_best.pth")
    assert_trees_equal(import_nima(pth), dict(variables))
    model = init_nima(pth, device="cpu")
    np.testing.assert_array_equal(model.head[2].bias.detach().numpy(),
                                  np.asarray(variables["params"]["fc"]["bias"]))


def test_export_refusals_and_the_port_names_the_script(train_ckpt, tmp_path):
    """The script refuses a .pth beside its own orbax directory; the port's
    find_checkpoint (orbax alone, or beside a .pth) and nima validate-model
    name the export command (the server's refusal: tests/test_torch_serve.py)."""
    from uegan_tpu_torch.nima_train import cli as nima_cli

    _, path = train_ckpt
    for out in (os.path.dirname(path), path + ".pth"):
        with pytest.raises(ValueError, match="beside its own orbax directory"):
            orbax_to_pth.export_checkpoint(path, out)
    cfg = Config()
    models = str(tmp_path)
    stem = tmp_path / "UEGAN-FiveK_rahinge_3"
    stem.mkdir()
    command = re.escape(f"python orbax_to_pth.py --ckpt {stem} ")
    with pytest.raises(NotImplementedError, match=command):
        find_checkpoint(models, cfg, 3)
    torch.save({"G_net": {}}, str(stem) + ".pth")
    with pytest.raises(RuntimeError, match="orbax_to_pth.py --ckpt"):
        find_checkpoint(models, cfg, 3)
    with pytest.raises(NotImplementedError, match=re.escape(f"orbax_to_pth.py --nima {stem} ")):
        nima_cli.main(["validate-model", "--path_to_model_weight", str(stem),
                       "--path_to_save_csv", models])
