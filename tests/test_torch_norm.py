"""PyTorch port, train-mode norm layers (``--g_norm_fun`` / ``--d_norm_fun``
BatchNorm or InstanceNorm): the norm_act pair's plain versions against
torch's own norms in float64, the port's train step against JAX's
``make_train_step`` (``packed_train=False``) and against the benchmark's
plain reference (``portbench/reference/norm_train.py``), and the launches
a step makes against the benchmark's count of them.

cd 8, dd 8, batch 2, float32, pool size 4 (both steps only fill the pool),
as tests/test_torch_train_step.py, but at 64 px on seeded uniform batches:
at 32 px D's last stages are 1 x 1 and 2 x 2, and a batch norm over two or
eight values turns f32 rounding into differences of 1e-4 in the
adversarial loss at step 1 and 1e-2 at step 2 between the packages (and
between two XLA builds of JAX's own step).  A norm layer's weight is drawn
as 1 + N(0, 0.1^2): the fan-in recipe's 0.1-scale weight would shrink every
normalized map tenfold.  JAX's two steps are built once a case, in a module
fixture.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from uegan_tpu.config import Config as JaxConfig
from uegan_tpu.convert.torch_import import import_discriminator, import_generator
from uegan_tpu.train.image_pool import pool_init
from uegan_tpu.train.schedules import make_optimizer as jax_make_optimizer
from uegan_tpu.train.state import ModelBundle, TrainState, build_models
from uegan_tpu.train.step import make_train_step as jax_make_train_step
from uegan_tpu_torch.config import Config
from uegan_tpu_torch.convert.from_flax import discriminator_state_dict, generator_state_dict
from uegan_tpu_torch.models.initializers import fan_in_normal_state
from uegan_tpu_torch.ops import norm_act
from uegan_tpu_torch.train.image_pool import ImagePool
from uegan_tpu_torch.train.schedules import make_optimizer
from uegan_tpu_torch.train.state import TrainState as PortState
from uegan_tpu_torch.train.state import build_models as port_models
from uegan_tpu_torch.train.step import make_train_step

from tests.test_torch_train import jax_vgg_params
from tests.test_torch_train_step import _check_metrics, _check_params

HW = 64
FLAGS = dict(g_conv_dim=8, d_conv_dim=8, image_size=96, resize_size=HW, train_batch_size=2,
             pool_size=4, compute_dtype="float32", packed_train=False)
NORMS = {"g_in_d_bn": ("InstanceNorm", "BatchNorm"), "g_bn_d_in": ("BatchNorm", "InstanceNorm")}
STATS = ("running_mean", "running_var")


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One torch thread while this file runs, restored after it."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ---------------------------------------------------------------------------
# the kernel pair's plain versions against torch's norms, float64


def _torch_norm(x, w, b, rm, rv, instance, slope):
    if instance:
        y = F.instance_norm(x, rm, rv, w, b, use_input_stats=True, momentum=0.1, eps=1e-5)
    else:
        y = F.batch_norm(x, rm, rv, w, b, training=True, momentum=0.1, eps=1e-5)
    return F.leaky_relu(y, slope)


@pytest.mark.parametrize("instance", [True, False], ids=["instance", "batch"])
@pytest.mark.parametrize("n, slope", [(1, 0.2), (3, 0.2), (3, 1.0)],
                         ids=["N1", "N3", "N3_no_act"])
def test_plain_pair_matches_torch_f64(instance, n, slope):
    """``plain`` (y, the running statistics) and ``plain_backward`` (dx,
    dweight, dbias) equal torch's instance / batch norm and LeakyReLU with
    autograd, in float64, within 1e-12 of their scale."""
    g = torch.Generator().manual_seed(7 + n)
    c = 5
    x = (torch.randn(n, c, 6, 4, generator=g, dtype=torch.float64) * 2 + 0.7).to(
        memory_format=torch.channels_last).requires_grad_(True)
    w = (1 + 0.3 * torch.randn(c, generator=g, dtype=torch.float64)).requires_grad_(True)
    b = (0.3 * torch.randn(c, generator=g, dtype=torch.float64)).requires_grad_(True)
    rm0, rv0 = 0.1 * torch.randn(c, generator=g, dtype=torch.float64), \
        1 + torch.rand(c, generator=g, dtype=torch.float64)
    dy = torch.randn(n, c, 6, 4, generator=g, dtype=torch.float64)

    rm, rv = rm0.clone(), rv0.clone()
    want = _torch_norm(x, w, b, rm, rv, instance, slope)
    want_dx, want_dw, want_db = torch.autograd.grad(want, (x, w, b), dy)

    got_rm, got_rv = rm0.clone(), rv0.clone()
    y, mean, var = norm_act.plain(x.detach(), w.detach(), b.detach(), got_rm, got_rv, instance,
                                  slope)
    dx, dw, db = norm_act.plain_backward(dy, x.detach(), w.detach(), b.detach(), mean, var,
                                         instance, slope)
    assert mean.shape == var.shape == ((n, c) if instance else (1, c))
    for name, a, e in (("y", y, want), ("running_mean", got_rm, rm), ("running_var", got_rv, rv),
                       ("dx", dx, want_dx), ("dweight", dw, want_dw), ("dbias", db, want_db)):
        np.testing.assert_allclose(a.detach().numpy(), e.detach().numpy(), rtol=1e-12,
                                   atol=1e-12, err_msg=name)


# ---------------------------------------------------------------------------
# the port's step against JAX's


def norm_state(model: torch.nn.Module, seed: int) -> dict:
    """``fan_in_normal_state`` with each norm layer's weight at 1 + N(0, 0.1^2)."""
    sd = fan_in_normal_state(model, seed)
    for k, v in sd.items():
        if (k.endswith(".main.2.weight") or k.endswith(".0.2.weight")) and v.ndim == 1:
            sd[k] = (1.0 + v).astype(np.float32)
    return sd


def _flags(case: str) -> dict:
    g_norm, d_norm = NORMS[case]
    return dict(FLAGS, g_norm_fun=g_norm, d_norm_fun=d_norm)


def _jax_steps(case: str, sds: dict, data: list) -> tuple:
    cfg = JaxConfig(**_flags(case))
    g_model, d_model, vgg_model = build_models(cfg)
    spe = 100
    g_tx = jax_make_optimizer("adam", cfg.g_lr, spe)
    d_tx = jax_make_optimizer("adam", cfg.d_lr, spe)
    bundle = ModelBundle(g_model, d_model, vgg_model, {"params": jax_vgg_params(sds["vgg"])},
                         g_tx, d_tx, cfg, spe)
    put = lambda tree: jax.tree_util.tree_map(jnp.asarray, tree)
    g_vars = put(import_generator(sds["g"]))
    d_vars = put(import_discriminator(sds["d"], use_sn=True))
    state = TrainState(step=jnp.zeros((), jnp.int32), g_params=g_vars["params"],
                       d_params=d_vars["params"],
                       g_extra={"batch_stats": g_vars["batch_stats"]},
                       d_extra={"spectral": d_vars["spectral"],
                                "batch_stats": d_vars["batch_stats"]},
                       g_opt=g_tx.init(g_vars["params"]), d_opt=d_tx.init(d_vars["params"]),
                       pool=pool_init(4, (HW, HW, 3)), rng=jax.random.PRNGKey(0), g_ema=None)
    step = jax.jit(jax_make_train_step(bundle))
    states, metrics = [], []
    for b in data:
        state, m, _ = step(state, jnp.asarray(b["img_raw"]), jnp.asarray(b["img_exp"]))
        host = jax.device_get(state)
        states.append((generator_state_dict({"params": host.g_params, **host.g_extra}),
                       discriminator_state_dict({"params": host.d_params, **host.d_extra})))
        metrics.append({k: float(v) for k, v in m.items()})
    return states, metrics


def _snapshot(model: torch.nn.Module) -> torch.nn.Module:
    import copy

    frozen = copy.deepcopy(model)
    for p, q in zip(model.parameters(), frozen.parameters()):
        q.grad = p.grad.clone()
    return frozen


def port_state(cfg: Config, weights: dict) -> PortState:
    """The port's train state on the CPU from state dicts (create_train_state's
    parts without its initialization, which the weights replace)."""
    g, d, vgg = port_models(cfg)
    for key, m in (("g", g), ("d", d), ("vgg", vgg)):
        m.load_state_dict({k: torch.as_tensor(v) for k, v in weights[key].items()})
    opts = [make_optimizer(m.parameters(), cfg.optimizer_type, lr, cfg.beta1, cfg.beta2,
                           cfg.weight_decay) for m, lr in ((g, cfg.g_lr), (d, cfg.d_lr))]
    pool = ImagePool(cfg.pool_size, (HW, HW, 3), "cpu", torch.Generator().manual_seed(1))
    return PortState(cfg, g, d, vgg, opts[0], opts[1], pool, steps_per_epoch=100)


def batches(seed: int) -> list:
    rng = np.random.default_rng(seed)
    return [{k: rng.uniform(-1, 1, (2, HW, HW, 3)).astype(np.float32)
             for k in ("img_raw", "img_exp")} for _ in range(2)]


@pytest.fixture(scope="module", params=sorted(NORMS))
def steps(request):
    """For one case: JAX's and the port's two steps from the same weights
    on the same batches: (cfg, JAX's state dicts and metrics after each
    step, the port's models after step 1 and 2 and its metrics)."""
    case = request.param
    cfg = Config(**_flags(case))
    g, d, vgg = port_models(cfg)
    sds = {"g": norm_state(g, 21), "d": norm_state(d, 22), "vgg": fan_in_normal_state(vgg, 23)}
    state = port_state(cfg, sds)
    data = batches(24)
    jstates, jmetrics = _jax_steps(case, sds, data)
    step = make_train_step(state)
    metrics, after = [], []
    for b in data:
        metrics.append(step(torch.from_numpy(b["img_raw"]), torch.from_numpy(b["img_exp"]))[0])
        after.append((_snapshot(state.g), _snapshot(state.d)))
    return cfg, jstates, jmetrics, after, metrics


def _check_stats(name: str, model: torch.nn.Module, want: dict, adam_steps: int,
                 lr: float) -> int:
    got = model.state_dict()
    keys = [k for k in want if k.endswith(STATS)]
    for k in keys:
        atol, rtol = stats_tol(k, adam_steps, lr)
        np.testing.assert_allclose(got[k].numpy(), want[k].numpy(), rtol=rtol, atol=atol,
                                   err_msg=f"{name} {k}")
    return len(keys)


def pre_norm_bias(name: str) -> bool:
    """A conv bias that a norm layer follows: the norm takes out each
    channel's mean, so its gradient is zero but for round-off."""
    return name.endswith(".main.1.bias") or (name.startswith("d") and name.endswith(".0.1.bias"))


def stats_tol(name: str, adam_steps: int, lr: float) -> tuple:
    """(atol, rtol) for a running statistic after forwards of which the
    last ran ``adam_steps`` Adam steps into training: (1e-5, 1e-5) before
    any; after, a running mean follows its conv's bias (``pre_norm_bias``),
    which Adam moved by round-off alone, by up to 2 lr a step in either
    package, so 1e-5 + 2 lr a step; a running variance, which no bias
    moves, takes the weights' own moves at cancelling gradients, rel 1e-4."""
    if not adam_steps:
        return 1e-5, 1e-5
    if name.endswith("running_mean"):
        return 1e-5 + 2 * lr * adam_steps, 1e-5
    return 1e-5, 1e-4


def test_norm_steps_match_jax(steps):
    """Two steps, each norm in G and the other in D: the five losses to rel
    1e-4 (test_torch_train_step.py's rule); G's and D's parameters after
    step 1 by its ``_check_params`` rule, with up to 2e-3 of them (not
    1e-4) where the step's gradient nearly cancels: a norm layer's input
    gradient has zero mean over each of its groups, and at 64 px the last
    stages normalize 4 to 16 values a group, so more of the gradients sum
    to round-off (each such element still within 2 lr), and
    the conv biases before a norm (``pre_norm_bias``), whose gradients are
    all round-off, held to that rule but not counted in the share; D's
    spectral-norm u and v after step 1 within 2 lr (8e-4), not 1e-5: step
    1's last power iterations run at the weights after Adam's step, which
    differ by up to 2 lr at such elements; every running mean and
    variance within ``stats_tol``."""
    cfg, jstates, jmetrics, after, metrics = steps
    for i, (pm, jm) in enumerate(zip(metrics, jmetrics)):
        _check_metrics(pm, jm, i + 1)
    (g1, d1), (want_g, want_d) = after[0], jstates[0]
    uv = ("weight_u", "weight_v")
    for name, model, want, lr in (("G", g1, want_g, cfg.g_lr), ("D", d1, want_d, cfg.d_lr)):
        want = {k: v for k, v in want.items() if not k.endswith(STATS + uv)}
        _check_params(name, model, {k: v for k, v in want.items() if not pre_norm_bias(k)},
                      lr, cfg.weight_decay, share=2e-3)
        _check_params(name, model, {k: v for k, v in want.items() if pre_norm_bias(k)},
                      lr, cfg.weight_decay, share=1.0)
    got_d = d1.state_dict()
    for k in [k for k in want_d if k.endswith(uv)]:
        assert float((got_d[k] - want_d[k]).abs().max()) <= 2 * cfg.d_lr, k
    # D's last forwards of step i run after its i-th Adam step, G's after its (i-1)-th
    for i, ((g, d), (want_g, want_d)) in enumerate(zip(after, jstates), 1):
        assert _check_stats("G", g, want_g, i - 1, cfg.g_lr) == 2 * 9
        assert _check_stats("D", d, want_d, i, cfg.d_lr) == 2 * 5


# ---------------------------------------------------------------------------
# the port's step against the benchmark's plain reference, and its launches


def test_norm_step_matches_the_plain_reference_and_counts():
    """Two steps of the cell's configuration (G instance norm, D batch norm)
    at cd 8, 64 px, batch 2 on the benchmark's seeded weights: the port
    (float32, plain versions) against portbench/reference/norm_train.py's
    ReferenceTrainer.  Losses rel 1e-4; every leaf after the steps within
    2 lr, and all but 1e-3 of the elements within 1e-5 (Adam's first step
    moves an element whose gradient nearly cancels by up to lr either way,
    as ``_check_params`` allows); the running statistics within
    ``stats_tol``.  The launches a step
    (``norm_act.launches``, ``norm_act_backward.launches``) equal
    portbench/counts/norm_layers.py's list at this size."""
    from portbench.counts import norm_layers
    from portbench.harness.weights import fan_in_weights
    from portbench.reference import nets, norm_nets
    from portbench.reference.norm_train import ReferenceTrainer

    cfg = Config(**_flags("g_in_d_bn"))
    gen = torch.Generator().manual_seed(5)
    weights = {net: norm_nets.seed_norm_layers(fan_in_weights(spec, gen, "cpu"))
               for net, spec in (("g", norm_nets.g_spec(8, "InstanceNorm")),
                                 ("d", norm_nets.d_spec(8, "BatchNorm")),
                                 ("vgg", nets.vgg_spec()))}
    state = port_state(cfg, weights)
    ref = ReferenceTrainer(weights["g"], weights["d"], weights["vgg"], (HW, HW), 4, 1,
                           g_norm="InstanceNorm", d_norm="BatchNorm")
    step = make_train_step(state)
    bufs = {**{f"G:{k}": b for k, b in state.g.named_buffers()},
            **{f"D:{k}": b for k, b in state.d.named_buffers()}}
    before = (norm_act.norm_act.launches, norm_act.norm_act_backward.launches)
    for i, b in enumerate(batches(6)):
        raw, exp = torch.from_numpy(b["img_raw"]), torch.from_numpy(b["img_exp"])
        got = step(raw, exp)[0]
        want = ref.step(raw, exp)
        for k, v in want.items():
            np.testing.assert_allclose(float(got[k]), float(v), rtol=1e-4, err_msg=k)
        stats = ref.running_stats()
        assert len(stats) == 2 * (9 + 5)
        for k, v in stats.items():
            g_net = k.startswith("G:")
            atol, rtol = stats_tol(k, i if g_net else i + 1, cfg.g_lr if g_net else cfg.d_lr)
            np.testing.assert_allclose(bufs[k].numpy(), v.numpy(), rtol=rtol, atol=atol,
                                       err_msg=f"{k} step {i + 1}")
    fwd, bwd = norm_layers.launches(cfg.g_conv_dim, cfg.d_conv_dim, HW, 2)
    assert (norm_act.norm_act.launches - before[0],
            norm_act.norm_act_backward.launches - before[1]) == (2 * len(fwd), 2 * len(bwd))
    assert (len(fwd), len(bwd)) == (43, 38)
    leaves = {**{f"G:{k}": p for k, p in state.g.named_parameters()},
              **{f"D:{k}": p for k, p in state.d.named_parameters()}}
    n_all = n_off = 0
    for k, v in ref.leaves().items():
        lr = cfg.g_lr if k.startswith("G:") else cfg.d_lr
        d = (leaves[k].detach() - v).abs()
        assert float(d.max()) <= 2 * lr, (k, float(d.max()))
        n_all += d.numel()
        n_off += int((d > 1e-5).sum())
    assert n_off <= 1e-3 * n_all, (n_off, n_all)
