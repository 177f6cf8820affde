"""PyTorch port: ``infer/packed.py:served_generator``, the one builder of the
generator that the Tester, the service and the exporter serve.

- no file: the Tester's seeded init, bit-equal, with spectral norm exactly
  under ``--g_use_sn``;
- a plain ``.pth``: its weights, no spectral norm;
- a ``--g_use_sn`` ``.pth``: spectral norm from the file alone, its
  ``weight_u`` and ``weight_v`` carried over;
- a ``.pth`` with an EMA copy of G: the EMA weights under ``ema_eval``.
"""

import dataclasses

import pytest
import torch

from uegan_tpu_torch.config import Config
from uegan_tpu_torch.infer.packed import served_generator
from uegan_tpu_torch.models.blocks import SpectralConv2d
from uegan_tpu_torch.models.generator import Generator
from uegan_tpu_torch.models.initializers import init_weights
from uegan_tpu_torch.utils.checkpoint import generator_state, load_pth, save_pth
from uegan_tpu_torch.utils.seed import setup_seed

CFG = Config(g_conv_dim=8, compute_dtype="float32")
CPU = torch.device("cpu")


def _trained(use_sn: bool) -> Generator:
    """A G unlike the seeded one: another seed, and every parameter moved."""
    g = init_weights(Generator(conv_dim=8, use_sn=use_sn), CFG.init_type, 0.02,
                     torch.Generator().manual_seed(7))
    with torch.no_grad():
        for p in g.parameters():
            p.add_(0.25)
    return g


def _sn_convs(g):
    return [m for m in g.modules() if isinstance(m, SpectralConv2d) and m.use_sn]


def _assert_state(g, want):
    got = g.state_dict()
    assert got.keys() == want.keys()
    for k, v in want.items():
        assert torch.equal(got[k], v), k


@pytest.mark.parametrize("source", ["none", "plain", "sn", "ema"])
def test_served_generator(tmp_path, source):
    if source == "none":
        for use_sn in (False, True):
            cfg = dataclasses.replace(CFG, g_use_sn=use_sn)
            want = init_weights(Generator(conv_dim=8, use_sn=use_sn), cfg.init_type, 0.02,
                                setup_seed(cfg.seed))
            g = served_generator(cfg, None, CPU)
            assert bool(_sn_convs(g)) is use_sn
            _assert_state(g, want.state_dict())
        # the service's draws at the parent: the same generator of the seed
        again = init_weights(Generator(conv_dim=8), CFG.init_type, 0.02,
                             torch.Generator().manual_seed(CFG.seed))
        _assert_state(served_generator(CFG, None, CPU), again.state_dict())
        return
    trained = _trained(use_sn=source == "sn")
    ema = None
    if source == "ema":
        ema = {k: p.detach() * 2.0 for k, p in trained.named_parameters()}
    path = save_pth(str(tmp_path / "g.pth"), trained.state_dict(), {}, 1, {}, {}, {}, {},
                    g_ema=ema)
    sd = generator_state(load_pth(path), ema=CFG.ema_eval)
    g = served_generator(CFG, sd, CPU)  # --g_use_sn off: the file decides
    assert g.training and g.dtype == torch.float32
    want = dict(trained.state_dict())
    if source == "ema":
        want.update(ema)
        assert not torch.equal(g.enc1.main[1].weight, trained.enc1.main[1].weight)
    _assert_state(g, want)
    assert bool(_sn_convs(g)) is (source == "sn")
    if source == "sn":
        keys = [k for k in want if k.endswith((".weight_u", ".weight_v"))]
        assert len(keys) == 2 * len(_sn_convs(g)) > 0
        seeded = served_generator(dataclasses.replace(CFG, g_use_sn=True), None, CPU)
        assert all(not torch.equal(seeded.state_dict()[k], want[k]) for k in keys)
