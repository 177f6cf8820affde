"""Plain PyTorch reference of UEGAN's train step with train-mode norm layers
in G and D (eezkni/UEGAN ``trainer.py`` with ``--g_norm_fun`` /
``--d_norm_fun``), the running statistics carried from step to step.

One step, in the published order: G(raw); the pool; D(exp), D(pool),
D(raw) as three train-mode forwards, each normalized with its own batch's
statistics and each moving the running ones; Adam on D; G(exp); D(exp)
without gradient; D(fake); Adam on G.  The losses, the pool and Adam are
``train.py``'s.  Planted faults for the harness's controls (``fault``):
``fused_d``, the D update's three inputs through each norm layer as one
batch of 3B; ``stats_once``, the running statistics moved once a step (by
the first G and the first D forward) with the biased variance.
"""

from __future__ import annotations

from typing import Dict

import torch

from portbench.reference import nets, norm_nets
from portbench.reference.train import ReferenceTrainer as _PlainTrainer

FAULTS = ("", "fused_d", "stats_once")


class ReferenceTrainer(_PlainTrainer):
    """The train state and step of the reference with norm layers
    ``g_norm`` in G and ``d_norm`` in D, from the weights it is given (each
    dict is copied): the running statistics ride in the nets' state dicts,
    not among the leaves Adam updates."""

    def __init__(self, g_params: nets.Params, d_params: nets.Params, vgg_params: nets.Params,
                 image_hw, pool_size: int, pool_seed: int, g_norm: str = "InstanceNorm",
                 d_norm: str = "BatchNorm", numerics: str = "f32", half_batch: bool = False,
                 fault: str = ""):
        if fault not in FAULTS:
            raise ValueError(f"fault {fault!r}: one of {FAULTS}")

        def leaves(p):
            return {k: v for k, v in p.items() if not k.endswith(norm_nets.STATS)}

        def stats(p):
            return {k: v.detach().clone().float() for k, v in p.items()
                    if k.endswith(norm_nets.STATS)}

        super().__init__(leaves(g_params), leaves(d_params), vgg_params, image_hw, pool_size,
                         pool_seed, numerics=numerics, half_batch=half_batch)
        if self.g_sn:
            raise ValueError("the norm reference runs G without spectral norm")
        self.g_state.update(stats(g_params))
        self.d_state.update(stats(d_params))
        self.g_norm, self.d_norm, self.fault = g_norm, d_norm, fault

    def step(self, raw: torch.Tensor, exp: torch.Tensor) -> Dict[str, torch.Tensor]:
        """raw, exp (B, H, W, 3) float32 in [-1, 1] -> the five losses (0-d tensors)."""
        if self.half_batch:
            raw, exp = raw[:raw.shape[0] // 2], exp[:exp.shape[0] // 2]
        nm, g, d = self.nm, self.g, self.d
        once = self.fault == "stats_once"
        upd = {"update": True, "unbiased": not once}
        later = {"update": not once, "unbiased": not once}

        def gen(x, first):
            return norm_nets.g_forward(g, self.g_state, x, nm, self.g_norm,
                                       **(upd if first else later))

        def dis(xs, first):
            return norm_nets.d_forward(d, self.d_state, xs, nm, self.d_norm,
                                       **(upd if first else later))

        with nets.exact():
            fake = gen(raw, True)
            store = self.pool.query(fake.detach())

            if self.fault == "fused_d":
                real, pooled, inp = norm_nets.d_forward_fused(d, self.d_state,
                                                              [exp, store, raw], nm,
                                                              self.d_norm)
            else:
                real, pooled, inp = dis([exp], True) + dis([store, raw], False)
            d_loss = nets.rahinge(real, pooled, True) + nets.rahinge(real, inp, True)
            grads = torch.autograd.grad(d_loss, list(d.values()))
            self.d_opt.step(dict(zip(d, grads)))

            idt = gen(exp, False)
            with torch.no_grad():
                (preds_real,) = dis([exp], False)
            (preds_fake,) = dis([fake], False)
            adv = self.lambda_adv * nets.rahinge(preds_real, preds_fake, False)
            percep = nets.perceptual_loss(self.vgg, (fake + 1.0) / 2.0, (raw + 1.0) / 2.0, nm)
            idt_loss = self.lambda_idt * nets.rec_loss(idt, exp)
            g_loss = adv + percep + idt_loss
            grads = torch.autograd.grad(g_loss, list(g.values()))
            self.g_opt.step(dict(zip(g, grads)))
        return {"D/Total": d_loss.detach(), "G/Total": g_loss.detach(),
                "G/adv_loss": adv.detach(), "G/percep_loss": percep.detach(),
                "G/idt_loss": idt_loss.detach()}

    def running_stats(self) -> Dict[str, torch.Tensor]:
        """Every norm layer's running mean and variance, by net-qualified name."""
        out = {f"G:{k}": v for k, v in self.g_state.items() if k.endswith(norm_nets.STATS)}
        out.update({f"D:{k}": v for k, v in self.d_state.items()
                    if k.endswith(norm_nets.STATS)})
        return out
