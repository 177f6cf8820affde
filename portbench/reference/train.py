"""Plain PyTorch reference of UEGAN's train step (eezkni/UEGAN ``trainer.py``).

One step, in the published order:

1. the fake G(raw) and the identity output G(exp) (under spectral norm in G,
   G(exp) comes after the D update, so that G's u and v advance once before
   the D update and once after it, as two train-mode forwards do);
2. the history pool (size ``pool_size``): while it fills, each fake goes in
   and comes back; once full, with probability 1/2 it swaps with a uniformly
   drawn slot.  The draws, one uniform and one slot an image, come from a
   ``torch.Generator`` on the step's device seeded with ``pool_seed``;
3. the D update: D(exp), D(pool), D(raw) as three train-mode forwards (each
   advances D's u and v once), rahinge(exp, pool) + rahinge(exp, raw),
   Adam on D;
4. the G update against the updated D: D(exp) without gradient, D(fake),
   0.1 x rahinge + VGG perceptual loss of (fake + 1) / 2 against
   (raw + 1) / 2 + 0.1 x the multiscale L1 of G(exp) against exp, Adam on G.

Adam is torch's with the L2 weight decay coupled into the gradient: betas
(0.5, 0.999), eps 1e-8, decay 1e-4, lr 1e-4 for G and 4e-4 for D (the
schedule holds them for the first 49 epochs).
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

from portbench.reference import nets

LOSS_NAMES = ("D/Total", "G/Total", "G/adv_loss", "G/percep_loss", "G/idt_loss")


class Adam:
    """torch.optim.Adam's update with coupled L2 weight decay, on a dict of leaves."""

    def __init__(self, params: nets.Params, lr: float, betas=(0.5, 0.999), eps: float = 1e-8,
                 weight_decay: float = 1e-4):
        self.params, self.lr, self.betas, self.eps, self.wd = params, lr, betas, eps, weight_decay
        self.m = {k: torch.zeros_like(v) for k, v in params.items()}
        self.v = {k: torch.zeros_like(v) for k, v in params.items()}
        self.t = 0
        self.last_grad: Dict[str, torch.Tensor] = {}

    @torch.no_grad()
    def step(self, grads: Dict[str, torch.Tensor]) -> None:
        self.t += 1
        b1, b2 = self.betas
        c1, c2 = 1 - b1 ** self.t, 1 - b2 ** self.t
        for k, p in self.params.items():
            g = grads[k] + self.wd * p
            self.last_grad[k] = g
            self.m[k].mul_(b1).add_(g, alpha=1 - b1)
            self.v[k].mul_(b2).addcmul_(g, g, value=1 - b2)
            denom = self.v[k].sqrt() / (c2 ** 0.5) + self.eps
            p.addcdiv_(self.m[k], denom, value=-self.lr / c1)


class Pool:
    """The fake-image history pool, on the device, taken image by image."""

    def __init__(self, size: int, image_shape, device, seed: int):
        self.size = size
        self.images = torch.zeros((size,) + tuple(image_shape), device=device)
        self.count = 0
        # on the meta device (FLOP counting) the draws need no generator
        self.gen = (None if torch.device(device).type == "meta"
                    else torch.Generator(device=device).manual_seed(seed))

    @torch.no_grad()
    def query(self, batch: torch.Tensor) -> torch.Tensor:
        b = batch.shape[0]
        p = torch.rand((b,), generator=self.gen, device=batch.device)
        slot = torch.randint(0, self.size, (b,), generator=self.gen, device=batch.device)
        out = []
        for i in range(b):
            img = batch[i].float()
            if self.count < self.size:
                self.images[self.count] = img
                self.count += 1
                out.append(img)
            elif bool(p[i] > 0.5):
                s = int(slot[i])
                out.append(self.images[s].clone())
                self.images[s] = img
            else:
                out.append(img)
        return torch.stack(out)


class ReferenceTrainer:
    """The train state and step of the reference, from the weights it is given
    (each dict is copied: the caller's tensors are not changed)."""

    def __init__(self, g_params: nets.Params, d_params: nets.Params, vgg_params: nets.Params,
                 image_hw, pool_size: int, pool_seed: int, numerics: str = "f32",
                 g_lr: float = 1e-4, d_lr: float = 4e-4, lambda_adv: float = 0.1,
                 lambda_idt: float = 0.1, half_batch: bool = False):
        def split(p):
            leaves = {k: v.detach().clone().float().requires_grad_(True) for k, v in p.items()
                      if not k.endswith(("weight_u", "weight_v"))}
            state = {k: v.detach().clone().float() for k, v in p.items()
                     if k.endswith(("weight_u", "weight_v"))}
            return leaves, state

        self.g, self.g_state = split(g_params)
        self.d, self.d_state = split(d_params)
        self.vgg = {k: v.detach().clone().float() for k, v in vgg_params.items()}
        self.g_sn = any(k.endswith("weight_orig") for k in self.g)
        self.nm = nets.Numerics(numerics)
        self.g_opt, self.d_opt = Adam(self.g, g_lr), Adam(self.d, d_lr)
        dev = next(iter(self.g.values())).device
        self.pool = Pool(pool_size, (image_hw[0], image_hw[1], 3), dev, pool_seed)
        self.lambda_adv, self.lambda_idt = lambda_adv, lambda_idt
        # a planted fault for the harness's checks: the step sees only the first
        # half of its rows, and every mean is taken over those
        self.half_batch = half_batch

    def step(self, raw: torch.Tensor, exp: torch.Tensor) -> Dict[str, torch.Tensor]:
        """raw, exp (B, H, W, 3) float32 in [-1, 1] -> the five losses (0-d tensors)."""
        if self.half_batch:
            raw, exp = raw[:raw.shape[0] // 2], exp[:exp.shape[0] // 2]
        nm, g, d = self.nm, self.g, self.d
        with nets.exact():
            fake = nets.g_forward(g, self.g_state, raw, nm, train=True)
            idt = None if self.g_sn else nets.g_forward(g, self.g_state, exp, nm, train=True)
            store = self.pool.query(fake.detach())

            real = nets.d_forward(d, self.d_state, exp, nm)
            d_loss = (nets.rahinge(real, nets.d_forward(d, self.d_state, store, nm), True)
                      + nets.rahinge(real, nets.d_forward(d, self.d_state, raw, nm), True))
            grads = torch.autograd.grad(d_loss, list(d.values()))
            self.d_opt.step(dict(zip(d, grads)))

            if idt is None:
                idt = nets.g_forward(g, self.g_state, exp, nm, train=True)
            with torch.no_grad():
                preds_real = nets.d_forward(d, self.d_state, exp, nm)
            preds_fake = nets.d_forward(d, self.d_state, fake, nm)
            adv = self.lambda_adv * nets.rahinge(preds_real, preds_fake, False)
            percep = nets.perceptual_loss(self.vgg, (fake + 1.0) / 2.0, (raw + 1.0) / 2.0, nm)
            idt_loss = self.lambda_idt * nets.rec_loss(idt, exp)
            g_loss = adv + percep + idt_loss
            grads = torch.autograd.grad(g_loss, list(g.values()))
            self.g_opt.step(dict(zip(g, grads)))
        return dict(zip(LOSS_NAMES, (t.detach() for t in (d_loss, g_loss, adv, percep,
                                                           idt_loss))))

    def last_grads(self) -> Dict[str, torch.Tensor]:
        """The gradient each optimizer took at its last step, weight decay included,
        by net-qualified leaf name (``G:enc1.main.1.weight``)."""
        out = {f"G:{k}": v for k, v in self.g_opt.last_grad.items()}
        out.update({f"D:{k}": v for k, v in self.d_opt.last_grad.items()})
        return out

    def leaves(self) -> Dict[str, torch.Tensor]:
        out = {f"G:{k}": v.detach() for k, v in self.g.items()}
        out.update({f"D:{k}": v.detach() for k, v in self.d.items()})
        return out

    def g_uv(self) -> Optional[Dict[str, torch.Tensor]]:
        return dict(self.g_state) if self.g_sn else None
