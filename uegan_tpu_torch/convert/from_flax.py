"""Flax variables -> torch ``state_dict`` under the reference names.

Inverts uegan_tpu/convert/torch_import.py: ``import_generator`` (kernels go
from HWIO to OIHW, norm ``scale``/``bias`` become ``weight``/``bias`` and
the ``batch_stats`` ``mean``/``var`` become ``running_mean``/
``running_var``; under ``--g_use_sn`` a spectrally normalized kernel
becomes ``weight_orig``, its ``spectral`` ``u``/``v`` ``weight_u``/
``weight_v``), ``import_discriminator`` (the same spectral-norm and norm names),
``import_vgg19`` (``conv{s}_{i}_kernel`` becomes torchvision's
``features.{idx}.weight``) and ``import_nima`` (the
MobileNetV2 trunk's ``base/{stem,block{i}/{pw,dw,pw_linear},head_conv}``
become the reference's ``base_model.0.{idx}``, the ``fc`` kernel is
transposed into ``head.2.weight``).  ``adam_state_dict`` carries optax's
Adam moments into ``torch.optim.Adam``'s state dict through the same name
maps.  Values may be numpy arrays or anything ``np.asarray`` takes;
nothing here imports JAX.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Sequence, Tuple

import numpy as np
import torch

from uegan_tpu_torch.models.vgg import VGG19_CONVS, VGG19_TAIL


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, copy=True))


def _node(tree: Dict[str, Any], path: Tuple[str, ...]):
    for key in path:
        if not isinstance(tree, dict) or key not in tree:
            return None
        tree = tree[key]
    return tree


def _oihw(kernel) -> torch.Tensor:
    return _t(np.transpose(np.asarray(kernel), (3, 2, 0, 1)))


def _norm_into(sd: Dict[str, torch.Tensor], params, stats, path: Tuple[str, ...],
               prefix: str) -> None:
    """A NormLayer's ``scale``/``bias`` and its ``batch_stats`` ``mean``/``var``
    at ``path``, where the tree has one, as ``prefix.weight``, ``.bias``,
    ``.running_mean`` and ``.running_var``."""
    node = _node(params, path)
    if node is None:
        return
    sd[f"{prefix}.weight"] = _t(node["scale"])
    sd[f"{prefix}.bias"] = _t(node["bias"])
    rs = _node(stats, path)
    if rs is not None:
        sd[f"{prefix}.running_mean"] = _t(rs["mean"])
        sd[f"{prefix}.running_var"] = _t(rs["var"])


def generator_state_dict(variables: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """``{"params": ..., ["batch_stats": ...], ["spectral": ...]}`` of
    :class:`uegan_tpu.models.generator.Generator` -> state dict for
    ``uegan_tpu_torch``'s Generator.  A conv with ``spectral`` u and v (the
    blocks, upsample convs and GAM fuse convs of a ``use_sn`` generator)
    becomes ``weight_orig``, ``weight_u``, ``weight_v``."""
    params = variables["params"]
    stats = variables.get("batch_stats", {})
    spectral = variables.get("spectral", {})
    sd: Dict[str, torch.Tensor] = {}

    def conv(path: Tuple[str, ...], prefix: str) -> None:
        node = _node(params, path)
        if node is None:
            raise KeyError(f"flax generator variables lack {'/'.join(path)}")
        uv = _node(spectral, path)
        if uv is not None:
            sd[f"{prefix}.weight_orig"] = _oihw(node["kernel"])
            sd[f"{prefix}.weight_u"] = _t(uv["u"])
            sd[f"{prefix}.weight_v"] = _t(uv["v"])
        else:
            sd[f"{prefix}.weight"] = _oihw(node["kernel"])
        if "bias" in node:
            sd[f"{prefix}.bias"] = _t(node["bias"])

    for i in range(1, 6):
        conv((f"enc{i}", "conv"), f"enc{i}.main.1")
        _norm_into(sd, params, stats, (f"enc{i}", "norm"), f"enc{i}.main.2")
    for i in range(1, 5):
        conv((f"upsample{i}",), f"upsample{i}.1.main.1")
        conv((f"dec{i}", "conv"), f"dec{i}.main.1")
        _norm_into(sd, params, stats, (f"dec{i}", "norm"), f"dec{i}.main.2")
    conv(("dec5_0",), "dec5.0.main.1")
    conv(("dec5_1",), "dec5.1.main.1")
    for i in range(1, 6):
        conv((f"ga{i}", "squeeze"), f"ga{i}.conv.0")
        conv((f"ga{i}", "excite"), f"ga{i}.conv.2")
        conv((f"ga{i}", "fuse"), f"ga{i}.fuse.0")
    return sd


def discriminator_state_dict(variables: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """``{"params": ..., ["batch_stats": ...], ["spectral": ...]}`` of
    :class:`uegan_tpu.models.discriminator.Discriminator` -> state dict for
    ``uegan_tpu_torch``'s; a stage's norm layer becomes ``d{i}.0.2.*``."""
    params = variables["params"]
    stats = variables.get("batch_stats", {})
    spectral = variables.get("spectral", {})
    sd: Dict[str, torch.Tensor] = {}
    for i in range(1, 6):
        node = _node(params, (f"d{i}", "conv"))
        if node is None:
            raise KeyError(f"flax discriminator variables lack d{i}/conv")
        uv = _node(spectral, (f"d{i}", "conv"))
        if uv is not None:
            sd[f"d{i}.0.1.weight_orig"] = _oihw(node["kernel"])
            sd[f"d{i}.0.1.weight_u"] = _t(uv["u"])
            sd[f"d{i}.0.1.weight_v"] = _t(uv["v"])
        else:
            sd[f"d{i}.0.1.weight"] = _oihw(node["kernel"])
        sd[f"d{i}.0.1.bias"] = _t(node["bias"])
        _norm_into(sd, params, stats, (f"d{i}", "norm"), f"d{i}.0.2")
        sd[f"d{i}_pred.0.1.weight"] = _oihw(params[f"d{i}_pred"]["conv"]["kernel"])
    return sd


def vgg_state_dict(variables: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """``{"params": ...}`` of :class:`uegan_tpu.models.vgg.VGG19Features` ->
    torchvision-named state dict of its convs (conv5_2 .. conv5_4 where the
    tree has them; the port's trunk ends at conv5_1 and skips them)."""
    params = variables["params"]
    sd: Dict[str, torch.Tensor] = {}
    tail = {name for name, _, _ in VGG19_TAIL}
    for name, idx, _ in VGG19_CONVS + VGG19_TAIL:
        if name in tail and f"{name}_kernel" not in params:
            continue
        sd[f"features.{idx}.weight"] = _oihw(params[f"{name}_kernel"])
        sd[f"features.{idx}.bias"] = _t(params[f"{name}_bias"])
    return sd


def nima_state_dict(variables: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """``{"params": ..., "batch_stats": ...}`` of :class:`uegan_tpu.models.
    nima.NIMA` -> the reference-named state dict of ``uegan_tpu_torch``'s
    NIMA (without ``num_batches_tracked``, which its loader does not need)."""
    params = variables["params"]
    stats = variables.get("batch_stats", {})
    sd: Dict[str, torch.Tensor] = {}

    def conv_bn(path: Tuple[str, ...], conv: str, bn: str) -> None:
        node = _node(params, path)
        if node is None:
            raise KeyError(f"flax NIMA variables lack {'/'.join(path)}")
        sd[f"{conv}.weight"] = _oihw(node["kernel"])
        sd[f"{bn}.weight"] = _t(node["bn"]["scale"])
        sd[f"{bn}.bias"] = _t(node["bn"]["bias"])
        rs = _node(stats, path + ("bn",))
        if rs is None:
            raise KeyError(f"flax NIMA variables lack batch_stats {'/'.join(path)}/bn")
        sd[f"{bn}.running_mean"] = _t(rs["mean"])
        sd[f"{bn}.running_var"] = _t(rs["var"])

    base = "base_model.0"
    conv_bn(("base", "stem"), f"{base}.0.0", f"{base}.0.1")
    for i in range(17):
        t = f"{base}.{i + 1}.conv"
        for j, name in ((0, "pw"), (3, "dw"), (6, "pw_linear")):
            conv_bn(("base", f"block{i}", name), f"{t}.{j}", f"{t}.{j + 1}")
    conv_bn(("base", "head_conv"), f"{base}.18.0", f"{base}.18.1")
    sd["head.2.weight"] = _t(np.ascontiguousarray(np.asarray(params["fc"]["kernel"]).T))
    sd["head.2.bias"] = _t(params["fc"]["bias"])
    return sd


def adam_state_dict(count, mu: Dict[str, Any], nu: Dict[str, Any],
                    to_state_dict: Callable[[Dict[str, Any]], Dict[str, torch.Tensor]],
                    names: Sequence[str], lr: float, betas: Tuple[float, float],
                    weight_decay: float, eps: float = 1e-8) -> Dict[str, Any]:
    """optax's ``ScaleByAdamState(count, mu, nu)`` (index 1 of the JAX
    chain ``add_decayed_weights``, ``scale_by_adam``, ``scale_by_learning_rate``,
    uegan_tpu/train/schedules.py) -> ``torch.optim.Adam.state_dict()`` of an
    optimizer over parameters ``names`` (the port's ``named_parameters()``
    order, which is the order of Adam's integer state keys).

    ``to_state_dict`` maps a parameter-shaped tree to torch names (such as
    ``generator_state_dict``, or ``discriminator_state_dict`` with the
    spectral tree beside it, so a kernel becomes ``weight_orig``); entries
    that are not parameters (SN ``u``/``v``) are dropped.  ``step`` is
    ``count`` as the float tensor torch keeps; both packages' bias
    corrections then take the same power.  The coupled weight decay enters
    the gradient before the moments in both, so ``mu``/``nu`` are torch's
    ``exp_avg``/``exp_avg_sq`` as they are."""
    m, v = to_state_dict(mu), to_state_dict(nu)
    missing = [n for n in names if n not in m or n not in v]
    if missing:
        raise KeyError(f"the Adam moments lack {missing}")
    step = torch.tensor(float(np.asarray(count)))
    state = {i: {"step": step.clone(), "exp_avg": m[n], "exp_avg_sq": v[n]}
             for i, n in enumerate(names)}
    group = {"lr": lr, "betas": tuple(betas), "eps": eps, "weight_decay": weight_decay,
             "amsgrad": False, "maximize": False, "params": list(range(len(names)))}
    return {"state": state, "param_groups": [group]}
