"""Flax generator variables -> torch ``state_dict`` under the reference names.

Inverts uegan_tpu/convert/torch_import.py:import_generator: kernels go from
HWIO to OIHW, norm ``scale``/``bias`` become ``weight``/``bias`` and the
``batch_stats`` ``mean``/``var`` become ``running_mean``/``running_var``.
Values may be numpy arrays or anything ``np.asarray`` takes; nothing here
imports JAX.
"""

from __future__ import annotations

from typing import Any, Dict, Tuple

import numpy as np
import torch

from uegan_tpu_torch.models.blocks import ROADMAP_SN


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(np.asarray(a)))


def _node(tree: Dict[str, Any], path: Tuple[str, ...]):
    for key in path:
        if not isinstance(tree, dict) or key not in tree:
            return None
        tree = tree[key]
    return tree


def generator_state_dict(variables: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """``{"params": ..., ["batch_stats": ...]}`` of :class:`uegan_tpu.models.
    generator.Generator` -> state dict for ``uegan_tpu_torch``'s Generator."""
    if variables.get("spectral"):
        raise NotImplementedError(ROADMAP_SN)
    params = variables["params"]
    stats = variables.get("batch_stats", {})
    sd: Dict[str, torch.Tensor] = {}

    def conv(path: Tuple[str, ...], prefix: str) -> None:
        node = _node(params, path)
        if node is None:
            raise KeyError(f"flax generator variables lack {'/'.join(path)}")
        sd[f"{prefix}.weight"] = _t(np.transpose(np.asarray(node["kernel"]), (3, 2, 0, 1)))
        if "bias" in node:
            sd[f"{prefix}.bias"] = _t(node["bias"])

    def norm(path: Tuple[str, ...], prefix: str) -> None:
        node = _node(params, path)
        if node is None:
            return
        sd[f"{prefix}.weight"] = _t(node["scale"])
        sd[f"{prefix}.bias"] = _t(node["bias"])
        rs = _node(stats, path)
        if rs is not None:
            sd[f"{prefix}.running_mean"] = _t(rs["mean"])
            sd[f"{prefix}.running_var"] = _t(rs["var"])

    for i in range(1, 6):
        conv((f"enc{i}", "conv"), f"enc{i}.main.1")
        norm((f"enc{i}", "norm"), f"enc{i}.main.2")
    for i in range(1, 5):
        conv((f"upsample{i}",), f"upsample{i}.1.main.1")
        conv((f"dec{i}", "conv"), f"dec{i}.main.1")
        norm((f"dec{i}", "norm"), f"dec{i}.main.2")
    conv(("dec5_0",), "dec5.0.main.1")
    conv(("dec5_1",), "dec5.1.main.1")
    for i in range(1, 6):
        conv((f"ga{i}", "squeeze"), f"ga{i}.conv.0")
        conv((f"ga{i}", "excite"), f"ga{i}.conv.2")
        conv((f"ga{i}", "fuse"), f"ga{i}.fuse.0")
    return sd
