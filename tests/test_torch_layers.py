"""PyTorch port: its parts import one way.

Every module of ``uegan_tpu_torch`` is read with ``ast`` (imports inside
functions included) and each import of the package is checked against the
layer map:

    cli, serve, tools, nima_train   entry points, none imports another
    train                           the Trainer, the train step, the Tester
    infer                           the served generator and its forwards
    models, losses, metrics, data, convert
    ops                             the kernels
    config, utils

A module imports its own part and the parts of lower layers, never those of
a higher one.
"""

import ast
import pathlib

import pytest

PKG = "uegan_tpu_torch"
ROOT = pathlib.Path(__file__).resolve().parents[1] / PKG

LAYERS = {
    "config": 0, "utils": 0,
    "ops": 1,
    "models": 2, "losses": 2, "metrics": 2, "data": 2, "convert": 2,
    "infer": 3,
    "train": 4,
    "cli": 5, "serve": 5, "tools": 5, "nima_train": 5,
}
ENTRY_POINTS = {part for part, layer in LAYERS.items() if layer == max(LAYERS.values())}


def _part(dotted: str) -> str:
    """``uegan_tpu_torch.infer.packed`` -> ``infer``; ``__main__`` runs ``cli``."""
    name = dotted.split(".")[1]
    return "cli" if name == "__main__" else name


def _imports(path: pathlib.Path):
    """(line, part imported) for every import of the package in ``path``."""
    rel = path.relative_to(ROOT.parent).with_suffix("")
    package = list(rel.parts if rel.name == "__init__" else rel.parts[:-1])
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            base = node.module or ""
            if node.level:
                base = ".".join(package[:len(package) - node.level + 1] + [base]).rstrip(".")
            # `from uegan_tpu_torch import ops` names the part in the alias
            names = [f"{base}.{a.name}" for a in node.names] if base == PKG else [base]
        else:
            continue
        for name in names:
            if name.split(".")[0] == PKG and "." in name:
                yield node.lineno, _part(name)


def _modules():
    """(part, path) of every module, the package's own ``__init__`` aside."""
    for path in sorted(ROOT.rglob("*.py")):
        rel = path.relative_to(ROOT.parent).with_suffix("")
        if rel.parts != (PKG, "__init__"):
            yield _part(".".join(rel.parts)), path


def _forbidden(part: str):
    above = {p for p, layer in LAYERS.items() if layer > LAYERS[part]}
    return above | (ENTRY_POINTS - {part} if part in ENTRY_POINTS else set())


@pytest.mark.parametrize("part", sorted(LAYERS))
def test_part_imports_no_higher_layer(part):
    forbidden = _forbidden(part)
    bad = [f"{path.relative_to(ROOT.parent)}:{line} imports {PKG}.{got} ("
           + ("another entry point)" if LAYERS[got] == LAYERS[part] else
              f"layer {LAYERS[got]}, above {part}'s {LAYERS[part]})")
           for owner, path in _modules() if owner == part
           for line, got in _imports(path) if got in forbidden]
    assert not bad, "\n".join(bad)


def test_every_module_has_a_layer_and_nested_imports_are_read():
    """No part escapes the map, and the walker sees imports made inside
    functions (the exporter's are all there)."""
    assert {part for part, _ in _modules()} == set(LAYERS)
    export = ROOT / "tools" / "export_model.py"
    nested = {got for _, got in _imports(export)}
    assert {"config", "infer", "utils", "ops"} <= nested, nested
    assert "cli" in _forbidden("serve") and "train" in _forbidden("infer")
    assert "models" in _forbidden("ops") and "infer" in _forbidden("models")
