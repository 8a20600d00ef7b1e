"""The port stands alone: no jax, no bdls_tpu, no cryptography.

``bdls_tpu_torch`` and ``chip_smoke.py`` run on a machine that has none
of the three, so a subprocess imports every module of the port and
checks ``sys.modules``, and a source scan checks every import statement.
Entry points called without a device run on the card and raise where
there is none.
"""

from __future__ import annotations

import ast
import json
import pkgutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

import bdls_tpu_torch

ROOT = Path(__file__).resolve().parents[1]
PKG = ROOT / "bdls_tpu_torch"
FORBIDDEN = ("jax", "jaxlib", "bdls_tpu", "cryptography")


def _modules() -> list[str]:
    return sorted(m.name for m in pkgutil.walk_packages(
        bdls_tpu_torch.__path__, prefix="bdls_tpu_torch."))


def test_every_module_is_listed():
    mods = _modules()
    for name in ("bdls_tpu_torch.crypto.torch_provider",
                 "bdls_tpu_torch.ops.ecdsa", "bdls_tpu_torch.ops._build",
                 "bdls_tpu_torch.ops.verify_fold", "bdls_tpu_torch.utils.device"):
        assert name in mods


def test_import_loads_no_forbidden_package():
    code = (
        "import importlib, json, sys\n"
        f"for m in {_modules()!r}:\n"
        "    importlib.import_module(m)\n"
        "print(json.dumps(sorted(k for k in sys.modules\n"
        f"    if k.split('.')[0] in {FORBIDDEN!r})))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []


def _imported_roots(path: Path) -> set[str]:
    roots = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            roots.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            roots.add(node.module.split(".")[0])
    return roots


@pytest.mark.parametrize("rel", sorted(
    str(p.relative_to(ROOT)) for p in PKG.rglob("*.py")) + ["chip_smoke.py"])
def test_source_imports_nothing_forbidden(rel):
    roots = _imported_roots(ROOT / rel)
    assert not roots & set(FORBIDDEN), (rel, roots & set(FORBIDDEN))


def test_entry_points_need_a_card_by_default(monkeypatch):
    from bdls_tpu_torch.crypto.torch_provider import TorchCSP
    from bdls_tpu_torch.ops import ecdsa
    from bdls_tpu_torch.ops.curves import P256
    from bdls_tpu_torch.utils.device import resolve_device

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        TorchCSP()
    with pytest.raises(RuntimeError, match="CUDA"):
        ecdsa.verify_batch(P256, [1], [1], [1], [1], [1])
    with pytest.raises(RuntimeError, match="CUDA"):
        resolve_device("cuda")
    assert resolve_device("cpu").type == "cpu"


def test_pinned_keys_are_not_in_this_slice():
    from bdls_tpu_torch.crypto.torch_provider import TorchCSP

    with pytest.raises(NotImplementedError, match="Pinned keys"):
        TorchCSP(device="cpu", key_cache_size=256)
