"""The port stands alone: no module of it imports JAX, msgpack or
anything of the JAX package, and its entry points run on the card unless
told otherwise."""
import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

REPO = Path(__file__).resolve().parents[1]
PORT = REPO / "src" / "repro_torch"
BANNED = ("jax", "jaxlib", "msgpack", "repro")


def _port_files():
    return sorted(PORT.rglob("*.py")) + [REPO / "chip_smoke.py"]


def _banned(name: str) -> bool:
    root = name.split(".")[0]
    return root in BANNED


@pytest.mark.parametrize("path", _port_files(),
                         ids=lambda p: str(p.relative_to(REPO)))
def test_no_jax_or_reference_import(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    bad = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            bad += [a.name for a in node.names if _banned(a.name)]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            if node.module and _banned(node.module):
                bad.append(node.module)
    assert not bad, f"{path}: imports {bad}"


def test_importing_the_port_loads_no_jax():
    mods = sorted(".".join(p.relative_to(REPO / "src").with_suffix("")
                           .parts).removesuffix(".__init__")
                  for p in PORT.rglob("*.py"))
    code = ("import sys\n"
            + "".join(f"import {m}\n" for m in mods)
            + "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
              f"{BANNED!r})\n"
            + "print(len(bad), bad)\n")
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    proc = subprocess.run([sys.executable, "-c", code], env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.startswith("0 "), proc.stdout


def test_entry_points_default_to_cuda(monkeypatch):
    from repro_torch.configs import get_config
    from repro_torch.device import resolve_device
    from repro_torch.models.model import Model
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    assert resolve_device(None) == torch.device("cuda")
    assert resolve_device("cpu") == torch.device("cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="is_available"):
        resolve_device(None)
    with pytest.raises(RuntimeError, match="is_available"):
        Model(get_config("gemma3-270m").reduced())


def test_chip_smoke_refuses_to_run_without_a_card(tmp_path):
    """The smoke script exits non-zero and prints no result line where
    there is no card, and also when it stands alone without the repo."""
    script = REPO / "chip_smoke.py"
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    for cwd in (REPO, tmp_path):
        if cwd == tmp_path:
            (tmp_path / "chip_smoke.py").write_text(script.read_text())
        proc = subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd,
                              env=env, capture_output=True, text=True,
                              timeout=120)
        assert proc.returncode != 0
        assert '"ok": true' not in proc.stdout
