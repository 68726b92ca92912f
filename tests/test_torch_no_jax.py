"""Import guard: the port and chip_smoke.py import no JAX, nothing of the
JAX package (hrviton_tpu) and none of its scripts under tools/, statically
and at run time."""

import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "hrviton_tpu_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py"]


def _forbidden(name: str) -> bool:
    top = name.split(".")[0]
    # "tools": the JAX repository's scripts (the port has its own package,
    # hrviton_tpu_torch.tools)
    return top in ("jax", "jaxlib", "flax", "optax", "hrviton_tpu", "tools")


def _imports(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield node.lineno, alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.lineno, node.module or ""
        elif (isinstance(node, ast.Call) and getattr(node.func, "attr", "")
              in ("import_module", "__import__") and node.args
              and isinstance(node.args[0], ast.Constant)):
            yield node.lineno, str(node.args[0].value)


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_imports(path):
    assert path.exists(), path
    bad = [f"{path.name}:{ln} imports {name}" for ln, name in _imports(path)
           if _forbidden(name)]
    assert not bad, bad


def test_package_imports_with_jax_unimportable(tmp_path):
    """Import every port module in a fresh interpreter where importing jax,
    flax or hrviton_tpu raises."""
    (tmp_path / "sitecustomize.py").write_text(
        "import sys\n"
        "class _Block:\n"
        "    def find_spec(self, name, path=None, target=None):\n"
        "        top = name.split('.')[0]\n"
        "        if top in ('jax', 'jaxlib', 'flax', 'hrviton_tpu'):\n"
        "            raise ImportError('blocked: ' + name)\n"
        "sys.meta_path.insert(0, _Block())\n")
    mods = [".".join(p.relative_to(ROOT).with_suffix("").parts)
            for p in PORT_FILES if p.parent != ROOT]
    mods = [m[: -len(".__init__")] if m.endswith(".__init__") else m
            for m in mods]
    code = ("import importlib, sys\n"
            f"for m in {mods!r}: importlib.import_module(m)\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'flax', 'hrviton_tpu')]\n"
            "assert not bad, bad\n"
            "print('ok', len(sys.modules))\n")
    env = dict(os.environ, PYTHONPATH=f"{tmp_path}{os.pathsep}{ROOT}")
    proc = subprocess.run([sys.executable, "-c", code], cwd=tmp_path, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.startswith("ok")


def _chip_smoke_modules():
    """The port modules chip_smoke.py imports, at any depth of the script."""
    names = {name for _, name in _imports(ROOT / "chip_smoke.py")
             if name.split(".")[0] == "hrviton_tpu_torch"}
    tree = ast.parse((ROOT / "chip_smoke.py").read_text())
    for node in ast.walk(tree):              # from hrviton_tpu_torch.x import y
        if isinstance(node, ast.ImportFrom) and node.level == 0 and \
                (node.module or "").startswith("hrviton_tpu_torch"):
            names |= {f"{node.module}.{a.name}" for a in node.names}
    return sorted(names)


# chip_smoke.py's phase 8 drives the rejection CLIs on a synthetic
# VITON-HD tree that it writes and reads with PIL, as the CLIs read their
# data (the machine with the card has PIL: PERF.md, PR 11's runs); these
# modules import PIL when imported, and phase 8 alone loads them
PIL_MODULES = ("hrviton_tpu_torch.data.synthetic",
               "hrviton_tpu_torch.data.dataset")


def test_card_side_imports_need_no_pil_or_msgpack(tmp_path):
    """chip_smoke.py's port imports but phase 8's data modules
    (``PIL_MODULES``), and data.device, utils.vis and cli.test_generator,
    load in a fresh interpreter where importing PIL or msgpack raises: the
    kernels' phases and the CLIs' card-side steps need neither."""
    mods = [m for m in _chip_smoke_modules()
            if not any(m == p or m.startswith(p + ".") for p in PIL_MODULES)]
    assert set(PIL_MODULES) <= set(_chip_smoke_modules())
    mods += ["hrviton_tpu_torch.data",
                                    "hrviton_tpu_torch.data.device",
                                    "hrviton_tpu_torch.utils.vis",
                                    "hrviton_tpu_torch.cli.test_generator"]
    assert "hrviton_tpu_torch.cli.test_generator" in _chip_smoke_modules()
    (tmp_path / "sitecustomize.py").write_text(
        "import sys\n"
        "class _Block:\n"
        "    def find_spec(self, name, path=None, target=None):\n"
        "        top = name.split('.')[0]\n"
        "        if top in ('PIL', 'msgpack', 'jax', 'flax', 'hrviton_tpu'):\n"
        "            raise ImportError('blocked: ' + name)\n"
        "sys.meta_path.insert(0, _Block())\n")
    code = ("import importlib, sys\n"
            f"for m in {mods!r}:\n"
            "    try:\n"
            "        importlib.import_module(m)\n"
            "    except ModuleNotFoundError:\n"
            "        parent, _, attr = m.rpartition('.')\n"
            "        getattr(importlib.import_module(parent), attr)\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('PIL', 'msgpack')]\n"
            "assert not bad, bad\n"
            "print('ok', len(sys.modules))\n")
    env = dict(os.environ, PYTHONPATH=f"{tmp_path}{os.pathsep}{ROOT}")
    proc = subprocess.run([sys.executable, "-c", code], cwd=tmp_path, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.startswith("ok")
