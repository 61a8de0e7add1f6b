"""``minnow_torch`` stands alone: no file of the package, nor
``chip_smoke.py``, imports ``minnow_tpu``, ``jax`` or ``jaxlib``, and
every module of the package imports with all three refused."""

import ast
import os
import subprocess
import sys
import textwrap

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BANNED = ("minnow_tpu", "jax", "jaxlib")


def _sources():
    out = [os.path.join(REPO, "chip_smoke.py")]
    for root, _, files in os.walk(os.path.join(REPO, "minnow_torch")):
        out += [os.path.join(root, f) for f in files if f.endswith(".py")]
    return sorted(out)


def _imports(tree):
    """(line, module) of every import statement, wherever it stands."""
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield node.lineno, alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.lineno, node.module or ""


def test_the_walk_sees_the_port():
    names = {os.path.relpath(f, REPO) for f in _sources()}
    assert {"chip_smoke.py", "minnow_torch/core/spec.py",
            "minnow_torch/native.py", "minnow_torch/formats/minh.py",
            "minnow_torch/ingest/text.py", "minnow_torch/utils/config.py",
            "minnow_torch/cli/text_to_minh.py",
            "minnow_torch/ops/encode.py"} <= names


@pytest.mark.parametrize("fname", [os.path.relpath(f, REPO)
                                   for f in _sources()])
def test_no_import_of_the_jax_package(fname):
    with open(os.path.join(REPO, fname)) as f:
        tree = ast.parse(f.read(), fname)
    bad = [(line, mod) for line, mod in _imports(tree)
           if mod.split(".")[0] in BANNED]
    assert not bad, "%s imports %s" % (fname, bad)
    # an import by name would pass the walk above
    for node in ast.walk(tree):
        if isinstance(node, ast.Call) and getattr(
                node.func, "id", getattr(node.func, "attr", "")) in (
                    "__import__", "import_module"):
            arg = node.args[0] if node.args else None
            assert not (isinstance(arg, ast.Constant)
                        and str(arg.value).split(".")[0] in BANNED), \
                (fname, node.lineno)


IMPORT_ALL = textwrap.dedent("""
    import importlib, importlib.abc, pkgutil, sys

    class Refuse(importlib.abc.MetaPathFinder):
        def find_spec(self, name, path=None, target=None):
            if name.split(".")[0] in ("minnow_tpu", "jax", "jaxlib"):
                raise ImportError("refused here: " + name)

    sys.meta_path.insert(0, Refuse())
    sys.path.insert(0, sys.argv[1])
    import minnow_torch
    names = [m.name for m in pkgutil.walk_packages(minnow_torch.__path__,
                                                   "minnow_torch.")]
    for name in names:
        importlib.import_module(name)
    assert len(names) > 30, names
    loaded = [m for m in sys.modules
              if m.split(".")[0] in ("minnow_tpu", "jax", "jaxlib")]
    assert not loaded, loaded
    print("STANDALONE_OK", len(names))
""")


def test_every_module_imports_with_the_jax_package_refused():
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    res = subprocess.run([sys.executable, "-c", IMPORT_ALL, REPO],
                         capture_output=True, text=True, env=env,
                         timeout=300)
    assert res.returncode == 0, res.stderr[-3000:]
    assert "STANDALONE_OK" in res.stdout
