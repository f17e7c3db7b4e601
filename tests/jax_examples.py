"""Helpers for the tests that hold ``odam_torch.examples`` to the JAX
package's ``examples/`` scripts on the CPU.

The JAX scripts import their neighbours by name (``from common import ...``)
and several run at module level, so a test loads a module with its folder on
``sys.path`` (:func:`jax_module`), or takes one top-level definition out of
a script's source and executes it alone (:func:`jax_def`): the JAX code
itself, without running the script around it.
"""
import ast
import importlib.util
import os
import sys

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
EXAMPLES = os.path.join(ROOT, "examples")


def _on_path(folder: str) -> None:
    for d in (ROOT, folder):
        if d not in sys.path:
            sys.path.insert(0, d)


def jax_module(relpath: str):
    """The module ``examples/<relpath>`` (its folder on ``sys.path``), loaded
    under the name it imports its neighbours by."""
    path = os.path.join(EXAMPLES, relpath)
    _on_path(os.path.dirname(path))
    name = os.path.splitext(os.path.basename(path))[0]
    if name in sys.modules and getattr(sys.modules[name], "__file__", None) == path:
        return sys.modules[name]
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    spec.loader.exec_module(mod)
    return mod


def jax_def(relpath: str, name: str, **namespace):
    """The top-level function or class ``name`` of the script
    ``examples/<relpath>``, executed alone in ``namespace``."""
    path = os.path.join(EXAMPLES, relpath)
    _on_path(os.path.dirname(path))
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    node = next(n for n in tree.body
                if isinstance(n, (ast.FunctionDef, ast.ClassDef)) and n.name == name)
    module = ast.Module(body=[node], type_ignores=[])
    exec(compile(module, path, "exec"), namespace)
    return namespace[name]
