"""The layering of lobpcg_tpu_torch, read from its source on the CPU.

- No module of ``ops/cuda/`` (the hand-written kernels' wrappers) imports
  from a layer above it: ``ops/``, ``operators/``, ``solvers/`` or
  ``parallel/`` (nor the package root, which imports them all).  Each
  wrapper decides between its kernel and its plain version from what it
  is given, so the kernel layer needs nothing from its callers.
- The eager switch (``ops/cuda/chains.py``: ``eager_chain``, ``eager``)
  is asked by no module outside ``ops/cuda/``: each wrapper it governs
  runs its call site's eager chain from what it is given.
"""

import ast
import pathlib

import pytest

PKG = pathlib.Path(__file__).resolve().parents[1] / "lobpcg_tpu_torch"
CUDA = PKG / "ops" / "cuda"
ROOT = "lobpcg_tpu_torch"
KERNEL_LAYER = f"{ROOT}.ops.cuda"
ABOVE = tuple(f"{ROOT}.{m}" for m in ("ops", "operators", "solvers", "parallel"))
SWITCH = ("eager", "eager_chain")
SWITCH_SITES = set()


def _module_of(path: pathlib.Path) -> str:
    rel = path.relative_to(PKG.parent).with_suffix("")
    return ".".join(rel.parts)


def imported(source: str, module: str):
    """Every module an import statement of ``source`` (the text of
    ``module``) names; a from-import as ``module.name``, so that ``from
    lobpcg_tpu_torch.ops import masking`` reads as
    ``lobpcg_tpu_torch.ops.masking``; relative imports resolved."""
    for node in ast.walk(ast.parse(source)):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom):
            base = node.module or ""
            if node.level:
                pkg = module.split(".")[:-node.level]
                base = ".".join(pkg + ([base] if base else []))
            yield from (f"{base}.{a.name}" for a in node.names)


def upward(name: str) -> bool:
    """Is ``name`` a module above the kernel layer?"""
    def under(prefix):
        return name == prefix or name.startswith(prefix + ".")
    return name == ROOT or (any(under(p) for p in ABOVE)
                            and not under(KERNEL_LAYER))


def test_the_import_check_sees_an_upward_import():
    mod = f"{KERNEL_LAYER}.tail"
    bad = ("from lobpcg_tpu_torch.ops import masking\n"
           "from .. import gram\n"
           "def f():\n    import lobpcg_tpu_torch.operators.linop\n")
    assert [upward(n) for n in imported(bad, mod)] == [True, True, True]
    good = ("from lobpcg_tpu_torch.ops.cuda.build import check\n"
            "from lobpcg_tpu_torch.ops.cuda import chains\n"
            "from . import stencil\n"
            "from lobpcg_tpu_torch.utils.profiling import span\n")
    assert not any(upward(n) for n in imported(good, mod))


@pytest.mark.parametrize("path", sorted(CUDA.glob("*.py")), ids=lambda p: p.name)
def test_kernel_layer_imports_nothing_above_it(path):
    names = [n for n in imported(path.read_text(), _module_of(path)) if upward(n)]
    assert names == [], f"{path.name} imports {names}"


def switch_sites(source: str):
    """(function, name) of every mention of the eager switch in
    ``source``: a call or reference ``x.eager`` / ``x.eager_chain``, a
    bare ``eager`` / ``eager_chain``, or an import of either; the
    function is the innermost one around it ("<module>" outside any)."""
    found = []

    def visit(node, where):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            where = node.name
        if isinstance(node, ast.Attribute) and node.attr in SWITCH:
            found.append((where, node.attr))
        elif isinstance(node, ast.Name) and node.id in SWITCH:
            found.append((where, node.id))
        elif isinstance(node, ast.ImportFrom):
            found.extend((where, a.name) for a in node.names if a.name in SWITCH)
        for child in ast.iter_child_nodes(node):
            visit(child, where)

    visit(ast.parse(source), "<module>")
    return found


def test_the_switch_check_sees_a_call_site():
    src = ("from lobpcg_tpu_torch.ops.cuda import chains\n"
           "from lobpcg_tpu_torch.ops.cuda.chains import eager\n"
           "def f(x):\n    return chains.eager() or eager()\n")
    assert switch_sites(src) == [("<module>", "eager"), ("f", "eager"),
                                 ("f", "eager")]


def test_no_module_above_the_kernels_asks_the_eager_switch():
    sites = set()
    for path in sorted(PKG.rglob("*.py")):
        if CUDA in path.parents:
            continue
        rel = path.relative_to(PKG).as_posix()
        sites |= {(rel, where) for where, _ in switch_sites(path.read_text())}
    assert sites == SWITCH_SITES
