"""AST lint of the port's source (the port's counterpart of
``repro/analysis/lint.py``).

Two rules, each reported as a :class:`~repro_torch.analysis.findings.
Finding` with ``kind`` = the rule id and ``where`` = ``path:line``:

``unhashable-config-field``
    ``RunConfig`` instances key plans and replans, so every field must be
    hashable: annotations and defaults may not use list/dict/set.

``raw-collective``
    Only the modules that own the process groups
    (``PROCESS_GROUP_MODULES``: the collectives, the mesh and the backend
    probe) import the distributed package. Everything else exchanges
    through ``core/collectives.py``, so every collective reaches the
    record that the contract check reads.

The reference's other two rules guard JAX spellings (mesh APIs outside
its compat package, ``custom_vjp`` taps) that the port has no use for.

The rules are AST-based, and this module spells none of the names it
bans: the reference's ``tests/test_compat.py`` scans the raw text of all
of ``src/``, and ``raw-collective`` would otherwise find this file.
"""
from __future__ import annotations

import ast
import os

from repro_torch.analysis.findings import Finding

# the modules that may import the distributed package, relative to src/
PROCESS_GROUP_MODULES = (
    "repro_torch/core/collectives.py",
    "repro_torch/launch/mesh.py",
    "repro_torch/compat.py",
)

_DIST = "torch" + "." + "distributed"
_UNHASHABLE = {"list", "List", "dict", "Dict", "set", "Set"}


def _attr_chain(node: ast.AST) -> str:
    """Dotted name of an attribute chain rooted at a Name, else ''."""
    parts = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return ""


def _rel(path: str, root: str | None) -> str:
    if root:
        try:
            return os.path.relpath(path, root).replace(os.sep, "/")
        except ValueError:
            pass
    return path.replace(os.sep, "/")


# ---------------------------------------------------------------------------
# rule: unhashable-config-field
# ---------------------------------------------------------------------------

def _annotation_unhashable(node: ast.AST) -> bool:
    for sub in ast.walk(node):
        if isinstance(sub, ast.Name) and sub.id in _UNHASHABLE:
            return True
        if isinstance(sub, ast.Attribute) and sub.attr in _UNHASHABLE:
            return True
    return False


def _check_config_hashable(tree: ast.AST, path: str) -> list:
    findings = []
    for node in ast.walk(tree):
        if not (isinstance(node, ast.ClassDef) and node.name == "RunConfig"):
            continue
        for stmt in node.body:
            if not isinstance(stmt, ast.AnnAssign):
                continue
            fname = getattr(stmt.target, "id", "?")
            bad = _annotation_unhashable(stmt.annotation)
            if not bad and stmt.value is not None:
                bad = isinstance(stmt.value,
                                 (ast.List, ast.Dict, ast.Set, ast.ListComp,
                                  ast.DictComp, ast.SetComp))
            if bad:
                findings.append(Finding(
                    "unhashable-config-field",
                    where=f"{path}:{stmt.lineno}", plan_leaf=fname,
                    expected="hashable field type (tuple, not list/dict)",
                    actual=ast.unparse(stmt.annotation),
                    message="RunConfig keys plans and replans"))
    return findings


# ---------------------------------------------------------------------------
# rule: raw-collective
# ---------------------------------------------------------------------------

def _distributed_uses(tree: ast.AST) -> list:
    """(line, what) of every import of the distributed package and every
    attribute chain through it."""
    out = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out += [(node.lineno, f"import {a.name}") for a in node.names
                    if a.name == _DIST or a.name.startswith(_DIST + ".")]
        elif isinstance(node, ast.ImportFrom) and node.module:
            if node.module == _DIST or node.module.startswith(_DIST + "."):
                out.append((node.lineno, f"from {node.module} import ..."))
            elif node.module == "torch" and any(
                    a.name == "distributed" for a in node.names):
                out.append((node.lineno, "from torch import distributed"))
        elif isinstance(node, ast.Attribute):
            chain = _attr_chain(node)
            if chain == _DIST:
                out.append((node.lineno, chain))
    return out


def _check_raw_collectives(tree: ast.AST, rel: str) -> list:
    if any(rel.endswith(m) for m in PROCESS_GROUP_MODULES):
        return []
    seen, findings = set(), []
    for line, what in _distributed_uses(tree):
        if line in seen:
            continue
        seen.add(line)
        findings.append(Finding(
            "raw-collective", where=f"{rel}:{line}",
            expected="collectives through core/collectives.py",
            actual=what,
            message="a collective outside PROCESS_GROUP_MODULES escapes "
                    "the record"))
    return findings


# ---------------------------------------------------------------------------
# entry points
# ---------------------------------------------------------------------------

def lint_file(path: str, root: str | None = None) -> list:
    """Run every rule over one file -> findings (empty = clean)."""
    rel = _rel(path, root)
    try:
        with open(path, encoding="utf-8") as f:
            tree = ast.parse(f.read(), filename=path)
    except SyntaxError as e:
        return [Finding("syntax-error", where=f"{rel}:{e.lineno}",
                        actual=str(e.msg))]
    return (_check_config_hashable(tree, rel)
            + _check_raw_collectives(tree, rel))


def lint_paths(paths, root: str | None = None) -> list:
    """Lint every ``.py`` under the given files/directories."""
    findings = []
    for p in paths:
        if os.path.isfile(p):
            findings += lint_file(p, root)
            continue
        for dirpath, _, names in sorted(os.walk(p)):
            for name in sorted(names):
                if name.endswith(".py"):
                    findings += lint_file(os.path.join(dirpath, name), root)
    return findings


def lint_repo(root: str | None = None) -> list:
    """Lint the port's package, ``src/repro_torch`` under the repo
    ``root`` (the JAX package has its own lint)."""
    if root is None:
        root = os.path.abspath(os.path.join(os.path.dirname(__file__), "..",
                                            "..", ".."))
    return lint_paths([os.path.join(root, "src", "repro_torch")], root)
