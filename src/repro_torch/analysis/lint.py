"""AST lint pass for the failure modes the port guards against.

Rules (each with a bad example in ``tests/test_torch_analysis.py`` and an
allowlist at ``src/repro_torch/analysis/lint_allow.txt``):

``string-option``
    A public function takes an option-like string parameter (``mode``,
    ``direction``, ``backend``, ``semiring``, ``comm``, ``sr_name``,
    ``algorithm``, ``status``) and compares it against string literals
    without validating it through ``check_choice``, ``sm.get`` or the
    config funnel (building an ``EngineConfig``, whose ``__post_init__``
    runs ``check_choice`` on each knob): an unknown value silently falls
    into the default branch.

``f32-vertex-id``
    Vertex ids or labels cast to float32 (``.float()``,
    ``.to(torch.float32)``, ``.astype(np.float32)``, ``dtype=...float32``
    on an id-named value, or a float32 ``arange`` in an id-named function)
    in a file with no ``1 << 24`` guard: float32 carries integers exactly
    only up to 2^24, so bigger graphs silently corrupt ids (``core.cc``
    shows the guarded pattern).

``kernel-contract``
    A function in ``repro_torch/kernels`` that launches a ``Kernel``
    (``.launch(``) without the ``@kernel_contract`` registration
    decorator: unregistered kernels escape the contract checker, so
    coverage would silently rot. (The JAX package's rule looks for
    ``pallas_call``.)

``packed-constants``
    A packed-word bit-twiddling constant (``>> 5`` / ``<< 5``, ``& 31``,
    ``0xFFFFFFFF``) outside ``core/packing.py``. The packing module is the
    single home of the 32-bit word geometry; a re-derived constant
    elsewhere is how a word-width change or a 31/32 off-by-one forks the
    layout. **Allowlist-free**: the only fix is routing through
    ``packing.word_of`` / ``packing.bit_of`` / ``packing.FULL_WORD``.

The JAX package's ``traced-branch`` and ``interpret-literal`` rules have no
counterpart here: the port traces nothing (PyTorch runs eagerly, so a
Python branch on a tensor reads its value, correctly) and has no Pallas
interpret mode (a tensor's device picks the kernel or its plain version).

CLI::

    python -m repro_torch.analysis.lint [paths...]   # default: src/repro_torch

Allowlist entries are ``rule:path`` or ``rule:path::qualname`` lines
(repo-relative forward-slash paths, ``#`` comments). Exit 0 iff no
finding survives the allowlist.
"""
from __future__ import annotations

import ast
import dataclasses
import pathlib
import re
import sys
from typing import List, Optional, Sequence, Set

OPTION_PARAMS = {"mode", "direction", "backend", "semiring", "comm",
                 "sr_name", "algorithm", "status"}
VALIDATOR_CALLS = {"check_choice", "get", "EngineConfig"}
ID_HINTS = {"id", "ids", "label", "labels", "vertex", "vertices", "parent",
            "parents"}
F32_GUARDS = ("1 << 24", "2 ** 24", "2**24", "16777216")


def _idish(name: str) -> bool:
    """True when a name plausibly denotes vertex ids or labels (word-part
    match, so ``valid`` does not match ``id``)."""
    for part in re.split(r"[^a-z]+", name.lower()):
        if part.rstrip("0123456789") in ID_HINTS:
            return True
    return False


@dataclasses.dataclass(frozen=True)
class Finding:
    rule: str
    path: str        # repo-relative, forward slashes
    line: int
    qualname: str
    message: str

    def key_candidates(self) -> List[str]:
        return [f"{self.rule}:{self.path}::{self.qualname}",
                f"{self.rule}:{self.path}"]

    def __str__(self) -> str:
        return (f"{self.path}:{self.line}: [{self.rule}] {self.qualname}: "
                f"{self.message}")


def _dotted(node: ast.AST) -> str:
    """Best-effort dotted name of a call target / decorator."""
    if isinstance(node, ast.Attribute):
        return f"{_dotted(node.value)}.{node.attr}"
    if isinstance(node, ast.Name):
        return node.id
    if isinstance(node, ast.Call):
        return _dotted(node.func)
    return ""


def _call_names(tree: ast.AST) -> Set[str]:
    """Last components of every call target inside ``tree``."""
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Call):
            dotted = _dotted(node.func)
            if dotted:
                names.add(dotted.split(".")[-1])
    return names


def _params(func: ast.FunctionDef) -> List[ast.arg]:
    a = func.args
    return list(a.posonlyargs) + list(a.args) + list(a.kwonlyargs)


def _functions(tree: ast.Module):
    """(qualname, node) for every function, including nested / methods."""
    out = []

    def visit(node, prefix):
        for child in ast.iter_child_nodes(node):
            if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef)):
                q = f"{prefix}{child.name}"
                out.append((q, child))
                visit(child, f"{q}.")
            elif isinstance(child, ast.ClassDef):
                visit(child, f"{prefix}{child.name}.")
            else:
                visit(child, prefix)

    visit(tree, "")
    return out


# ------------------------------------------------------------------- rules


def _rule_string_option(path, src, tree, findings):
    for qual, func in _functions(tree):
        if func.name.startswith("_"):
            continue  # private helpers validate at their public boundary
        params = {a.arg for a in _params(func)} & OPTION_PARAMS
        if not params:
            continue
        if _call_names(func) & VALIDATOR_CALLS:
            continue
        for node in ast.walk(func):
            if not isinstance(node, ast.Compare):
                continue
            operands = [node.left] + list(node.comparators)
            names = {o.id for o in operands if isinstance(o, ast.Name)}
            has_str = any(isinstance(o, ast.Constant)
                          and isinstance(o.value, str) for o in operands)
            hit = names & params
            if hit and has_str:
                findings.append(Finding(
                    "string-option", path, node.lineno, qual,
                    f"dispatch on option parameter {sorted(hit)[0]!r} "
                    f"without validating against core.options (unknown "
                    f"values silently fall through; call check_choice)"))
                break


def _is_f32(node: ast.AST) -> bool:
    return _dotted(node).endswith("float32")


def _base_name(node: ast.AST) -> str:
    """The name a method is called on (``ids`` of ``ids.float()``)."""
    if isinstance(node, ast.Name):
        return node.id
    if isinstance(node, ast.Attribute):
        return node.attr
    return ""


def _rule_f32_vertex_id(path, src, tree, findings):
    if any(g in src for g in F32_GUARDS):
        return  # the file knows about the 2^24 limit
    for qual, func in _functions(tree):
        for node in ast.walk(func):
            if not isinstance(node, ast.Call):
                continue
            dotted = _dotted(node.func)
            last = dotted.split(".")[-1]
            kw_f32 = any(kw.arg == "dtype" and _is_f32(kw.value)
                         for kw in node.keywords)
            name = ""
            if isinstance(node.func, ast.Attribute) and last in (
                    "float", "to", "astype"):
                # only a *direct* cast of an id-named array (not of a
                # comparison or mask derived from it)
                cast = last == "float" or kw_f32 \
                    or any(_is_f32(a) for a in node.args)
                if cast and _idish(_base_name(node.func.value)):
                    name = _base_name(node.func.value)
            elif last == "arange" and kw_f32:
                if _idish(qual):
                    name = "arange"   # float32 ids minted in an id function
            elif kw_f32 and node.args and _idish(_base_name(node.args[0])):
                name = _base_name(node.args[0])
            if name:
                findings.append(Finding(
                    "f32-vertex-id", path, node.lineno, qual,
                    f"vertex-id-like value {name!r} cast to float32 with "
                    f"no 2^24 guard in this file (ids above 16777216 "
                    f"round; see core.cc for the guarded pattern)"))


def _rule_kernel_contract(path, src, tree, findings):
    if "kernels" not in path.split("/")[:-1]:
        return
    for qual, func in _functions(tree):
        launches = any(isinstance(node, ast.Call)
                       and isinstance(node.func, ast.Attribute)
                       and node.func.attr == "launch"
                       for node in ast.walk(func))
        if not launches:
            continue
        decorated = any(
            _dotted(d).split(".")[-1] == "kernel_contract"
            for d in func.decorator_list)
        if not decorated:
            findings.append(Finding(
                "kernel-contract", path, func.lineno, qual,
                "Kernel launch without @kernel_contract: it escapes the "
                "contract checker (register cases in "
                "repro_torch.analysis.registry)"))


def _rule_packed_constants(path, src, tree, findings):
    """Bit-twiddling constants of the packed word layout (``>> 5`` /
    ``<< 5``, ``& 31``, ``0xFFFFFFFF``) outside ``core/packing.py``: the
    packing module is the single home of the 32-bit word geometry. This
    rule is allowlist-free by design: route the arithmetic through
    ``core.packing`` helpers."""
    if path.replace("\\", "/").endswith("core/packing.py"):
        return
    for node in ast.walk(tree):
        ops = []
        if isinstance(node, (ast.BinOp, ast.AugAssign)):
            rhs = node.right if isinstance(node, ast.BinOp) else node.value
            if isinstance(node.op, (ast.RShift, ast.LShift)) \
                    and isinstance(rhs, ast.Constant) and rhs.value == 5:
                ops.append("word-index shift by 5")
            if isinstance(node.op, ast.BitAnd):
                sides = [rhs] + ([node.left] if isinstance(node, ast.BinOp)
                                 else [])
                if any(isinstance(s, ast.Constant) and s.value == 31
                       for s in sides):
                    ops.append("bit-offset mask & 31")
        elif isinstance(node, ast.Constant) \
                and not isinstance(node.value, bool) \
                and node.value == (1 << 32) - 1:
            ops.append("all-ones word 0xFFFFFFFF")
        for what in ops:
            findings.append(Finding(
                "packed-constants", path, node.lineno, "-",
                f"packed-word bit constant ({what}) outside core/packing "
                f"— use packing.word_of/bit_of/FULL_WORD; this rule has no "
                f"allowlist"))


RULES = (_rule_string_option, _rule_f32_vertex_id, _rule_kernel_contract,
         _rule_packed_constants)
RULE_NAMES = ("string-option", "f32-vertex-id", "kernel-contract",
              "packed-constants")

# rules the allowlist can NEVER silence: their fix is always "route through
# the canonical module", so an allowlist entry would just institutionalize
# the fork
NO_ALLOW_RULES = frozenset({"packed-constants"})


# --------------------------------------------------------------- allowlist


def load_allowlist(path: pathlib.Path) -> Set[str]:
    if not path.exists():
        return set()
    entries = set()
    for line in path.read_text().splitlines():
        line = line.split("#", 1)[0].strip()
        if line:
            entries.add(line)
    return entries


def _repo_rel(p: pathlib.Path, root: pathlib.Path) -> str:
    try:
        return p.resolve().relative_to(root.resolve()).as_posix()
    except ValueError:
        return p.as_posix()


def lint_file(p: pathlib.Path, root: pathlib.Path) -> List[Finding]:
    src = p.read_text()
    try:
        tree = ast.parse(src, filename=str(p))
    except SyntaxError as e:
        return [Finding("syntax", _repo_rel(p, root), e.lineno or 0, "-",
                        f"syntax error: {e.msg}")]
    findings: List[Finding] = []
    rel = _repo_rel(p, root)
    for rule in RULES:
        rule(rel, src, tree, findings)
    return findings


def lint_paths(paths: Sequence[pathlib.Path], root: pathlib.Path,
               allow: Set[str],
               used: Optional[Set[str]] = None) -> List[Finding]:
    """Lint every file under ``paths``; findings whose key is in ``allow``
    are dropped (and recorded in ``used`` so callers can report allowlist
    entries that no longer match anything)."""
    files: List[pathlib.Path] = []
    for p in paths:
        files.extend(sorted(p.rglob("*.py")) if p.is_dir() else [p])
    out = []
    for f in files:
        for finding in lint_file(f, root):
            if finding.rule in NO_ALLOW_RULES:
                out.append(finding)
                continue
            hits = [k for k in finding.key_candidates() if k in allow]
            if hits:
                if used is not None:
                    used.update(hits)
            else:
                out.append(finding)
    return out


def repo_root() -> pathlib.Path:
    # src/repro_torch/analysis/lint.py: the repo root is three above src
    return pathlib.Path(__file__).resolve().parents[3]


def main(argv: Optional[Sequence[str]] = None) -> int:
    import argparse
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("paths", nargs="*",
                    help="files/dirs (default src/repro_torch)")
    ap.add_argument("--allowlist", default=None,
                    help="allowlist file (default src/repro_torch/analysis/"
                         "lint_allow.txt)")
    args = ap.parse_args(argv)
    root = repo_root()
    paths = [pathlib.Path(p) for p in args.paths] \
        or [root / "src" / "repro_torch"]
    allow_path = pathlib.Path(args.allowlist) if args.allowlist \
        else pathlib.Path(__file__).with_name("lint_allow.txt")
    allow = load_allowlist(allow_path)
    used: Set[str] = set()
    findings = lint_paths(paths, root, allow, used)
    for f in findings:
        print(f)
    stale = sorted(allow - used) if not args.paths else []
    for entry in stale:  # only when linting the default tree
        print(f"stale allowlist entry (matches nothing): {entry}")
    if findings or stale:
        print(f"\n{len(findings)} lint finding(s), {len(stale)} stale "
              f"allowlist entrie(s) (allowlist: {allow_path})")
        return 1
    print(f"lint OK ({', '.join(RULE_NAMES)})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
