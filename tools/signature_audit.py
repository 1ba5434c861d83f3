"""Signature-parity audit: reference public functions vs spatialcore_tpu.

For every name in the reference packages' ``__all__`` (snapshot:
tests/fixtures/reference_exports.json), AST-parse the reference tree
(/root/reference — never imported, only read) to recover the function's
parameter list, resolve the same name in spatialcore_tpu, and diff the
parameter names.  Reports, per function:

  MISSING  reference parameters our callable does not accept (and that
           are not absorbed by **kwargs) — potential behavioral gaps
  EXTRA    parameters we accept that the reference does not — fine
           (knobs specific to this build), listed for the record

Classes are compared on their ``__init__``.  Names that resolve to
non-callables (constants, modules) are skipped.  An allowlist encodes
reviewed, intentional differences so the companion test
(tests/test_signature_parity.py) can assert "no UNREVIEWED missing
parameters" without freezing this build's extensions.

Run:  PYTHONPATH= JAX_PLATFORMS=cpu python tools/signature_audit.py
"""

from __future__ import annotations

import ast
import json
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
REF = Path("/root/reference/src/spatialcore")
EXPORTS = REPO / "tests" / "fixtures" / "reference_exports.json"

# Reviewed, intentional signature differences.  Maps "module.name" to a
# set of reference parameter names we deliberately do not take.  Each
# entry must carry a reason in the comment beside it.
ALLOWED_MISSING: dict[str, set[str]] = {}


def _collect_defs(tree: ast.Module) -> dict[str, ast.AST]:
    """Top-level function and class defs in a parsed module."""
    out: dict[str, ast.AST] = {}
    for node in tree.body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.ClassDef)):
            out[node.name] = node
    return out


def _params_of(node: ast.AST) -> tuple[list[str], bool] | None:
    """Parameter names of a def (or a class's __init__), minus self.

    Returns (names, has_var_kwargs) or None when no signature exists.
    """
    if isinstance(node, ast.ClassDef):
        for sub in node.body:
            if isinstance(sub, ast.FunctionDef) and sub.name == "__init__":
                node = sub
                break
        else:
            return None
    if not isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
        return None
    a = node.args
    names = [p.arg for p in (a.posonlyargs + a.args + a.kwonlyargs)]
    names = [n for n in names if n not in ("self", "cls")]
    return names, a.kwarg is not None


def _index_reference() -> dict[str, tuple[list[str], bool, str]]:
    """name -> (params, has_kwargs, defining file) across the ref tree."""
    idx: dict[str, tuple[list[str], bool, str]] = {}
    for py in sorted(REF.rglob("*.py")):
        try:
            tree = ast.parse(py.read_text())
        except SyntaxError:
            continue
        for name, node in _collect_defs(tree).items():
            sig = _params_of(node)
            if sig is not None and name not in idx:
                idx[name] = (sig[0], sig[1], str(py.relative_to(REF)))
    return idx


def _resolve_ours(modname: str, name: str):
    import spatialcore_tpu as sct

    target = sct if modname == "top" else getattr(sct, modname, None)
    obj = getattr(target, name, None) if target is not None else None
    if obj is None:
        obj = getattr(sct, name, None)
    return obj


def audit() -> list[dict]:
    import inspect

    exports = json.loads(EXPORTS.read_text())
    ref_idx = _index_reference()
    rows: list[dict] = []
    for modname, names in exports.items():
        for name in names:
            if name not in ref_idx:
                continue  # constant / re-export without a local def
            ref_params, ref_kw, ref_file = ref_idx[name]
            ours = _resolve_ours(modname, name)
            if ours is None or not callable(ours):
                continue
            try:
                sig = inspect.signature(ours)
            except (TypeError, ValueError):
                continue
            our_params = [p for p in sig.parameters
                          if p not in ("self", "cls")]
            our_kw = any(p.kind is inspect.Parameter.VAR_KEYWORD
                         for p in sig.parameters.values())
            aliases = getattr(ours, "__param_aliases__", {})
            accepted = set(our_params) | set(aliases)
            missing = [] if our_kw else [
                p for p in ref_params if p not in accepted]
            # our params that merely re-spell a reference param (they are
            # the canonical target of an alias named after it) aren't extra
            respelled = {canon for ali, canon in aliases.items()
                         if ali in ref_params}
            extra = [] if ref_kw else [
                p for p in our_params if p not in ref_params
                and p not in respelled and p not in ("args", "kwargs")]
            allowed = ALLOWED_MISSING.get(f"{modname}.{name}", set())
            rows.append({
                "module": modname, "name": name, "ref_file": ref_file,
                "missing": sorted(set(missing) - allowed),
                "allowed_missing": sorted(set(missing) & allowed),
                "extra": extra,
            })
    return rows


def main() -> int:
    rows = audit()
    bad = [r for r in rows if r["missing"]]
    print(f"audited {len(rows)} public callables against the reference")
    for r in rows:
        if r["missing"] or r["extra"] or r["allowed_missing"]:
            print(f"\n{r['module']}.{r['name']}  (ref {r['ref_file']})")
            if r["missing"]:
                print(f"  MISSING: {', '.join(r['missing'])}")
            if r["allowed_missing"]:
                print(f"  allowed: {', '.join(r['allowed_missing'])}")
            if r["extra"]:
                print(f"  extra  : {', '.join(r['extra'])}")
    print(f"\n{len(bad)} callables with unreviewed missing parameters")
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
