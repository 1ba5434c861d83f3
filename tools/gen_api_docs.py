#!/usr/bin/env python
"""Generate per-subpackage API reference pages (docs/api/*.md).

mkdocstrings is not available in this environment, so the API pages are
generated from the live package (signatures via ``inspect.signature``,
full docstrings verbatim) and committed. Re-run after changing any public
surface:

    JAX_PLATFORMS=cpu python tools/gen_api_docs.py

The docs CI builds with ``mkdocs build --strict``, so broken nav entries
fail loudly. Matches the reference's per-module API depth
(/root/reference/docs/celltyping/api.md).
"""

from __future__ import annotations

import importlib
import inspect
import sys
from pathlib import Path

OUT = Path(__file__).resolve().parent.parent / "docs" / "api"

SECTIONS = [
    ("core", "spatialcore_tpu.core",
     "Container, IO, logging, provenance, caching, gene maps, "
     "normalization detection, counter-based RNG."),
    ("spatial", "spatialcore_tpu.spatial",
     "The statistics layer: autocorrelation, neighborhoods, niches, "
     "domains, distances, point-pattern statistics."),
    ("stats", "spatialcore_tpu.stats",
     "Metagene scores, KS/GMM thresholds, classification, DEG."),
    ("annotation", "spatialcore_tpu.annotation",
     "Cell-typing pipeline: reference combination, balancing, LR "
     "training, annotation, confidence, ontology mapping."),
    ("plotting", "spatialcore_tpu.plotting",
     "QC and validation figures."),
    ("parallel", "spatialcore_tpu.parallel",
     "Mesh construction and sharded statistics for multi-chip scaling."),
    ("ops", "spatialcore_tpu.ops",
     "Device kernels: graphs, Moran/Lee/Geary/Getis, banded nulls, "
     "streaming, k-means, Ripley, geometry."),
    ("utils", "spatialcore_tpu.utils",
     "Sparse helpers and profiling."),
]

# ops/utils are not facade re-exports; document their public modules
MODULE_SECTIONS = {
    "ops": ["graph", "moran", "lee", "banded", "streaming", "getis",
            "fdr", "kmeans", "ripley", "geometry"],
    "utils": ["sparse", "profiling"],
}


def _sig(obj) -> str:
    try:
        return str(inspect.signature(obj))
    except (TypeError, ValueError):
        return "(...)"


def _doc(obj) -> str:
    d = inspect.getdoc(obj)
    return d if d else "*(no docstring)*"


def _entry(name: str, obj, level: str = "###") -> list[str]:
    lines = []
    if inspect.isclass(obj):
        lines.append(f"{level} `{name}`\n")
        lines.append(f"```python\nclass {name}{_sig(obj)}\n```\n")
        lines.append(_doc(obj) + "\n")
        for mname, m in sorted(vars(obj).items()):
            if mname.startswith("_") or not callable(m):
                continue
            lines.append(f"- **`.{mname}{_sig(m)}`** — "
                         f"{(_doc(m).splitlines() or [''])[0]}")
        lines.append("")
    elif callable(obj):
        lines.append(f"{level} `{name}`\n")
        lines.append(f"```python\n{name}{_sig(obj)}\n```\n")
        lines.append(_doc(obj) + "\n")
    return lines


def _public_names(mod):
    names = getattr(mod, "__all__", None)
    if names is None:
        names = [n for n in dir(mod) if not n.startswith("_")]
    out = []
    for n in names:
        obj = getattr(mod, n, None)
        if obj is None or inspect.ismodule(obj):
            continue
        if not (callable(obj) or inspect.isclass(obj)):
            continue
        home = getattr(obj, "__module__", "") or ""
        if not home.startswith("spatialcore_tpu"):
            continue
        out.append((n, obj))
    return out


def gen_section(slug: str, modpath: str, blurb: str) -> str:
    mod = importlib.import_module(modpath)
    lines = [f"# API: `{modpath}`\n", blurb + "\n"]
    if slug in MODULE_SECTIONS:
        for sub in MODULE_SECTIONS[slug]:
            sm = importlib.import_module(f"{modpath}.{sub}")
            lines.append(f"## `{modpath}.{sub}`\n")
            head = (inspect.getdoc(sm) or "").split("\n\n")[0]
            if head:
                lines.append(head + "\n")
            for n, obj in _public_names(sm):
                if getattr(obj, "__module__", "") != sm.__name__:
                    continue
                lines += _entry(n, obj)
    else:
        for n, obj in _public_names(mod):
            lines += _entry(n, obj)
    return "\n".join(lines) + "\n"


def main():
    OUT.mkdir(parents=True, exist_ok=True)
    index = ["# API reference\n",
             "Per-subpackage reference generated from the live package "
             "signatures and docstrings (tools/gen_api_docs.py).\n"]
    for slug, modpath, blurb in SECTIONS:
        text = gen_section(slug, modpath, blurb)
        (OUT / f"{slug}.md").write_text(text)
        n_entries = text.count("\n### ") + text.count("\n## `")
        index.append(f"- [`{modpath}`]({slug}.md) — {blurb} "
                     f"({n_entries} documented entries)")
        print(f"docs/api/{slug}.md: {n_entries} entries")
    (OUT / "index.md").write_text("\n".join(index) + "\n")


if __name__ == "__main__":
    sys.exit(main())
