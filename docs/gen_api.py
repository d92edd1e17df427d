"""Regenerate docs/api.md from package docstrings.

Usage: python docs/gen_api.py
"""

import inspect
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import jax

jax.config.update("jax_platforms", "cpu")


def main():
    import landhydrology.adaptive as adaptive
    import landhydrology.checkpoint as ckpt
    import landhydrology.cli as cli
    import landhydrology.config as config
    import landhydrology.constants as con
    import landhydrology.diagnostics as diag
    import landhydrology.domains as dom
    import landhydrology.imex as imex
    import landhydrology.models.land as land
    import landhydrology.models.soil as soil
    import landhydrology.models.soil.freeze_thaw as ft
    import landhydrology.models.soil.heat as heat
    import landhydrology.models.soil.surface_fluxes as sf
    import landhydrology.models.soil.water as water
    import landhydrology.ops.stencil as st
    import landhydrology.ops.tridiag as td
    import landhydrology.parallel.halo as ph
    import landhydrology.parallel.mesh as pm
    import landhydrology.parallel.stepping as pst
    import landhydrology.segment as segment
    import landhydrology.runtime.io as rio
    import landhydrology.simulations as sims
    import landhydrology.timestepping as ts

    sections = [
        ("landhydrology.constants", con),
        ("landhydrology.domains", dom),
        ("models.soil (water)", water),
        ("models.soil (heat)", heat),
        ("models.soil (model/BCs)", soil),
        ("models.land", land),
        ("models.soil.surface_fluxes", sf),
        ("models.soil.freeze_thaw", ft),
        ("ops.stencil", st),
        ("ops.tridiag", td),
        ("segment", segment),
        ("timestepping", ts),
        ("adaptive", adaptive),
        ("imex", imex),
        ("simulations", sims),
        ("parallel.mesh", pm),
        ("parallel.halo", ph),
        ("parallel.stepping", pst),
        ("checkpoint", ckpt),
        ("diagnostics", diag),
        ("runtime.io", rio),
        ("config", config),
        ("cli", cli),
    ]
    lines = [
        "# API reference",
        "",
        "Auto-generated from docstring first lines (`python docs/gen_api.py`).",
        "",
    ]
    for title, mod in sections:
        lines.append(f"## {title}\n")
        for name in sorted(dir(mod)):
            if name.startswith("_"):
                continue
            obj = getattr(mod, name)
            if inspect.ismodule(obj):
                continue
            if getattr(obj, "__module__", "").startswith("landhydrology") and (
                inspect.isclass(obj) or inspect.isfunction(obj)
            ):
                if obj.__module__ != mod.__name__:
                    continue
                doc = (inspect.getdoc(obj) or "").split("\n")[0]
                kind = "class" if inspect.isclass(obj) else "def"
                lines.append(f"- **`{kind} {name}`** — {doc}")
        lines.append("")
    out = os.path.join(os.path.dirname(__file__), "api.md")
    with open(out, "w") as f:
        f.write("\n".join(lines))
    print(f"wrote {out}")


if __name__ == "__main__":
    main()
