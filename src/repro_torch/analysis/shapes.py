"""Shape-contract fleet of the port, held against the JAX package's goldens.

The JAX package pins its planner/recipe/layout stack with one golden
manifest per ``(arch, recipe)`` cell under ``tests/golden/shapes/``
(``repro.analysis.shapes``, regenerated by ``tools/check_static.py
--update-golden``).  This module builds the same entries from the port's
own code on the meta device — no weights, no calibration, no FLOPs —
through

* ``pipeline.quantizable_linear_paths`` + ``QuantRecipe.resolve``
  (the **site contract**: which paths quantize, to what spec),
* ``pipeline.quantization_manifest`` (the **planner contract**: bucket
  specs, task→bucket assignment),
* ``pipeline.quantized_param_shapes`` / ``launch.steps.abstract_params``
  (the **layout contract**: every post-quantization leaf shape and
  dtype, asserted identical between the two builders), and
* ``pipeline.recipe_plan_bytes`` (the **byte contract** the allocator
  and ``--budget-mb`` rely on),

serializes each with the JAX package's key order (torch dtypes written
as numpy names: ``float32``, ``uint8``, ``bfloat16``) and diffs it
against those goldens.  The goldens are the JAX package's and are only
read here: a cell that differs is a fault of the port, and
``run_fleet(update=True)`` raises.

Smoke configs are used (the full configs share every code path).
"""
from __future__ import annotations

import json
from pathlib import Path

# recipe grid: small, layer-uniform (every config in the zoo defaults to
# scan_layers=True, so depth-dependent rules would be rejected at plan
# time), and covering the planner's spec axes: mixed methods, mixed
# bits/ranks, a skipped family, and a data-free method.
RECIPE_KEYS = ("cloq_int4", "mixed_mlp2_attn4", "rtn3_skip_mlp")


def fit_group(cfg, base: int = 32) -> int:
    """Largest divisor of ``base`` that divides every quantizable site's
    in-features under ``cfg`` — smoke configs have odd widths (minicpm's
    72, the MoE experts' 32), and a quantization group must divide m."""
    import math
    from repro_torch.core.pipeline import (_abstract_eager_shapes,
                                           quantizable_linear_paths)
    from repro_torch.utils import get_path
    eshapes = _abstract_eager_shapes(cfg)
    g = base
    for p in quantizable_linear_paths(eshapes):
        m = get_path(eshapes, p)["w"].shape[-2]
        g = math.gcd(g, m)
    return max(g, 1)


def recipe_grid(group_size: int = 32):
    """``{key: QuantRecipe}`` — built lazily so importing the module does
    not import the model code.  ``group_size`` comes from
    :func:`fit_group` when building per-arch entries."""
    from repro_torch.core.recipe import QuantRecipe, SiteRule
    from repro_torch.models.modules import QSpec
    g = group_size
    return {
        "cloq_int4": QuantRecipe(method="cloq",
                                 qspec=QSpec(bits=4, rank=16,
                                             group_size=g)),
        "mixed_mlp2_attn4": QuantRecipe(
            rules=(SiteRule("*.mlp.*", bits=2, rank=32),
                   SiteRule("*.attn.*", bits=4, rank=16),
                   SiteRule("*.xattn.*", bits=4, rank=16)),
            method="cloq", qspec=QSpec(bits=4, rank=16, group_size=g)),
        "rtn3_skip_mlp": QuantRecipe(
            rules=(SiteRule("*.mlp.*", skip=True),),
            method="rtn", qspec=QSpec(bits=3, rank=8, group_size=g)),
    }


def fleet_cells() -> list[tuple[str, str]]:
    from repro_torch.configs import ARCH_IDS
    return [(arch, rk) for arch in ARCH_IDS for rk in RECIPE_KEYS]


def _dtype_name(dt) -> str:
    """A torch dtype as the numpy name the goldens carry."""
    return str(dt).removeprefix("torch.")


def build_entry(arch: str, recipe_key: str) -> dict:
    """One golden entry: the full static contract of ``(arch, recipe)``.

    Also cross-checks ``launch.steps.abstract_params`` against
    ``quantized_param_shapes`` — the two abstract builders must agree
    leaf-for-leaf or the dry-run and the engine are planning different
    layouts."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.core.pipeline import (quantizable_linear_paths,
                                           quantized_param_shapes,
                                           recipe_plan_bytes,
                                           _abstract_eager_shapes)
    from repro_torch.launch.steps import abstract_params
    from repro_torch.utils import tree_paths

    cfg = get_smoke_config(arch)
    recipe = recipe_grid(fit_group(cfg))[recipe_key]

    eshapes = _abstract_eager_shapes(cfg)
    sites = recipe.resolve(quantizable_linear_paths(eshapes))
    shapes, manifest = quantized_param_shapes(cfg, recipe=recipe,
                                              with_manifest=True)
    ab = abstract_params(cfg, recipe=recipe)
    flat, flat_ab = tree_paths(shapes), tree_paths(ab)
    if {p: (tuple(s.shape), str(s.dtype)) for p, s in flat.items()} != \
            {p: (tuple(s.shape), str(s.dtype)) for p, s in flat_ab.items()}:
        raise AssertionError(
            f"{arch}/{recipe_key}: steps.abstract_params disagrees with "
            "pipeline.quantized_param_shapes — dry-run and engine are "
            "planning different layouts")

    buckets = sorted(
        ({"spec": b["spec"],
          "tasks": sorted(b["tasks"],
                          key=lambda t: (t["path"], t["expert"] or -1))}
         for b in manifest["buckets"]),
        key=lambda b: json.dumps(b["spec"], sort_keys=True))
    return {
        "arch": arch,
        "recipe_key": recipe_key,
        "recipe": recipe.to_dict(),
        "sites": {
            p: ({"skip": True} if s.skip else
                {"method": s.method, "bits": s.qspec.bits,
                 "group_size": s.qspec.group_size, "rank": s.qspec.rank,
                 "split": s.qspec.split})
            for p, s in sorted(sites.items())},
        "buckets": buckets,
        "axis": manifest["axis"],
        "site_lora": manifest.get("site_lora", []),
        "stacked": manifest.get("stacked", []),
        "shapes": {p: [list(map(int, s.shape)), _dtype_name(s.dtype)]
                   for p, s in sorted(flat.items())},
        "plan_bytes": int(recipe_plan_bytes(cfg, recipe)),
    }


def entry_path(golden_dir: str | Path, arch: str, recipe_key: str) -> Path:
    return Path(golden_dir) / f"{arch}__{recipe_key}.json"


def diff_entries(golden: dict, built: dict, prefix: str = "") -> list[str]:
    """Field-level structural diff, recursive over dicts; lists compare
    whole (the planner emits them canonically ordered)."""
    diffs: list[str] = []
    keys = sorted(set(golden) | set(built))
    for k in keys:
        at = f"{prefix}.{k}" if prefix else k
        if k not in golden:
            diffs.append(f"{at}: new field (not in golden)")
        elif k not in built:
            diffs.append(f"{at}: missing (in golden, not rebuilt)")
        elif isinstance(golden[k], dict) and isinstance(built[k], dict):
            diffs.extend(diff_entries(golden[k], built[k], at))
        elif golden[k] != built[k]:
            g, b = json.dumps(golden[k]), json.dumps(built[k])
            if len(g) > 120:
                g = g[:117] + "..."
            if len(b) > 120:
                b = b[:117] + "..."
            diffs.append(f"{at}: golden {g} != built {b}")
    return diffs


def run_fleet(golden_dir: str | Path, *, update: bool = False,
              cells=None, progress=None) -> list[str]:
    """Build every fleet cell from the port and diff it against the JAX
    package's golden.

    Returns a list of error strings, empty when the port meets every
    committed contract.  The goldens belong to the JAX package:
    ``update=True`` raises and writes nothing."""
    if update:
        raise ValueError(
            "the shape goldens are the JAX package's: regenerate them with "
            "tools/check_static.py --update-golden; a cell where the port "
            "differs is a fault of the port")
    errors: list[str] = []
    for arch, rk in (cells or fleet_cells()):
        name = f"{arch}__{rk}"
        if progress:
            progress(name)
        try:
            entry = build_entry(arch, rk)
        except Exception as e:                # noqa: BLE001 — one cell's
            errors.append(f"{name}: build failed: {e!r}")   # failure must
            continue                          # not hide the other cells
        path = entry_path(golden_dir, arch, rk)
        if not path.exists():
            errors.append(f"{name}: missing golden {path} (the JAX "
                          "package's tools/check_static.py --update-golden "
                          "writes it)")
            continue
        golden = json.loads(path.read_text())
        for d in diff_entries(golden, entry):
            errors.append(f"{name}: {d}")
    return errors
