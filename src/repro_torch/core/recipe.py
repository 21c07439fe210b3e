"""Declarative per-site quantization plans: the ``QuantRecipe`` API.

Pure-Python twin of ``repro.core.recipe``.  A :class:`SiteRule` maps a glob
(or regex) over **eager param paths** (``blocks.3.mlp.up``) to a method,
:class:`~repro_torch.models.modules.QSpec` field overrides, or ``skip``;
rules are ordered, first match wins, and a path no rule matches falls
through to the recipe's default ``(method, qspec)``.
:meth:`QuantRecipe.resolve` turns paths into ``{path: SiteSpec}`` once, at
plan time.

Glob matching uses :func:`fnmatch.fnmatchcase`, so ``*`` crosses dots:
``*.mlp.*`` matches ``blocks.7.mlp.up``.  Set ``regex=True`` to match with
:func:`re.search` instead.
"""
from __future__ import annotations

import dataclasses
import fnmatch
import json
import re

from repro_torch.core.compile_cache import canonical_digest
from repro_torch.models.modules import QSpec

# method names a recipe may name (the port's engine implements "cloq"; see
# repro_torch.core.pipeline)
METHODS = ("cloq", "gptq", "loftq", "qlora", "rtn")

# QSpec fields a SiteRule may override (None = inherit the default)
_OVERRIDE_FIELDS = ("bits", "group_size", "rank", "split")


@dataclasses.dataclass(frozen=True)
class SiteRule:
    """One ordered rule: pattern over eager param paths -> overrides."""
    pattern: str
    method: str | None = None
    skip: bool = False
    bits: int | None = None
    group_size: int | None = None
    rank: int | None = None
    split: str | None = None
    regex: bool = False

    def matches(self, path: str) -> bool:
        if self.regex:
            return re.search(self.pattern, path) is not None
        return fnmatch.fnmatchcase(path, self.pattern)


@dataclasses.dataclass(frozen=True)
class SiteSpec:
    """Fully-resolved decision for ONE quantization site."""
    method: str
    qspec: QSpec
    skip: bool = False


@dataclasses.dataclass(frozen=True)
class QuantRecipe:
    """Ordered site rules + the default ``(method, qspec)`` fallback."""
    rules: tuple[SiteRule, ...] = ()
    method: str = "cloq"
    qspec: QSpec = QSpec()

    def __post_init__(self):
        object.__setattr__(self, "rules", tuple(
            SiteRule(**r) if isinstance(r, dict) else r for r in self.rules))
        if self.method not in METHODS:
            raise ValueError(f"unknown default method {self.method!r}; "
                             f"options {METHODS}")
        for r in self.rules:
            if r.method is not None and r.method not in METHODS:
                raise ValueError(f"rule {r.pattern!r}: unknown method "
                                 f"{r.method!r}; options {METHODS}")

    def resolve_one(self, path: str) -> SiteSpec:
        """First-match-wins resolution of one eager param path."""
        for rule in self.rules:
            if not rule.matches(path):
                continue
            if rule.skip:
                return SiteSpec(self.method, self.qspec, skip=True)
            method = rule.method or self.method
            over = {f: getattr(rule, f) for f in _OVERRIDE_FIELDS
                    if getattr(rule, f) is not None}
            return SiteSpec(method, dataclasses.replace(
                self.qspec, method=method, **over))
        return SiteSpec(self.method,
                        dataclasses.replace(self.qspec, method=self.method))

    def resolve(self, paths) -> dict[str, SiteSpec]:
        return {p: self.resolve_one(p) for p in paths}

    @classmethod
    def single(cls, method: str, qspec: QSpec) -> "QuantRecipe":
        """The global ``(method, qspec)`` pair as a zero-rule recipe."""
        return cls(rules=(), method=method, qspec=qspec)

    def to_dict(self) -> dict:
        rules = []
        for r in self.rules:
            d = {"pattern": r.pattern}
            for f in ("method", "bits", "group_size", "rank", "split"):
                if getattr(r, f) is not None:
                    d[f] = getattr(r, f)
            if r.skip:
                d["skip"] = True
            if r.regex:
                d["regex"] = True
            rules.append(d)
        return {"version": 1, "method": self.method,
                "qspec": dataclasses.asdict(self.qspec), "rules": rules}

    @classmethod
    def from_dict(cls, d: dict) -> "QuantRecipe":
        qspec = QSpec(**d.get("qspec", {}))
        return cls(rules=tuple(SiteRule(**r) for r in d.get("rules", ())),
                   method=d.get("method", "cloq"), qspec=qspec)


def plan_fingerprint(plan: dict) -> str:
    """Canonical sha1 of a serialized plan: a recipe dict or a bucket
    manifest (``pipeline.quantization_manifest``).  Key order does not
    matter:

    >>> a = plan_fingerprint({"buckets": [], "axis": "model"})
    >>> a == plan_fingerprint({"axis": "model", "buckets": []})
    True
    >>> len(a)
    40
    """
    return canonical_digest(plan)


def load_plan(path: str) -> QuantRecipe:
    """Load a :class:`QuantRecipe` from either a recipe JSON or a bucket
    manifest JSON that embeds one (under ``"recipe"``).  A checkpoint's
    ``meta.json`` is neither: its manifest sits under ``"bucket_manifest"``
    and it has no ``"rules"``, so it loads as the default recipe, as in the
    JAX package (``ROADMAP.md``)."""
    with open(path) as f:
        d = json.load(f)
    if "buckets" in d:
        if "recipe" not in d:
            raise ValueError(f"{path}: manifest carries no recipe")
        return QuantRecipe.from_dict(d["recipe"])
    return QuantRecipe.from_dict(d)
