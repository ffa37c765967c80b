"""Feature schema binding: the port's copy of ``avenir_tpu/core/schema.py``.

Reads the same JSON metadata files (e.g. ``resource/churn_nb/
teleComChurn.json``) into ``FeatureSchema``/``FeatureField``:

- ``feature``: participates as a predictor;
- ``id``: record identifier, passed through;
- class attribute: a field that is neither feature nor id, or one marked
  ``"classAttr": true``;
- categorical fields carry an optional ``cardinality`` (list of values);
- numeric fields may carry ``bucketWidth`` (bin = value / bucketWidth,
  truncated toward zero), ``min``/``max``, ``splitScanInterval`` and
  ``maxSplit``.

``CostSchema`` reads an attribute-change cost file (``CostAttribute``
per attribute: name, ordinal, cost).
"""

from __future__ import annotations

import json
from dataclasses import dataclass, field as dc_field
from typing import Any, Dict, List, Optional


@dataclass
class FeatureField:
    name: str = ""
    ordinal: int = -1
    dataType: str = "string"
    feature: bool = False
    id: bool = False
    classAttr: bool = False
    cardinality: List[str] = dc_field(default_factory=list)
    bucketWidth: Optional[int] = None
    min: Optional[float] = None
    max: Optional[float] = None
    splitScanInterval: Optional[float] = None
    maxSplit: Optional[int] = None
    # every other JSON key is kept as it came
    extra: Dict[str, Any] = dc_field(default_factory=dict)

    _KNOWN = {
        "name", "ordinal", "dataType", "feature", "id", "classAttr",
        "cardinality", "bucketWidth", "min", "max", "splitScanInterval",
        "maxSplit",
    }

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "FeatureField":
        f = cls()
        for k, v in d.items():
            if k in cls._KNOWN:
                setattr(f, k, v)
            else:
                f.extra[k] = v
        if f.cardinality is None:
            f.cardinality = []
        return f

    def is_feature(self) -> bool:
        return bool(self.feature)

    def is_id(self) -> bool:
        return bool(self.id)

    def is_categorical(self) -> bool:
        return self.dataType == "categorical"

    def is_integer(self) -> bool:
        return self.dataType == "int"

    def is_double(self) -> bool:
        return self.dataType == "double"

    def is_numeric(self) -> bool:
        return self.dataType in ("int", "double")

    def is_bucket_width_defined(self) -> bool:
        return self.bucketWidth is not None and self.bucketWidth > 0

    def is_class_attr(self) -> bool:
        # the explicit flag wins; otherwise "neither feature nor id", as in
        # chombo
        return bool(self.classAttr) or (not self.feature and not self.id)

    def num_bins(self) -> int:
        """Static bin count for the dense count tensors.

        Categorical: vocabulary size (from cardinality, else discovered).
        Bucketed numeric: max // bucketWidth + 1 (requires max).
        """
        if self.is_categorical():
            return len(self.cardinality)
        if self.is_bucket_width_defined():
            if self.max is None:
                raise ValueError(
                    f"field {self.name}: bucketWidth without max; cannot size bins")
            return int(self.max) // int(self.bucketWidth) + 1
        return 0


class FeatureSchema:
    """Parsed feature-schema JSON; the metadata object every job uses."""

    def __init__(self, fields: List[FeatureField]):
        self.fields = fields

    @classmethod
    def from_json(cls, text: str) -> "FeatureSchema":
        d = json.loads(text)
        return cls([FeatureField.from_dict(f) for f in d.get("fields", [])])

    @classmethod
    def from_file(cls, path: str) -> "FeatureSchema":
        # through core.io.read_lines, so that a schema written by a
        # workflow stage (core.dag's FeatureSelect) comes from the
        # in-memory artifact overlay when one is installed
        from .io import read_lines
        return cls.from_json("\n".join(read_lines(path)))

    def get_fields(self) -> List[FeatureField]:
        return self.fields

    def feature_fields(self) -> List[FeatureField]:
        return [f for f in self.fields if f.is_feature()]

    def id_field(self) -> Optional[FeatureField]:
        for f in self.fields:
            if f.is_id():
                return f
        return None

    def class_attr_field(self) -> FeatureField:
        explicit = [f for f in self.fields if f.classAttr]
        if explicit:
            return explicit[0]
        implicit = [f for f in self.fields if not f.feature and not f.id]
        if not implicit:
            raise ValueError("schema has no class attribute field")
        return implicit[-1]

    def field_by_ordinal(self, ordinal: int) -> FeatureField:
        for f in self.fields:
            if f.ordinal == ordinal:
                return f
        raise KeyError(f"no field with ordinal {ordinal}")

    def field_by_name(self, name: str) -> FeatureField:
        for f in self.fields:
            if f.name == name:
                return f
        raise KeyError(f"no field named {name}")

    def max_ordinal(self) -> int:
        return max(f.ordinal for f in self.fields)


@dataclass
class CostAttribute:
    """One attribute's change cost (util/CostSchema.java:43-77 equivalent)."""
    name: str = ""
    ordinal: int = -1
    cost: float = 0.0
    extra: Dict[str, Any] = dc_field(default_factory=dict)


class CostSchema:
    """Attribute-change cost metadata (util/CostSchema.java equivalent)."""

    def __init__(self, attributes: List[CostAttribute]):
        self.attributes = attributes

    @classmethod
    def from_file(cls, path: str) -> "CostSchema":
        with open(path, "r") as fh:
            d = json.load(fh)
        attrs = []
        for a in d.get("attributes", d.get("costAttributes", [])):
            ca = CostAttribute()
            for k, v in a.items():
                if hasattr(ca, k) and k != "extra":
                    setattr(ca, k, v)
                else:
                    ca.extra[k] = v
            attrs.append(ca)
        return cls(attrs)

    def cost_by_ordinal(self, ordinal: int) -> float:
        for a in self.attributes:
            if a.ordinal == ordinal:
                return a.cost
        raise KeyError(f"no cost attribute with ordinal {ordinal}")
