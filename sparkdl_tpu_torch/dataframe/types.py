"""Lightweight schema objects returned by ``DataFrame.schema``
(pyspark's StructType/StructField shape, inference-backed); the port's
copy of the JAX package's ``dataframe/types.py``.

This engine's columns are dynamically typed (cells are Python/numpy
values); the schema is INFERRED from the first non-null cell per column
(see ``DataFrame._schema_samples``), not declared. These classes exist
so migrating code that introspects ``df.schema`` — field names, type
names, iteration — keeps working; they are not a type system.
"""

from __future__ import annotations

from typing import Iterator, List

__all__ = ["StructField", "StructType"]


class StructField:
    def __init__(self, name: str, dataType: str, nullable: bool = True):
        self.name = name
        self.dataType = dataType
        self.nullable = nullable

    def __repr__(self) -> str:
        return (
            f"StructField({self.name!r}, {self.dataType!r}, "
            f"nullable={self.nullable})"
        )

    def __eq__(self, other) -> bool:
        return (
            isinstance(other, StructField)
            and (self.name, self.dataType, self.nullable)
            == (other.name, other.dataType, other.nullable)
        )


class StructType:
    def __init__(self, fields: List[StructField]):
        self.fields = list(fields)

    @property
    def names(self) -> List[str]:
        return [f.name for f in self.fields]

    def fieldNames(self) -> List[str]:
        return self.names

    def __iter__(self) -> Iterator[StructField]:
        return iter(self.fields)

    def __len__(self) -> int:
        return len(self.fields)

    def __getitem__(self, key):
        if isinstance(key, str):
            for f in self.fields:
                if f.name == key:
                    return f
            raise KeyError(key)
        return self.fields[key]

    def __repr__(self) -> str:
        return f"StructType({self.fields!r})"

    def __eq__(self, other) -> bool:
        return (
            isinstance(other, StructType) and self.fields == other.fields
        )
