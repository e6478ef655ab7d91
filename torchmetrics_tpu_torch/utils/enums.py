"""Enums used across the framework (the port's own copy of the JAX package's
``utils/enums.py``; only what the classification slice uses)."""
from __future__ import annotations

from enum import Enum


class EnumStr(str, Enum):
    """Base enum that compares/parses case-insensitively against strings."""

    @staticmethod
    def _name() -> str:
        return "Task"

    @classmethod
    def from_str(cls, value: str) -> "EnumStr":
        try:
            return cls[value.replace("-", "_").upper()]
        except KeyError:
            valid = [m.lower() for m in cls.__members__]
            raise ValueError(
                f"Invalid {cls._name()}: expected one of {valid}, but got {value}."
            ) from None

    def __str__(self) -> str:
        return self.value.lower()

    def __eq__(self, other: object) -> bool:
        if isinstance(other, str):
            return self.value.lower() == other.lower()
        return Enum.__eq__(self, other)

    def __hash__(self) -> int:
        return hash(self.value.lower())


class AverageMethod(EnumStr):
    """Averaging strategy for multi-class reductions."""

    MICRO = "micro"
    MACRO = "macro"
    WEIGHTED = "weighted"
    NONE = "none"
    SAMPLES = "samples"


class ClassificationTask(EnumStr):
    """Classification task dispatch values."""

    BINARY = "binary"
    MULTICLASS = "multiclass"
    MULTILABEL = "multilabel"
