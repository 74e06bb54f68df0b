"""Free-form plugin arguments (reference ``framework/arguments.go:26-66``)."""

from __future__ import annotations

from typing import Dict, Optional


class Arguments(Dict[str, str]):
    """``map[string]string`` with typed getters; missing/invalid keeps the default."""

    def get_int(self, key: str, default: int) -> int:
        val = self.get(key)
        if val is None or val == "":
            return default
        try:
            return int(val)
        except ValueError:
            return default

    def get_float(self, key: str, default: float) -> float:
        val = self.get(key)
        if val is None or val == "":
            return default
        try:
            return float(val)
        except ValueError:
            return default

    def get_bool(self, key: str, default: bool) -> bool:
        val = self.get(key)
        if val is None or val == "":
            return default
        return val.strip().lower() in ("1", "t", "true", "y", "yes")

    @classmethod
    def of(cls, raw: Optional[Dict[str, str]]) -> "Arguments":
        return cls(raw or {})
