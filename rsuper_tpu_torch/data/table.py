"""A small column table read from CSV with the standard library's ``csv``
module: the port's stand-in for the pandas DataFrame that the JAX package's
report and class-weight code reads.

It keeps the meanings that code relies on, as ``pandas.read_csv`` gives them:

* a cell in pandas' default missing-value set (the empty string, ``NA``,
  ``nan``, ...) is missing: NaN;
* each column takes one kind from its cells: ``int`` (every cell an
  integer), ``float`` (numbers, or integers with missing cells), ``bool``
  (``True``/``False`` cells, none missing) or ``object`` (text, missing
  cells NaN, ``True``/``False`` cells Python bools when cells are missing);
* ``astype_str`` gives the text pandas' ``astype(str)`` gives: ``"20.0"`` for
  20.0 in a float column, ``"20"`` in an int one, ``"nan"`` for a missing
  cell (pandas 3 keeps NaN there; every predicate the report code applies
  treats both alike);
* ``to_numeric`` is ``pd.to_numeric(errors="coerce")``;
* row order is the file's (blank lines skipped), and filtering keeps it.
"""

from __future__ import annotations

import csv
import math
from typing import Any, Dict, Iterable, Iterator, List, Sequence

NA_STRINGS = frozenset({
    "", "#N/A", "#N/A N/A", "#NA", "-1.#IND", "-1.#QNAN", "-NaN", "-nan",
    "1.#IND", "1.#QNAN", "<NA>", "N/A", "NA", "NULL", "NaN", "None", "n/a",
    "nan", "null",
})
TRUE_STRINGS = frozenset({"True", "TRUE", "true"})
FALSE_STRINGS = frozenset({"False", "FALSE", "false"})
NAN = float("nan")


def isna(v: Any) -> bool:
    """``pd.isna`` of one cell."""
    return v is None or (isinstance(v, float) and math.isnan(v))


def _parse_number(s: str):
    """A float from text as pandas parses numbers, else None."""
    t = s.strip()
    if not t or "_" in t:
        return None
    try:
        return float(t)
    except ValueError:
        return None


def _parse_int(s: str):
    t = s.strip()
    if not t or "_" in t:
        return None
    try:
        return int(t)
    except ValueError:
        return None


class Column:
    """One column's cells and its kind (``int``, ``float``, ``bool`` or
    ``object``)."""

    def __init__(self, values: List[Any], kind: str):
        self.values = values
        self.kind = kind

    @classmethod
    def from_text(cls, cells: Sequence[str]) -> "Column":
        na = [c in NA_STRINGS for c in cells]
        present = [c for c, m in zip(cells, na) if not m]
        if not present:
            return cls([NAN] * len(cells), "float")
        ints = [_parse_int(c) for c in present]
        if all(i is not None for i in ints):
            if not any(na):
                return cls(ints, "int")
            it = iter(ints)
            return cls([NAN if m else float(next(it)) for m in na], "float")
        nums = [_parse_number(c) for c in present]
        if all(x is not None for x in nums):
            it = iter(nums)
            return cls([NAN if m else next(it) for m in na], "float")
        if all(c in TRUE_STRINGS or c in FALSE_STRINGS for c in present):
            vals = [NAN if m else c in TRUE_STRINGS for c, m in zip(cells, na)]
            return cls(vals, "object" if any(na) else "bool")
        return cls([NAN if m else c for c, m in zip(cells, na)], "object")

    def __len__(self):
        return len(self.values)

    def __iter__(self) -> Iterator[Any]:
        return iter(self.values)

    def tolist(self) -> List[Any]:
        return list(self.values)

    def astype_str(self) -> List[str]:
        return [str(v) for v in self.values]

    def to_numeric(self) -> List[float]:
        """``pd.to_numeric(col, errors="coerce")`` as floats (NaN where a
        cell is not a number)."""
        out = []
        for v in self.values:
            if isinstance(v, bool):
                out.append(float(v))
            elif isinstance(v, (int, float)):
                out.append(float(v))
            elif isinstance(v, str):
                x = _parse_number(v)
                out.append(NAN if x is None else x)
            else:
                out.append(NAN)
        return out

    def isin(self, items: Iterable[Any]) -> List[bool]:
        s = set(items)
        return [(not isna(v)) and v in s for v in self.values]

    def unique(self) -> List[Any]:
        """Distinct cells in order of first appearance."""
        seen, out = set(), []
        for v in self.values:
            key = ("nan",) if isna(v) else v
            if key not in seen:
                seen.add(key)
                out.append(v)
        return out


class Table:
    """Named columns of equal length, in the file's row order."""

    def __init__(self, columns: Dict[str, Column]):
        self.columns = dict(columns)
        lengths = {len(c) for c in self.columns.values()}
        if len(lengths) > 1:
            raise ValueError(f"columns of different lengths: {lengths}")
        self._n = lengths.pop() if lengths else 0

    @classmethod
    def read_csv(cls, path: str) -> "Table":
        with open(path, newline="") as f:
            rows = list(csv.reader(f))
        if not rows:
            raise ValueError(f"{path}: empty CSV file")
        header = rows[0]
        body = [r for r in rows[1:] if r]  # pandas skips blank lines
        width = len(header)
        for i, r in enumerate(body):
            if len(r) > width:
                raise ValueError(f"{path}:{i + 2}: {len(r)} fields, the "
                                 f"header has {width}")
        cells = [[r[j] if j < len(r) else "" for r in body]
                 for j in range(width)]
        return cls({h: Column.from_text(c) for h, c in zip(header, cells)})

    def __len__(self) -> int:
        return self._n

    def __getitem__(self, name: str) -> Column:
        return self.columns[name]

    def __contains__(self, name: str) -> bool:
        return name in self.columns

    def filter(self, mask: Sequence[bool]) -> "Table":
        """The rows where `mask` is true, in order."""
        if len(mask) != self._n:
            raise ValueError(f"mask of {len(mask)} rows for {self._n}")
        idx = [i for i, m in enumerate(mask) if m]
        return Table({k: Column([c.values[i] for i in idx], c.kind)
                      for k, c in self.columns.items()})

    def rename(self, mapping: Dict[str, str]) -> "Table":
        return Table({mapping.get(k, k): c for k, c in self.columns.items()})

    def rows(self) -> Iterator[Dict[str, Any]]:
        names = list(self.columns)
        for i in range(self._n):
            yield {k: self.columns[k].values[i] for k in names}
