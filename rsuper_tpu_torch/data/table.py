"""A small column table read from CSV with the standard library's ``csv``
module: the port's stand-in for the pandas DataFrame that the JAX package's
report and class-weight code reads.

It keeps the meanings that code relies on, as ``pandas.read_csv`` gives them:

* a cell in pandas' default missing-value set (the empty string, ``NA``,
  ``nan``, ...) is missing: NaN;
* each column takes one kind from its cells: ``int`` (every cell an
  integer), ``float`` (numbers, or integers with missing cells; a decimal
  number is read by pandas' own parser, ``_pandas_float``, which can land
  one unit in the last place from the nearest float), ``bool``
  (``True``/``False`` cells, none missing) or ``object`` (text, missing
  cells NaN, ``True``/``False`` cells Python bools when cells are missing);
* ``astype_str`` gives the text pandas' ``astype(str)`` gives: ``"20.0"`` for
  20.0 in a float column, ``"20"`` in an int one, ``"nan"`` for a missing
  cell (pandas 3 keeps NaN there; every predicate the report code applies
  treats both alike);
* ``to_numeric`` is ``pd.to_numeric(errors="coerce")``;
* row order is the file's (blank lines skipped), and filtering keeps it.

For the evaluation it also builds a table from rows of Python values as
``pd.DataFrame(rows)`` does, and writes one as ``to_csv(index=False)``
does: a float column's cells as Python's ``repr`` (numpy's shortest
round-trip text, which pandas writes), NaN as an empty cell, an int column
with a missing cell as float (``3.0``). ``merge`` (inner, on one key, in the
left table's row order), ``concat``, ``drop_duplicates`` (first kept) and
``sort_values`` (stable) are pandas' for these tables.
"""

from __future__ import annotations

import csv
import math
import numbers
import re
from typing import Any, Dict, Iterable, Iterator, List, Sequence

import numpy as np

NA_STRINGS = frozenset({
    "", "#N/A", "#N/A N/A", "#NA", "-1.#IND", "-1.#QNAN", "-NaN", "-nan",
    "1.#IND", "1.#QNAN", "<NA>", "N/A", "NA", "NULL", "NaN", "None", "n/a",
    "nan", "null",
})
TRUE_STRINGS = frozenset({"True", "TRUE", "true"})
FALSE_STRINGS = frozenset({"False", "FALSE", "false"})
NAN = float("nan")
_BOOLS = (bool, np.bool_)


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


_DECIMAL = re.compile(r"[+-]?(\d+\.?\d*|\.\d+)([eE][+-]?\d+)?")
_POW10 = [float(f"1e{k}") for k in range(309)]


def _pandas_float(s: str):
    """A float from text as ``pandas.read_csv`` reads it (its default
    ``precise_xstrtod``: up to 17 significant digits, leading zeros
    counted, gathered in a double and scaled by one power of ten), so that
    a file read and written again gives pandas' text; other text as
    `_parse_number`."""
    t = s.strip()
    m = _DECIMAL.fullmatch(t)
    if m is None:
        return _parse_number(s)
    whole, _, frac = m.group(1).partition(".")
    number, digits, exponent = 0.0, 0, 0
    for ch in whole:
        if digits < 17:
            number = number * 10.0 + (ord(ch) - 48)
            digits += 1
        else:
            exponent += 1
    for ch in frac[:max(0, 17 - digits)]:
        number = number * 10.0 + (ord(ch) - 48)
        exponent -= 1
    exponent += int(m.group(2)[1:]) if m.group(2) else 0
    if exponent > 308:
        number = math.inf
    elif exponent > 0:
        number *= _POW10[exponent]
    elif exponent < -616:
        number = 0.0
    elif exponent < -308:
        number = number / _POW10[-308 - exponent] / _POW10[308]
    else:
        number /= _POW10[-exponent]
    return -number if t.startswith("-") else number


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
        nums = [_pandas_float(c) for c in present]
        if all(x is not None for x in nums):
            it = iter(nums)
            return cls([NAN if m else next(it) for m in na], "float")
        if all(c in TRUE_STRINGS or c in FALSE_STRINGS for c in present):
            vals = [NAN if m else c in TRUE_STRINGS for c, m in zip(cells, na)]
            return cls(vals, "object" if any(na) else "bool")
        return cls([NAN if m else c for c, m in zip(cells, na)], "object")

    @classmethod
    def from_values(cls, values: Sequence[Any]) -> "Column":
        """A column of Python (or numpy scalar) values, of the kind pandas
        gives it: ``int`` (integers, none missing), ``float`` (numbers,
        missing cells NaN, integers made float), ``bool`` or ``object``."""
        vals = [NAN if v is None else v for v in values]
        present = [v for v in vals if not isna(v)]
        if all(isinstance(v, _BOOLS) for v in present) and \
                present and len(present) == len(vals):
            return cls([bool(v) for v in vals], "bool")
        numeric = all(isinstance(v, numbers.Real)
                      and not isinstance(v, _BOOLS)
                      for v in present)
        if numeric and present and len(present) == len(vals) and all(
                isinstance(v, numbers.Integral) for v in present):
            return cls([int(v) for v in vals], "int")
        if numeric:
            return cls([float(v) for v in vals], "float")
        return cls(vals, "object")

    def cell_text(self, v: Any) -> str:
        """The text ``to_csv`` writes for one cell of this column."""
        if isna(v):
            return ""
        if self.kind == "float":
            return repr(float(v))
        return str(v)

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
        return self.take([i for i, m in enumerate(mask) if m])

    def rename(self, mapping: Dict[str, str]) -> "Table":
        return Table({mapping.get(k, k): c for k, c in self.columns.items()})

    def rows(self) -> Iterator[Dict[str, Any]]:
        names = list(self.columns)
        for i in range(self._n):
            yield {k: self.columns[k].values[i] for k in names}

    @classmethod
    def from_rows(cls, rows: Sequence[Dict[str, Any]]) -> "Table":
        """``pd.DataFrame(rows)``: columns in order of first appearance, a
        cell a row lacks is missing."""
        names: List[str] = []
        for r in rows:
            names += [k for k in r if k not in names]
        return cls({k: Column.from_values([r.get(k, NAN) for r in rows])
                    for k in names})

    def to_csv(self, path: str) -> None:
        """``DataFrame.to_csv(path, index=False)``."""
        cols = list(self.columns.values())
        with open(path, "w", newline="") as f:
            w = csv.writer(f, lineterminator="\n")
            w.writerow(list(self.columns))
            for i in range(self._n):
                w.writerow([c.cell_text(c.values[i]) for c in cols])

    def take(self, idx: Sequence[int]) -> "Table":
        """The rows at `idx`, in that order."""
        return Table({k: Column([c.values[i] for i in idx], c.kind)
                      for k, c in self.columns.items()})

    def merge(self, other: "Table", on: str) -> "Table":
        """``pd.merge(self, other, on=on, how="inner")``: each row of `self`
        in order, joined with each row of `other` of the same key."""
        shared = set(self.columns) & set(other.columns) - {on}
        if shared:
            raise ValueError(f"columns in both tables: {sorted(shared)}")
        where: Dict[Any, List[int]] = {}
        for j, v in enumerate(other[on]):
            where.setdefault(v, []).append(j)
        left, right = [], []
        for i, v in enumerate(self[on]):
            for j in where.get(v, ()):
                left.append(i)
                right.append(j)
        a, b = self.take(left), other.take(right)
        b.columns.pop(on)
        return Table({**a.columns, **b.columns})

    @staticmethod
    def concat(tables: Sequence["Table"]) -> "Table":
        """``pd.concat(tables, ignore_index=True)``: a column some table
        lacks is missing there; ints meeting floats become floats."""
        names: List[str] = []
        for t in tables:
            names += [k for k in t.columns if k not in names]
        out = {}
        for k in names:
            parts = [t.columns[k] if k in t.columns
                     else Column([NAN] * len(t), "float") for t in tables]
            kinds = {c.kind for c in parts}
            values = [v for c in parts for v in c.values]
            if len(kinds) == 1:
                out[k] = Column(values, kinds.pop())
            elif kinds <= {"int", "float"}:
                out[k] = Column([float(v) for v in values], "float")
            else:
                out[k] = Column(values, "object")
        return Table(out)

    def drop_duplicates(self, subset: str) -> "Table":
        """The first row of each value of `subset`."""
        seen, idx = set(), []
        for i, v in enumerate(self[subset]):
            key = ("nan",) if isna(v) else v
            if key not in seen:
                seen.add(key)
                idx.append(i)
        return self.take(idx)

    def sort_values(self, by: str) -> "Table":
        """Rows sorted by `by` (stable; missing cells last)."""
        col = self[by].values
        idx = sorted(range(self._n), key=lambda i: (isna(col[i]),
                                                    0 if isna(col[i])
                                                    else col[i]))
        return self.take(idx)
