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

``read_xlsx`` and ``read_feather`` read the other report-table formats as
``pandas.read_excel`` (through openpyxl) and ``pandas.read_feather``
(through pyarrow) read them, with the standard library and numpy alone: a
column takes pandas' kind from its cells, and a date column (``datetime``
kind; a ``timedelta`` kind for Excel's elapsed-time formats) holds
datetimes whose text is a pandas ``Timestamp``'s, missing cells ``NaT``.

For the evaluation it also builds a table from rows of Python values as
``pd.DataFrame(rows)`` does, and writes one as ``to_csv(index=False)``
does: a float column's cells as Python's ``repr`` (numpy's shortest
round-trip text, which pandas writes), NaN as an empty cell, an int column
with a missing cell as float (``3.0``). ``merge`` (inner, on one key, in the
left table's row order), ``concat``, ``drop_duplicates`` (first or last
kept) and ``sort_values`` (stable) are pandas' for these tables.
"""

from __future__ import annotations

import csv
import datetime as _dt
import math
import numbers
import re
import struct
import zipfile
import xml.etree.ElementTree as ET
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


class _NaTType:
    """pandas' missing date (``NaT``): a missing cell of a date column."""

    def __repr__(self):
        return "NaT"

    __str__ = __repr__


NaT = _NaTType()


def isna(v: Any) -> bool:
    """``pd.isna`` of one cell."""
    return v is None or v is NaT or (isinstance(v, float) and math.isnan(v))


class Timestamp(_dt.datetime):
    """A datetime with nanoseconds (``nanosecond``, 0-999) whose text is a
    pandas ``Timestamp``'s: microseconds shown when any, all nine digits
    when nanoseconds."""

    nanosecond = 0

    def __str__(self):
        text = _dt.datetime.__str__(self)
        if not self.nanosecond:
            return text
        whole = _dt.datetime.__str__(self.replace(microsecond=0))
        return f"{whole}.{self.microsecond:06d}{self.nanosecond:03d}"


class Timedelta(_dt.timedelta):
    """A timedelta whose text is a pandas ``Timedelta``'s
    (``0 days 01:30:00``, ``-1 days +23:00:00``)."""

    def __str__(self):
        h, rest = divmod(self.seconds, 3600)
        m, sec = divmod(rest, 60)
        frac = f".{self.microseconds:06d}" if self.microseconds else ""
        sign = "+" if self.days < 0 else ""
        return f"{self.days} days {sign}{h:02d}:{m:02d}:{sec:02d}{frac}"


_EPOCH = _dt.datetime(1970, 1, 1)


def timestamp_ns(v: _dt.datetime) -> int:
    """Nanoseconds since 1970 of a datetime (UTC when it is aware): the
    key pandas sorts a date column by."""
    if v.tzinfo is not None:
        v = v.astimezone(_dt.timezone.utc).replace(tzinfo=None)
    d = v - _EPOCH
    return (((d.days * 86400 + d.seconds) * 10 ** 6 + d.microseconds) * 1000
            + getattr(v, "nanosecond", 0))


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

    @classmethod
    def from_objects(cls, cells: Sequence[Any]) -> "Column":
        """A column of spreadsheet cells (text, ints, floats, bools, dates,
        times, timedeltas; ``""`` empty, NaN an error cell) of the kind
        ``pandas.read_excel`` gives it: missing cells are the empty ones,
        errors and pandas' missing-value texts; numbers (and number texts,
        bools among numbers) make an ``int`` column, ``float`` with a
        missing cell or a fraction; bools alone ``bool``; all dates
        ``datetime``, all timedeltas ``timedelta`` (missing ``NaT``); text
        cells ``True``/``False`` are bools as in ``from_text``; the rest
        ``object`` with each cell as it is."""
        na = [isna(v) or (isinstance(v, str) and v in NA_STRINGS)
              for v in cells]
        present = [v for v, m in zip(cells, na) if not m]
        if not present:
            return cls([NAN] * len(cells), "float")
        nums = []
        for v in present:
            if isinstance(v, (bool, int, float)):
                nums.append(v)
            elif isinstance(v, str):
                x = _parse_int(v)
                nums.append(x if x is not None else _parse_number(v))
                if nums[-1] is None:
                    break
            else:
                break
        else:
            if all(isinstance(v, bool) for v in nums) and not any(na):
                return cls(nums, "bool")
            it = iter(nums)
            if any(na) or any(isinstance(v, float) for v in nums):
                return cls([NAN if m else float(next(it)) for m in na],
                           "float")
            return cls([int(v) for v in nums], "int")
        if all(isinstance(v, _dt.datetime) for v in present):
            return cls([NaT if m else v for v, m in zip(cells, na)],
                       "datetime")
        if all(isinstance(v, _dt.timedelta) for v in present):
            return cls([NaT if m else Timedelta(v.days, v.seconds,
                                                 v.microseconds)
                        for v, m in zip(cells, na)], "timedelta")
        if all(isinstance(v, bool) or v in TRUE_STRINGS or v in FALSE_STRINGS
               for v in present):
            vals = [NAN if m else v is True or v in TRUE_STRINGS
                    for v, m in zip(cells, na)]
            return cls(vals, "object" if any(na) else "bool")
        return cls([NAN if m else v for v, m in zip(cells, na)], "object")

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
        """``Series.isin``: a missing cell is in `items` when `items` holds
        a missing value."""
        s = set(items)
        has_na = any(isna(v) for v in s)
        return [has_na if isna(v) else v in s for v in self.values]

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

    @classmethod
    def read_xlsx(cls, path: str, sheet: int | str = 0) -> "Table":
        """Sheet `sheet` (its index among the workbook's worksheets, or its
        name) of an ``.xlsx`` file as ``pandas.read_excel(path,
        sheet_name=sheet)`` reads it through openpyxl: the first row is the
        header, each cell's value is openpyxl's (shared and inline strings,
        rich text joined, numbers, bools, a formula's cached value, error
        cells missing, date-formatted numbers as datetimes, times or
        timedeltas), rows and columns missing from the file are empty
        cells, trailing empty rows are dropped, and each column takes its
        kind by ``Column.from_objects``. An index past the last sheet
        raises ``IndexError``, an unknown name ``KeyError``."""
        rows = _xlsx_rows(path, sheet)
        if not rows:
            return cls({})
        header, body = rows[0], rows[1:]
        names = [f"Unnamed: {i}" if h == "" else h
                 for i, h in enumerate(header)]
        return cls({n: Column.from_objects([r[j] for r in body])
                    for j, n in enumerate(names)})

    @classmethod
    def read_feather(cls, path: str) -> "Table":
        """A ``.feather`` file (Arrow IPC, as ``DataFrame.to_feather``
        writes it) as ``pandas.read_feather`` reads it: utf8 and large
        utf8 text, integers, float64/float32, bools, timestamps (naive or
        UTC) and all-null columns, bodies uncompressed or LZ4-frame
        compressed; other column types raise ``ValueError``. Integer and bool
        columns with a missing cell become ``float`` and ``object`` as in
        pandas. ZSTD bodies and dictionary-encoded (categorical) columns
        raise ``ValueError``."""
        return cls(_read_arrow_file(path))

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

    def drop_duplicates(self, subset, keep: str = "first") -> "Table":
        """The first (``keep="last"``: the last) row of each value of
        `subset`, a column or a sequence of columns; the kept rows in
        their order."""
        cols = [subset] if isinstance(subset, str) else list(subset)
        keys = [tuple(("nan",) if isna(v) else v for v in row)
                for row in zip(*(self[c].values for c in cols))]
        if keep not in ("first", "last"):
            raise ValueError(f"keep must be 'first' or 'last', got {keep!r}")
        rows = range(self._n) if keep == "first" else reversed(range(self._n))
        seen, idx = set(), []
        for i in rows:
            if keys[i] not in seen:
                seen.add(keys[i])
                idx.append(i)
        return self.take(sorted(idx))

    def sort_values(self, by: str) -> "Table":
        """Rows sorted by `by` (stable; missing cells last)."""
        col = self[by].values
        idx = sorted(range(self._n), key=lambda i: (isna(col[i]),
                                                    0 if isna(col[i])
                                                    else col[i]))
        return self.take(idx)


# ------------------------------------------------------------------ .xlsx
_REL_WORKSHEET = "/worksheet"
# openpyxl's built-in number formats that are dates (14-22, 45-47), by id
_BUILTIN_DATE_FORMATS = {
    14: "mm-dd-yy", 15: "d-mmm-yy", 16: "d-mmm", 17: "mmm-yy",
    18: "h:mm AM/PM", 19: "h:mm:ss AM/PM", 20: "h:mm", 21: "h:mm:ss",
    22: "m/d/yy h:mm", 45: "mm:ss", 46: "[h]:mm:ss", 47: "mmss.0",
}
# openpyxl's tests of a format code (``openpyxl.styles.numbers``)
_FMT_STRIP = re.compile(r"""\[(?!(hh?|mm?|ss?)\])[^\]]*\]|"[^"]*"|\\.""")
_FMT_DATE = re.compile(r"(?<![_\\])[dmhysDMHYS]")
_FMT_TIMEDELTA = re.compile(r"\[hh?\](:mm(:ss)?)?", re.I)
_WINDOWS_EPOCH = _dt.datetime(1899, 12, 30)
_MAC_EPOCH = _dt.datetime(1904, 1, 1)
_CELL_REF = re.compile(r"([A-Z]+)(\d+)")


def _xml(zf: zipfile.ZipFile, name: str):
    """A part of the package parsed, tags and attribute names without their
    namespaces (so transitional and strict files read alike); None if the
    package lacks it."""
    try:
        data = zf.read(name)
    except KeyError:
        return None
    root = ET.fromstring(data)
    for el in root.iter():
        el.tag = el.tag.rsplit("}", 1)[-1]
        for k in [k for k in el.attrib if k.startswith("{")]:
            el.attrib[k.rsplit("}", 1)[-1]] = el.attrib.pop(k)
    return root


def _rich_text(el) -> str:
    """openpyxl's ``Text.content``: the plain ``t`` and every run's ``t``
    (phonetic runs left out)."""
    parts = [c.text or "" for c in el if c.tag == "t"]
    parts += [t.text or "" for r in el if r.tag == "r" for t in r
              if t.tag == "t"]
    return "".join(parts)


def _part_path(base: str, target: str) -> str:
    """A relationship's target as a name in the zip, relative to the
    directory of the part `base` unless absolute."""
    if target.startswith("/"):
        return target[1:]
    parts = base.split("/")[:-1]
    for seg in target.split("/"):
        if seg == "..":
            parts.pop()
        elif seg not in ("", "."):
            parts.append(seg)
    return "/".join(parts)


def _rels(zf, part: str) -> Dict[str, tuple]:
    d, _, name = part.rpartition("/")
    root = _xml(zf, f"{d}/_rels/{name}.rels" if d else f"_rels/{name}.rels")
    if root is None:
        return {}
    return {r.get("Id"): (r.get("Type", ""), _part_path(part, r.get("Target")))
            for r in root if r.tag == "Relationship"}


def _date_styles(zf, styles_part):
    """The cell styles (``cellXfs`` indices) openpyxl reads as dates and,
    of them, as timedeltas."""
    root = _xml(zf, styles_part) if styles_part else None
    if root is None:
        return set(), set()
    codes = dict(_BUILTIN_DATE_FORMATS)
    for fmts in root.iter("numFmts"):
        for f in fmts:
            codes[int(f.get("numFmtId"))] = f.get("formatCode", "")
    dates, deltas = set(), set()
    for xfs in root.iter("cellXfs"):
        for i, xf in enumerate(x for x in xfs if x.tag == "xf"):
            code = codes.get(int(xf.get("numFmtId", 0)))
            if code is None:
                continue
            first = code.split(";")[0]
            if _FMT_DATE.search(_FMT_STRIP.sub("", first)):
                dates.add(i)
                if _FMT_TIMEDELTA.search(first):
                    deltas.add(i)
    return dates, deltas


def _from_excel(value: float, epoch, timedelta: bool):
    """openpyxl's ``from_excel``: a serial day number as a timedelta
    (`timedelta`), a time (below one day) or a datetime, to the
    millisecond."""
    if timedelta:
        td = _dt.timedelta(days=value)
        if td.microseconds:
            td = _dt.timedelta(seconds=td.total_seconds() // 1,
                               microseconds=round(td.microseconds, -3))
        return td
    day, fraction = divmod(value, 1)
    diff = _dt.timedelta(milliseconds=round(fraction * 86400 * 1000))
    if 0 <= value < 1 and diff.days == 0:
        m, s = divmod(diff.seconds, 60)
        h, m = divmod(m, 60)
        return _dt.time(h, m, s, diff.microseconds)
    if 0 < value < 60 and epoch == _WINDOWS_EPOCH:
        day += 1
    return epoch + _dt.timedelta(days=day) + diff


def _column_number(letters: str) -> int:
    n = 0
    for ch in letters:
        n = n * 26 + ord(ch) - 64
    return n


def _xlsx_rows(path: str, sheet) -> List[List[Any]]:
    """The sheet's rows as pandas' openpyxl reader hands them to its
    parser: each cell's value (``""`` empty, NaN an error), each row
    without its trailing empty cells, trailing empty rows dropped, then
    every row padded to the longest."""
    with zipfile.ZipFile(path) as zf:
        book = next((t for kind, t in _rels(zf, "").values()
                     if kind.endswith("/officeDocument")), "xl/workbook.xml")
        wb = _xml(zf, book)
        if wb is None:
            raise ValueError(f"{path}: no workbook part")
        rels = _rels(zf, book)
        sheets = [(s.get("name"), rels.get(s.get("id"), ("", ""))[1])
                  for s in wb.iter("sheet")
                  if rels.get(s.get("id"), ("", ""))[0].endswith(
                      _REL_WORKSHEET)]
        if isinstance(sheet, str):
            found = [p for n, p in sheets if n == sheet]
            if not found:
                raise KeyError(f"{path}: no worksheet named {sheet!r}")
            part = found[0]
        else:
            if not 0 <= sheet < len(sheets):
                raise IndexError(f"{path}: worksheet index {sheet} of "
                                 f"{len(sheets)}")
            part = sheets[sheet][1]
        pr = next(iter(wb.iter("workbookPr")), None)
        epoch = (_MAC_EPOCH if pr is not None and pr.get("date1904") in
                 ("1", "true") else _WINDOWS_EPOCH)
        kinds = {kind.rsplit("/", 1)[-1]: t for kind, t in rels.values()}
        sst = _xml(zf, kinds["sharedStrings"]) \
            if "sharedStrings" in kinds else None
        shared = [] if sst is None else [
            _rich_text(si).replace("x005F_", "") for si in sst
            if si.tag == "si"]
        dates, deltas = _date_styles(zf, kinds.get("styles"))
        ws = _xml(zf, part)
    by_row: Dict[int, List[Any]] = {}
    r_idx = 0
    for row in ws.iter("row"):
        r_idx = int(row.get("r", r_idx + 1))
        cells, c_idx = [], 0
        for c in row:
            if c.tag != "c":
                continue
            ref = _CELL_REF.fullmatch(c.get("r", ""))
            c_idx = _column_number(ref.group(1)) if ref else c_idx + 1
            cells.append((c_idx, _cell_value(c, shared, dates, deltas,
                                             epoch)))
        width = cells[-1][0] if cells else 0
        line = [""] * width
        for j, v in cells:
            line[j - 1] = v
        while line and isinstance(line[-1], str) and line[-1] == "":
            line.pop()
        by_row[r_idx] = line
    last = max([i for i, line in by_row.items() if line], default=0)
    rows = [by_row.get(i, []) for i in range(1, last + 1)]
    width = max((len(r) for r in rows), default=0)
    return [r + [""] * (width - len(r)) for r in rows]


def _cell_value(c, shared, dates, deltas, epoch):
    """One cell's value as openpyxl reads it (``data_only``) and pandas'
    reader converts it: empty → ``""``, an error → NaN, a whole number →
    int."""
    kind, style = c.get("t", "n"), int(c.get("s", 0) or 0)
    if kind == "inlineStr":
        node = next((e for e in c if e.tag == "is"), None)
        return "" if node is None else _rich_text(node)
    v = next((e.text for e in c if e.tag == "v"), None) or None
    if v is None:
        return ""
    if kind == "e":
        return NAN
    if kind == "s":
        return shared[int(v)]
    if kind == "b":
        return bool(int(v))
    if kind == "str":
        return v
    if kind == "d":
        return _dt.datetime.fromisoformat(v.rstrip("Z"))
    x = float(v) if any(ch in v for ch in ".Ee") else int(v)
    if style in dates:
        return _from_excel(x, epoch, style in deltas)
    return int(x) if x == int(x) else float(x)


# ---------------------------------------------------------------- .feather
# Arrow IPC (``Schema.fbs``, ``Message.fbs``, ``File.fbs``), read by hand
_ARROW_MAGIC = b"ARROW1"
_LZ4_MAGIC = 0x184D2204
_TYPE_NULL, _TYPE_INT, _TYPE_FLOAT, _TYPE_UTF8, _TYPE_BOOL = 1, 2, 3, 5, 6
_TYPE_TIMESTAMP, _TYPE_LARGE_UTF8 = 10, 20
_TYPE_NAMES = {4: "binary", 7: "decimal", 8: "date", 9: "time",
               11: "interval", 12: "list", 13: "struct", 14: "union",
               15: "fixed_size_binary", 16: "fixed_size_list", 17: "map",
               18: "duration", 19: "large_binary", 21: "large_list",
               23: "binary_view", 24: "utf8_view"}


class _FB:
    """One flatbuffer table: its fields by slot."""

    def __init__(self, buf: bytes, pos: int):
        self.buf, self.pos = buf, pos
        vt = pos - struct.unpack_from("<i", buf, pos)[0]
        n = (struct.unpack_from("<H", buf, vt)[0] - 4) // 2
        self.slots = struct.unpack_from(f"<{n}H", buf, vt + 4)

    def _at(self, slot: int):
        off = self.slots[slot] if slot < len(self.slots) else 0
        return self.pos + off if off else None

    def scalar(self, slot: int, fmt: str, default=0):
        at = self._at(slot)
        return default if at is None else struct.unpack_from(
            "<" + fmt, self.buf, at)[0]

    def _ref(self, slot: int):
        at = self._at(slot)
        return None if at is None else at + struct.unpack_from(
            "<I", self.buf, at)[0]

    def table(self, slot: int):
        at = self._ref(slot)
        return None if at is None else _FB(self.buf, at)

    def string(self, slot: int):
        at = self._ref(slot)
        if at is None:
            return None
        n = struct.unpack_from("<I", self.buf, at)[0]
        return self.buf[at + 4:at + 4 + n].decode("utf-8")

    def tables(self, slot: int) -> List["_FB"]:
        at = self._ref(slot)
        if at is None:
            return []
        n = struct.unpack_from("<I", self.buf, at)[0]
        return [_FB(self.buf, at + 4 + 4 * i
                    + struct.unpack_from("<I", self.buf, at + 4 + 4 * i)[0])
                for i in range(n)]

    def structs(self, slot: int, fmt: str) -> List[tuple]:
        at = self._ref(slot)
        if at is None:
            return []
        n = struct.unpack_from("<I", self.buf, at)[0]
        size = struct.calcsize("<" + fmt)
        return [struct.unpack_from("<" + fmt, self.buf, at + 4 + size * i)
                for i in range(n)]


def _root(buf: bytes) -> _FB:
    return _FB(buf, struct.unpack_from("<I", buf, 0)[0])


def _lz4_block(src: bytes, out: bytearray) -> None:
    """Decodes one LZ4 block onto `out` (earlier output is the window)."""
    i, n = 0, len(src)
    while i < n:
        token = src[i]
        i += 1
        lit = token >> 4
        if lit == 15:
            while True:
                b = src[i]
                i += 1
                lit += b
                if b != 255:
                    break
        out += src[i:i + lit]
        i += lit
        if i >= n:  # the last sequence holds literals only
            break
        off = src[i] | (src[i + 1] << 8)
        i += 2
        length = (token & 15) + 4
        if (token & 15) == 15:
            while True:
                b = src[i]
                i += 1
                length += b
                if b != 255:
                    break
        if off == 0 or off > len(out):
            raise ValueError("corrupt LZ4 block: bad match offset")
        start = len(out) - off
        if off >= length:
            out += out[start:start + length]
        else:  # an overlapping match repeats the last `off` bytes
            chunk = bytes(out[start:])
            out += (chunk * (length // off + 1))[:length]


def lz4_frame_decompress(data: bytes) -> bytes:
    """The content of one or more LZ4 frames (the LZ4 frame format:
    linked or independent blocks, optional checksums and content size,
    skippable frames skipped)."""
    out = bytearray()
    i = 0
    while i < len(data):
        magic = struct.unpack_from("<I", data, i)[0]
        if magic & 0xFFFFFFF0 == 0x184D2A50:  # a skippable frame
            i += 8 + struct.unpack_from("<I", data, i + 4)[0]
            continue
        if magic != _LZ4_MAGIC:
            raise ValueError("not an LZ4 frame")
        flg = data[i + 4]
        i += 6 + (8 if flg & 0x08 else 0) + (4 if flg & 0x01 else 0) + 1
        block_sum = 4 if flg & 0x10 else 0
        frame = bytearray()
        while True:
            size = struct.unpack_from("<I", data, i)[0]
            i += 4
            if size == 0:
                break
            raw, size = size & 0x80000000, size & 0x7FFFFFFF
            if raw:
                frame += data[i:i + size]
            else:
                _lz4_block(data[i:i + size], frame)
            i += size + block_sum
        i += 4 if flg & 0x04 else 0
        out += frame
    return bytes(out)


def _body_buffer(body: bytes, offset: int, length: int, codec) -> bytes:
    """One buffer of a record batch's body, decompressed (LZ4 frame) when
    the batch says so: 8 bytes of uncompressed length (-1: stored as is),
    then the data."""
    raw = body[offset:offset + length]
    if codec is None or length == 0:
        return raw
    n = struct.unpack_from("<q", raw, 0)[0]
    if n == -1:
        return raw[8:]
    if codec != 0:
        raise ValueError(
            "this .feather file's record batches are ZSTD-compressed (pandas' "
            "to_feather default when pyarrow has zstd); the port reads no "
            "zstd (the card's Python has no zstd decoder): write it with "
            'to_feather(path, compression="lz4") or "uncompressed"')
    out = lz4_frame_decompress(raw[8:])
    if len(out) != n:
        raise ValueError("LZ4 buffer of the wrong length")
    return out


def _validity(buf: bytes, n: int, null_count: int) -> List[bool]:
    if null_count == 0 or not buf:
        return [True] * n
    bits = np.unpackbits(np.frombuffer(buf, np.uint8), bitorder="little")
    return bits[:n].astype(bool).tolist()


_NS_PER_UNIT = (10 ** 9, 10 ** 6, 10 ** 3, 1)  # TimeUnit: s, ms, us, ns


def _timestamp(ns: int, tz):
    secs, rest = divmod(ns, 10 ** 9)
    t = Timestamp.fromtimestamp(secs, _dt.timezone.utc)
    t = t.replace(microsecond=rest // 1000,
                  tzinfo=None if tz is None else _dt.timezone.utc)
    t.nanosecond = rest % 1000
    return t


def _arrow_column(field: _FB, node, bufs: List[bytes]):
    """The cells of one column of a record batch (missing: None) and its
    kind before missing cells are counted; takes its buffers off the front
    of `bufs`."""
    n, nulls = node
    type_id, t = field.scalar(2, "B"), field.table(3)
    if type_id == _TYPE_NULL:
        return [None] * n, "object"
    valid = _validity(bufs.pop(0), n, nulls)
    if type_id == _TYPE_INT:
        width, signed = t.scalar(0, "i"), t.scalar(1, "?")
        dt = np.dtype(("<i" if signed else "<u") + str(width // 8))
        vals = np.frombuffer(bufs.pop(0), dt, n).tolist()
    elif type_id == _TYPE_FLOAT:
        prec = t.scalar(0, "h")
        if prec not in (1, 2):
            raise ValueError("half-precision .feather columns are not read")
        vals = np.frombuffer(bufs.pop(0), "<f4" if prec == 1 else "<f8",
                             n).tolist()
    elif type_id == _TYPE_BOOL:
        bits = np.unpackbits(np.frombuffer(bufs.pop(0), np.uint8),
                             bitorder="little")
        vals = bits[:n].astype(bool).tolist()
    elif type_id in (_TYPE_UTF8, _TYPE_LARGE_UTF8):
        off = np.frombuffer(bufs.pop(0), "<i4" if type_id == _TYPE_UTF8
                            else "<i8", n + 1).tolist()
        data = bufs.pop(0)
        vals = [data[off[i]:off[i + 1]].decode("utf-8") for i in range(n)]
    elif type_id == _TYPE_TIMESTAMP:
        tz = t.string(1)
        if tz not in (None, "UTC", "utc", "+00:00", "Etc/UTC"):
            raise ValueError(f"timestamps in time zone {tz!r} are not read "
                             "(naive or UTC only)")
        scale = _NS_PER_UNIT[t.scalar(0, "h")]
        raw = np.frombuffer(bufs.pop(0), "<i8", n).tolist()
        vals = [_timestamp(v * scale, tz) if ok else None
                for v, ok in zip(raw, valid)]
    else:
        raise ValueError(f".feather columns of type "
                         f"{_TYPE_NAMES.get(type_id, type_id)} are not read")
    vals = [v if ok else None for v, ok in zip(vals, valid)]
    kind = {_TYPE_INT: "int", _TYPE_FLOAT: "float", _TYPE_BOOL: "bool",
            _TYPE_TIMESTAMP: "datetime"}.get(type_id, "object")
    return vals, kind


def _read_arrow_file(path: str) -> Dict[str, Column]:
    with open(path, "rb") as f:
        data = f.read()
    if data[:6] != _ARROW_MAGIC or data[-6:] != _ARROW_MAGIC:
        raise ValueError(f"{path}: not an Arrow IPC (feather v2) file")
    flen = struct.unpack_from("<i", data, len(data) - 10)[0]
    footer = _root(data[len(data) - 10 - flen:len(data) - 10])
    schema = footer.table(1)
    fields = schema.tables(1)
    for fl in fields:
        if fl.table(4) is not None:
            raise ValueError(
                f"{path}: column {fl.string(0)!r} is dictionary-encoded (a "
                "pandas categorical); the port reads no dictionary batches: "
                "write it with astype(str) first")
        if fl.tables(5):
            raise ValueError(f"{path}: nested column {fl.string(0)!r}")
    cells: List[List[Any]] = [[] for _ in fields]
    kinds = ["object"] * len(fields)
    for offset, meta_len, _, body_len in footer.structs(3, "qiiq"):
        cont = struct.unpack_from("<I", data, offset)[0] == 0xFFFFFFFF
        start = offset + (8 if cont else 4)
        msg = _root(data[start:offset + meta_len])
        if msg.scalar(1, "B") != 3:  # a RecordBatch header
            continue
        batch = msg.table(2)
        body = data[offset + meta_len:offset + meta_len + body_len]
        comp = batch.table(3)
        codec = None if comp is None else comp.scalar(0, "b")
        bufs = [_body_buffer(body, o, ln, codec)
                for o, ln in batch.structs(2, "qq")]
        nodes = batch.structs(1, "qq")
        for j, fl in enumerate(fields):
            vals, kinds[j] = _arrow_column(fl, nodes[j], bufs)
            cells[j] += vals
    out = {}
    for fl, vals, kind in zip(fields, cells, kinds):
        missing = any(v is None for v in vals)
        if kind in ("int", "float"):
            col = Column([NAN if v is None else float(v) for v in vals],
                         "float") if missing or kind == "float" else \
                Column(vals, "int")
        elif kind == "bool" and not missing:
            col = Column(vals, "bool")
        elif kind == "datetime":
            col = Column([NaT if v is None else v for v in vals], kind)
        else:
            col = Column([NAN if v is None else v for v in vals], "object")
        out[fl.string(0)] = col
    return out
