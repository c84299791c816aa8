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
        UTC) and all-null columns, and dictionary-encoded (categorical)
        columns of those (indices int8 to int64, dictionaries with their
        delta batches; ``object`` kind, the categories' values and NaN as
        pandas' ``astype(object)`` gives them), bodies uncompressed, LZ4
        frame (pyarrow's default where it has lz4) or ZSTD compressed
        (``zstd_decompress``). Other column types (nested ones among them)
        and time zones other than UTC raise ``ValueError``. Integer and bool
        columns with a missing cell become ``float`` and ``object`` as in
        pandas."""
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


# ---------------------------------------------------------------- Zstandard
# RFC 8878, read by hand: frames, raw/RLE/compressed blocks, Huffman
# literals, FSE sequences and repeat offsets (no dictionaries)
_ZSTD_MAGIC = 0xFD2FB528
_ZSTD_BLOCK_MAX = 128 * 1024
_LL_BASE = list(range(16)) + [16, 18, 20, 22, 24, 28, 32, 40, 48, 64, 128,
                              256, 512, 1024, 2048, 4096, 8192, 16384,
                              32768, 65536]
_LL_BITS = [0] * 16 + [1, 1, 1, 1, 2, 2, 3, 3, 4, 6, 7, 8, 9, 10, 11, 12,
                       13, 14, 15, 16]
_ML_BASE = list(range(3, 35)) + [35, 37, 39, 41, 43, 47, 51, 59, 67, 83, 99,
                                 131, 259, 515, 1027, 2051, 4099, 8195,
                                 16387, 32771, 65539]
_ML_BITS = [0] * 32 + [1, 1, 1, 1, 2, 2, 3, 3, 4, 4, 5, 7, 8, 9, 10, 11, 12,
                       13, 14, 15, 16]
# the predefined distributions: (normalized counts, accuracy log)
_LL_DEFAULT = ([4, 3, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 1, 1, 1, 2, 2, 2, 2,
                2, 2, 2, 2, 2, 3, 2, 1, 1, 1, 1, 1, -1, -1, -1, -1], 6)
_ML_DEFAULT = ([1, 4, 3, 2, 2, 2, 2, 2, 2] + [1] * 37 + [-1] * 7, 6)
_OF_DEFAULT = ([1, 1, 1, 1, 1, 1, 2, 2, 2] + [1] * 15 + [-1] * 5, 5)
# by kind: (largest symbol, largest accuracy log, predefined distribution)
_SEQ_KINDS = {"ll": (35, 9, _LL_DEFAULT), "of": (31, 8, _OF_DEFAULT),
              "ml": (52, 9, _ML_DEFAULT)}
_M64 = (1 << 64) - 1
_P1, _P2, _P3 = 11400714785074694791, 14029467366897019727, \
    1609587929392839161
_P4, _P5 = 9650029242287828579, 2870177450012600261


def _zstd_error(what: str) -> ValueError:
    return ValueError(f"corrupt Zstandard frame: {what}")


def _rotl64(x: int, r: int) -> int:
    return ((x << r) | (x >> (64 - r))) & _M64


def _xxh64_round(acc: int, lane: int) -> int:
    return (_rotl64((acc + lane * _P2) & _M64, 31) * _P1) & _M64


def xxh64(data: bytes) -> int:
    """XXH64 of `data` with seed 0 (the hash a Zstandard frame's checksum
    keeps the low 32 bits of)."""
    n, i = len(data), 0
    if n >= 32:
        v = [(_P1 + _P2) & _M64, _P2, 0, (-_P1) & _M64]
        stripes = n // 32
        lanes = struct.unpack_from(f"<{4 * stripes}Q", data, 0)
        for j in range(0, 4 * stripes, 4):
            v[0] = _xxh64_round(v[0], lanes[j])
            v[1] = _xxh64_round(v[1], lanes[j + 1])
            v[2] = _xxh64_round(v[2], lanes[j + 2])
            v[3] = _xxh64_round(v[3], lanes[j + 3])
        i = 32 * stripes
        h = (_rotl64(v[0], 1) + _rotl64(v[1], 7) + _rotl64(v[2], 12)
             + _rotl64(v[3], 18)) & _M64
        for x in v:
            h = ((h ^ _xxh64_round(0, x)) * _P1 + _P4) & _M64
    else:
        h = _P5
    h = (h + n) & _M64
    while i + 8 <= n:
        lane = struct.unpack_from("<Q", data, i)[0]
        h = (_rotl64(h ^ _xxh64_round(0, lane), 27) * _P1 + _P4) & _M64
        i += 8
    if i + 4 <= n:
        lane = struct.unpack_from("<I", data, i)[0]
        h = (_rotl64(h ^ (lane * _P1 & _M64), 23) * _P2 + _P3) & _M64
        i += 4
    while i < n:
        h = (_rotl64(h ^ (data[i] * _P5 & _M64), 11) * _P1) & _M64
        i += 1
    h = ((h ^ (h >> 33)) * _P2) & _M64
    h = ((h ^ (h >> 29)) * _P3) & _M64
    return h ^ (h >> 32)


class _ForwardBits:
    """Bits read from the low end of `data` on (an FSE table description)."""

    def __init__(self, data: bytes, start: int):
        self.data, self.bit = data, 8 * start

    def peek(self, n: int) -> int:
        b = self.bit
        chunk = self.data[b >> 3:(b + n + 7 >> 3) + 1]
        return (int.from_bytes(chunk, "little") >> (b & 7)) & ((1 << n) - 1)

    def read(self, n: int) -> int:
        v = self.peek(n)
        self.bit += n
        return v


class _BackwardBits:
    """A Zstandard backward bitstream: read from its last set bit (the end
    mark of the last byte) down; bits below the start read as zeros, and
    ``pos`` (the bits left) then goes negative."""

    def __init__(self, data: bytes):
        if not data or data[-1] == 0:
            raise _zstd_error("a bitstream without its end mark")
        self.data = data
        self.pos = 8 * (len(data) - 1) + data[-1].bit_length() - 1

    def read(self, n: int) -> int:
        if n == 0:
            return 0
        p = self.pos - n
        self.pos = p
        if p < 0:
            if p + n <= 0:
                return 0
            head = int.from_bytes(self.data[:p + n + 7 >> 3], "little")
            return (head & ((1 << (p + n)) - 1)) << -p
        chunk = self.data[p >> 3:(p + n + 7 >> 3)]
        return (int.from_bytes(chunk, "little") >> (p & 7)) & ((1 << n) - 1)


def _fse_counts(data: bytes, start: int, max_symbol: int, max_log: int):
    """An FSE table description at `data[start:]`: (normalized counts,
    accuracy log, bytes it takes)."""
    bits = _ForwardBits(data, start)
    log = bits.read(4) + 5
    if log > max_log:
        raise _zstd_error(f"FSE accuracy log {log} above {max_log}")
    remaining, threshold, nb = (1 << log) + 1, 1 << log, log + 1
    counts: List[int] = []
    previous0 = False
    while True:
        if previous0:
            while True:
                r = bits.read(2)
                counts += [0] * r
                if r != 3:
                    break
            if len(counts) > max_symbol:
                break
        top = 2 * threshold - 1 - remaining
        v = bits.peek(nb - 1)
        if v < top:
            bits.bit += nb - 1
        else:
            v = bits.read(nb)
            if v >= threshold:
                v -= top
        count = v - 1
        remaining -= abs(count)
        counts.append(count)
        previous0 = count == 0
        if remaining < threshold:
            if remaining <= 1:
                break
            nb = remaining.bit_length()
            threshold = 1 << (nb - 1)
        if len(counts) > max_symbol:
            break
    used = (bits.bit + 7) // 8 - start
    if remaining != 1 or len(counts) > max_symbol + 1 \
            or start + used > len(data):
        raise _zstd_error("bad FSE table description")
    return counts, log, used


def _fse_table(counts: Sequence[int], log: int):
    """The FSE decoding table of `counts` (probability -1: "less than
    one"): (symbol, bits to read, baseline) of every state."""
    size = 1 << log
    symbol = [0] * size
    high = size - 1
    following = [1 if c == -1 else c for c in counts]
    for s, c in enumerate(counts):
        if c == -1:
            symbol[high] = s
            high -= 1
    step, mask, pos = (size >> 1) + (size >> 3) + 3, size - 1, 0
    for s, c in enumerate(counts):
        for _ in range(max(c, 0)):
            symbol[pos] = s
            pos = (pos + step) & mask
            while pos > high:
                pos = (pos + step) & mask
    if pos != 0:
        raise _zstd_error("FSE counts that do not fill their table")
    nbits, base = [0] * size, [0] * size
    for u in range(size):
        x = following[symbol[u]]
        following[symbol[u]] += 1
        nbits[u] = log - (x.bit_length() - 1)
        base[u] = (x << nbits[u]) - size
    return symbol, nbits, base, log


def _huffman_weights(src: bytes):
    """A Huffman tree description: (weights of every symbol but the last,
    bytes it takes)."""
    head = src[0]
    if head >= 128:  # direct: 4 bits a weight
        n = head - 127
        raw = src[1:1 + (n + 1) // 2]
        if len(raw) < (n + 1) // 2:
            raise _zstd_error("truncated Huffman weights")
        w = [x for b in raw for x in (b >> 4, b & 15)][:n]
        return w, 1 + (n + 1) // 2
    if head == 0 or 1 + head > len(src):
        raise _zstd_error("bad Huffman tree description")
    data = src[1:1 + head]
    counts, log, used = _fse_counts(data, 0, 255, 6)
    symbol, nbits, base, _ = _fse_table(counts, log)
    bits = _BackwardBits(data[used:])
    s1, s2 = bits.read(log), bits.read(log)
    out: List[int] = []
    while True:  # two states in turn until the stream runs dry
        if len(out) > 253:
            raise _zstd_error("too many Huffman weights")
        out.append(symbol[s1])
        s1 = base[s1] + bits.read(nbits[s1])
        if bits.pos < 0:
            out.append(symbol[s2])
            break
        out.append(symbol[s2])
        s2 = base[s2] + bits.read(nbits[s2])
        if bits.pos < 0:
            out.append(symbol[s1])
            break
    return out, 1 + head


def _huffman_table(weights: List[int]):
    """(symbol of every `max_bits`-bit prefix, its code length, max_bits)
    from the weights of every symbol but the last (whose weight makes the
    sum a power of two)."""
    total = sum(1 << (w - 1) for w in weights if w)
    if total == 0 or any(w > 11 for w in weights):
        raise _zstd_error("bad Huffman weights")
    max_bits = total.bit_length()
    rest = (1 << max_bits) - total
    if rest & (rest - 1) or max_bits > 11:
        raise _zstd_error("Huffman weights that sum to no power of two")
    weights = list(weights) + [rest.bit_length()]
    start, at = {}, 0
    for w in range(1, max_bits + 1):
        start[w] = at
        at += sum(1 for x in weights if x == w) << (w - 1)
    symbols = np.zeros(1 << max_bits, np.uint8)
    lengths = np.zeros(1 << max_bits, np.int64)
    for s, w in enumerate(weights):
        if w:
            n = 1 << (w - 1)
            symbols[start[w]:start[w] + n] = s
            lengths[start[w]:start[w] + n] = max_bits + 1 - w
            start[w] += n
    return symbols, lengths, max_bits


def _huffman_stream(data: bytes, n: int, table) -> bytes:
    """`n` literals of one Huffman-coded backward stream: every bit
    position's `max_bits`-bit window is looked up at once, then the code
    lengths are walked from the top; the stream must end on its first
    bit."""
    symbols, lengths, max_bits = table
    if not data or data[-1] == 0:
        raise _zstd_error("a Huffman stream without its end mark")
    top = 8 * (len(data) - 1) + data[-1].bit_length() - 1
    bits = np.unpackbits(np.frombuffer(data, np.uint8), bitorder="little")
    padded = np.concatenate([np.zeros(max_bits, np.uint8), bits[:top]])
    window = np.zeros(top + 1, np.int64)
    for i in range(max_bits):
        window |= padded[i:i + top + 1].astype(np.int64) << i
    sym, step = symbols[window].tolist(), lengths[window].tolist()
    out = bytearray(n)
    p = top
    for k in range(n):  # p only falls: below 0 it stays below, and fails
        out[k] = sym[p]
        p -= step[p]
    if p != 0:
        raise _zstd_error("a Huffman stream that does not end on its start")
    return bytes(out)


class _ZstdFrame:
    """What the blocks of one frame hand on: the last Huffman table, the
    last FSE tables of the sequences and the three repeat offsets."""

    def __init__(self):
        self.huffman = None
        self.tables: Dict[str, Any] = {"ll": None, "of": None, "ml": None}
        self.rep = [1, 4, 8]


def _zstd_literals(block: bytes, frame: _ZstdFrame):
    """The literals section at the start of a compressed block: (literals,
    bytes it takes)."""
    b0 = block[0]
    kind, fmt = b0 & 3, (b0 >> 2) & 3
    if kind < 2:  # raw or RLE
        if fmt in (0, 2):
            size, at = b0 >> 3, 1
        elif fmt == 1:
            size, at = (b0 >> 4) + (block[1] << 4), 2
        else:
            size, at = (b0 >> 4) + (block[1] << 4) + (block[2] << 12), 3
        if kind == 1:
            return bytes(block[at:at + 1]) * size, at + 1
        if at + size > len(block):
            raise _zstd_error("truncated raw literals")
        return bytes(block[at:at + size]), at + size
    at, width = {0: (3, 10), 1: (3, 10), 2: (4, 14), 3: (5, 18)}[fmt]
    v = int.from_bytes(block[:at], "little")
    regen, size = (v >> 4) & ((1 << width) - 1), \
        (v >> (4 + width)) & ((1 << width) - 1)
    src = block[at:at + size]
    if len(src) < size or regen > _ZSTD_BLOCK_MAX:
        raise _zstd_error("bad literals header")
    used = 0
    if kind == 2:
        weights, used = _huffman_weights(src)
        frame.huffman = _huffman_table(weights)
    elif frame.huffman is None:
        raise _zstd_error("repeated Huffman table without a first one")
    data = src[used:]
    if fmt == 0:  # one stream
        return _huffman_stream(data, regen, frame.huffman), at + size
    s1, s2, s3 = struct.unpack_from("<3H", data, 0)
    seg = (regen + 3) // 4
    sizes = [s1, s2, s3, len(data) - 6 - s1 - s2 - s3]
    counts = [seg, seg, seg, regen - 3 * seg]
    if sizes[3] < 1 or counts[3] < 0:
        raise _zstd_error("bad jump table")
    out, pos = [], 6
    for sz, cnt in zip(sizes, counts):
        out.append(_huffman_stream(data[pos:pos + sz], cnt, frame.huffman))
        pos += sz
    return b"".join(out), at + size


def _zstd_sequences(block: bytes, frame: _ZstdFrame) -> List[tuple]:
    """The sequences section: every (literal length, offset value, match
    length) in order."""
    b0 = block[0]
    if b0 == 0:
        if len(block) != 1:
            raise _zstd_error("bytes after an empty sequences section")
        return []
    if b0 < 128:
        n, at = b0, 1
    elif b0 < 255:
        n, at = ((b0 - 128) << 8) + block[1], 2
    else:
        n, at = block[1] + (block[2] << 8) + 0x7F00, 3
    modes = block[at]
    at += 1
    if modes & 3:
        raise _zstd_error("reserved bits of the compression modes set")
    for kind, shift in (("ll", 6), ("of", 4), ("ml", 2)):
        mode = (modes >> shift) & 3
        max_symbol, max_log, default = _SEQ_KINDS[kind]
        if mode == 0:
            frame.tables[kind] = _fse_table(*default)
        elif mode == 1:  # RLE: one symbol, no bits
            if block[at] > max_symbol:
                raise _zstd_error(f"RLE {kind} symbol {block[at]}")
            frame.tables[kind] = ([block[at]], [0], [0], 0)
            at += 1
        elif mode == 2:
            counts, log, used = _fse_counts(block, at, max_symbol, max_log)
            frame.tables[kind] = _fse_table(counts, log)
            at += used
        elif frame.tables[kind] is None:
            raise _zstd_error(f"repeated {kind} table without a first one")
    ll_sym, ll_nb, ll_base, ll_log = frame.tables["ll"]
    of_sym, of_nb, of_base, of_log = frame.tables["of"]
    ml_sym, ml_nb, ml_base, ml_log = frame.tables["ml"]
    bits = _BackwardBits(block[at:])
    read = bits.read
    ll, of, ml = read(ll_log), read(of_log), read(ml_log)
    out = []
    for k in range(n):
        oc, mc, lc = of_sym[of], ml_sym[ml], ll_sym[ll]
        if oc > 31:
            raise _zstd_error(f"offset code {oc}")
        offset = (1 << oc) + read(oc)
        match = _ML_BASE[mc] + read(_ML_BITS[mc])
        lits = _LL_BASE[lc] + read(_LL_BITS[lc])
        out.append((lits, offset, match))
        if k + 1 < n:
            ll = ll_base[ll] + read(ll_nb[ll])
            ml = ml_base[ml] + read(ml_nb[ml])
            of = of_base[of] + read(of_nb[of])
    if bits.pos != 0:
        raise _zstd_error("a sequences bitstream that does not end on its "
                          "start")
    return out


def _zstd_block(block: bytes, frame: _ZstdFrame, out: bytearray,
                start: int) -> None:
    """Decodes one compressed block onto `out` (the frame's output from
    `start` on is the window)."""
    literals, at = _zstd_literals(block, frame)
    seqs = _zstd_sequences(block[at:], frame)
    rep, lp, begin = frame.rep, 0, len(out)
    for lits, value, match in seqs:
        if lits:
            out += literals[lp:lp + lits]
            lp += lits
        if value > 3:
            off = value - 3
            rep[2], rep[1], rep[0] = rep[1], rep[0], off
        else:
            idx = value - 1 + (lits == 0)
            if idx == 0:
                off = rep[0]
            elif idx == 1:
                off = rep[1]
                rep[1], rep[0] = rep[0], off
            else:
                off = rep[2] if idx == 2 else rep[0] - 1
                rep[2], rep[1], rep[0] = rep[1], rep[0], off
        have = len(out) - start
        if off <= 0 or off > have or lp > len(literals):
            raise _zstd_error("a match before the frame's start")
        at = len(out) - off
        if match <= off:
            out += out[at:at + match]
        else:  # an overlapping match repeats the last `off` bytes
            out += (bytes(out[at:]) * (match // off + 1))[:match]
    out += literals[lp:]
    if len(out) - begin > _ZSTD_BLOCK_MAX:
        raise _zstd_error("a block of more than 128 KiB")


def zstd_decompress(data: bytes) -> bytes:
    """The content of one or more Zstandard frames (RFC 8878): raw, RLE
    and compressed blocks (Huffman-coded literals in one or four streams,
    or reusing the previous table; FSE-coded sequences in predefined, RLE,
    described or repeated tables; repeat offsets), skippable frames
    skipped, the XXH64 content checksum checked where a frame carries one.
    A frame that names a dictionary, and a corrupt one, raise
    ``ValueError``."""
    try:
        return _zstd_frames(bytes(data))
    except (IndexError, struct.error) as e:
        raise _zstd_error(f"truncated ({e})") from None


def _zstd_frames(data: bytes) -> bytes:
    out = bytearray()
    i = 0
    while i < len(data):
        magic = struct.unpack_from("<I", data, i)[0]
        if magic & 0xFFFFFFF0 == 0x184D2A50:  # a skippable frame
            i += 8 + struct.unpack_from("<I", data, i + 4)[0]
            if i > len(data):
                raise _zstd_error("truncated skippable frame")
            continue
        if magic != _ZSTD_MAGIC:
            raise _zstd_error("no frame magic number")
        fhd = data[i + 4]
        i += 5
        if fhd & 0x08:
            raise _zstd_error("reserved bit of the frame header set")
        single = fhd & 0x20
        if not single:
            i += 1  # the window descriptor
        did_size = (0, 1, 2, 4)[fhd & 3]
        did = int.from_bytes(data[i:i + did_size], "little")
        i += did_size
        if did:
            raise ValueError(f"this Zstandard frame needs dictionary {did}, "
                             "which a .feather file never carries")
        fcs_size = (1 if single else 0, 2, 4, 8)[fhd >> 6]
        fcs = int.from_bytes(data[i:i + fcs_size], "little") \
            + (256 if fcs_size == 2 else 0)
        i += fcs_size
        frame, start = _ZstdFrame(), len(out)
        while True:
            if i + 3 > len(data):
                raise _zstd_error("truncated block header")
            head = int.from_bytes(data[i:i + 3], "little")
            last, kind, size = head & 1, (head >> 1) & 3, head >> 3
            i += 3
            if kind == 0:
                if i + size > len(data):
                    raise _zstd_error("truncated raw block")
                out += data[i:i + size]
                i += size
            elif kind == 1:
                out += data[i:i + 1] * size
                i += 1
            elif kind == 2:
                if size > _ZSTD_BLOCK_MAX or i + size > len(data):
                    raise _zstd_error("bad compressed block size")
                _zstd_block(data[i:i + size], frame, out, start)
                i += size
            else:
                raise _zstd_error("reserved block type")
            if last:
                break
        if fcs_size and len(out) - start != fcs:
            raise _zstd_error("content of another size than the header's")
        if fhd & 0x04:
            if i + 4 > len(data):
                raise _zstd_error("truncated checksum")
            want = struct.unpack_from("<I", data, i)[0]
            if xxh64(bytes(out[start:])) & 0xFFFFFFFF != want:
                raise _zstd_error("content checksum mismatch")
            i += 4
    return bytes(out)


def _body_buffer(body: bytes, offset: int, length: int, codec) -> bytes:
    """One buffer of a record batch's body, decompressed (LZ4 frame or
    ZSTD) when the batch says so: 8 bytes of uncompressed length (-1:
    stored as is), then the data."""
    raw = body[offset:offset + length]
    if codec is None or length == 0:
        return raw
    n = struct.unpack_from("<q", raw, 0)[0]
    if n == -1:
        return raw[8:]
    # CompressionType: 0 LZ4 frame (pyarrow's to_feather default where
    # pyarrow has lz4), 1 ZSTD (when the writer asks for it)
    out = (lz4_frame_decompress if codec == 0 else zstd_decompress)(raw[8:])
    if len(out) != n:
        raise ValueError("compressed .feather buffer of the wrong length")
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


def _dictionary_indices(enc: _FB, node, bufs: List[bytes]) -> List[Any]:
    """The indices of a dictionary-encoded column of a record batch
    (missing: None), from its index type (signed int32 unless given)."""
    n, nulls = node
    valid = _validity(bufs.pop(0), n, nulls)
    t = enc.table(1)
    width, signed = (32, True) if t is None else (t.scalar(0, "i"),
                                                  t.scalar(1, "?"))
    dt = np.dtype(("<i" if signed else "<u") + str(width // 8))
    idx = np.frombuffer(bufs.pop(0), dt, n).tolist()
    return [i if ok else None for i, ok in zip(idx, valid)]


def _messages(data: bytes, blocks):
    """(header type, header table, body) of each footer block."""
    for offset, meta_len, _, body_len in blocks:
        cont = struct.unpack_from("<I", data, offset)[0] == 0xFFFFFFFF
        start = offset + (8 if cont else 4)
        msg = _root(data[start:offset + meta_len])
        yield (msg.scalar(1, "B"), msg.table(2),
               data[offset + meta_len:offset + meta_len + body_len])


def _batch_buffers(batch: _FB, body: bytes) -> List[bytes]:
    """A record batch's buffers, decompressed where it says so."""
    comp = batch.table(3)
    codec = None if comp is None else comp.scalar(0, "b")
    return [_body_buffer(body, o, ln, codec)
            for o, ln in batch.structs(2, "qq")]


def _read_arrow_file(path: str) -> Dict[str, Column]:
    with open(path, "rb") as f:
        data = f.read()
    if data[:6] != _ARROW_MAGIC or data[-6:] != _ARROW_MAGIC:
        raise ValueError(f"{path}: not an Arrow IPC (feather v2) file")
    flen = struct.unpack_from("<i", data, len(data) - 10)[0]
    footer = _root(data[len(data) - 10 - flen:len(data) - 10])
    schema = footer.table(1)
    fields = schema.tables(1)
    encodings = [fl.table(4) for fl in fields]
    by_id = {enc.scalar(0, "q"): fl for fl, enc in zip(fields, encodings)
             if enc is not None}
    for fl in fields:
        if fl.tables(5):
            raise ValueError(f"{path}: nested column {fl.string(0)!r}")
    # the dictionaries (a pandas categorical's categories) in file order:
    # a delta appends to its dictionary, which every batch then indexes
    values: Dict[int, List[Any]] = {}
    for kind, db, body in _messages(data, footer.structs(2, "qiiq")):
        if kind != 2:  # a DictionaryBatch header
            continue
        did, rb, delta = db.scalar(0, "q"), db.table(1), db.scalar(2, "?")
        if did not in by_id:
            raise ValueError(f"{path}: dictionary {did} of no column")
        vals, _ = _arrow_column(by_id[did], rb.structs(1, "qq")[0],
                                _batch_buffers(rb, body))
        values[did] = (values.get(did, []) + vals) if delta else vals
    cells: List[List[Any]] = [[] for _ in fields]
    kinds = ["object"] * len(fields)
    for kind, batch, body in _messages(data, footer.structs(3, "qiiq")):
        if kind != 3:  # a RecordBatch header
            continue
        bufs = _batch_buffers(batch, body)
        nodes = batch.structs(1, "qq")
        for j, fl in enumerate(fields):
            enc = encodings[j]
            if enc is None:
                vals, kinds[j] = _arrow_column(fl, nodes[j], bufs)
            else:  # categories as pandas' astype(object) gives them
                dic = values.get(enc.scalar(0, "q"), [])
                idx = _dictionary_indices(enc, nodes[j], bufs)
                if any(i is not None and not 0 <= i < len(dic) for i in idx):
                    raise ValueError(f"{path}: a dictionary index out of "
                                     f"range in column {fl.string(0)!r}")
                vals = [None if i is None else dic[i] for i in idx]
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
