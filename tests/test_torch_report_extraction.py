"""The port's report extraction (``rsuper_tpu_torch/report_extraction/``)
against the JAX package's, on the CPU, with a stub LLM client.

Every step of ``STEPS`` runs through both packages' ``run_extraction`` and
``postprocess_answers`` on one seeded CSV of 50 reports, sharded in two
parts and resumed; the raw answer files and every CSV are compared byte for
byte. The parsers, the metadata tables and the client are held equal on
seeded corpora. No endpoint is contacted: the client's HTTP call is a stub.
"""

import datetime
import json
import zipfile
import zlib
from pathlib import Path

import numpy as np
import pandas as pd
import pytest
from pandas.io.parsers import TextParser

from rsuper_tpu.report_extraction import client as jclient
from rsuper_tpu.report_extraction import metadata as jmeta
from rsuper_tpu.report_extraction import parse as jparse
from rsuper_tpu.report_extraction import prompts as jprompts
from rsuper_tpu.report_extraction import run as jrun
from rsuper_tpu_torch.data.table import Table, isna
from rsuper_tpu_torch.report_extraction import client as tclient
from rsuper_tpu_torch.report_extraction import metadata as tmeta
from rsuper_tpu_torch.report_extraction import parse as tparse
from rsuper_tpu_torch.report_extraction import prompts as tprompts
from rsuper_tpu_torch.report_extraction import run as trun

ROOT = Path(__file__).resolve().parent.parent
ORGANS = ("liver", "pancreas", "kidney")

# answers of every step's grammar; a stub client picks one per prompt
ANSWERS = [
    "<think>reasoning</think>\nlesion 1: type = PDAC; certainty = high; "
    "size = 2.3 x 1.8 cm; organ = pancreas; location = head; "
    "attenuation = hypo;\nlesion 2: type = cyst; certainty = high; "
    "size = u; organ = kidney; location = left; attenuation = u;\n",
    "lesion 1: type = cyst; certainty = certain; size = 1.2 cm x 8 mm; "
    "organ = liver; location = segment 7; attenuation = hypoattenuating;\n"
    "lesion 2: type = metastasis; certainty = certain; size = multiple "
    "small; organ = liver; location = right hepatic lobe; attenuation = u;\n"
    "lesion 3: type = hcc; certainty = certain; size = massive; "
    "organ = Hepatic; location = dome; attenuation = u;\n",
    "lesion 1: type = hemangioma; certainty = probable; size = 14; "
    "organ = liver; location = segment iv; attenuation = u;\n"
    "lesion 2: type = renal cell carcinoma; certainty = high; size = 4 x 3 "
    "x 2.5 cm; organ = renal; location = right kidney; attenuation = u;\n"
    "lesion 3: type = ipmn; certainty = u; size = tiny; organ = pancreatic;"
    " location = body and tail; attenuation = u;\n",
    "No lesions mentioned.",
    "the scan looks fine to me",
    "liver tumor presence = yes; kidney tumor presence = no;\n"
    "pancreas tumor presence = u;",
    "<think>hmm</think>liver tumor presence = no; kidney tumor presence = "
    "yes; pancreas tumor presence = yes;",
    "malignant tumor in pancreas = yes; malignant tumor in liver = no;",
    "pancreas tumor 1: type = pdac; certainty = high; size = 2.3 x 1.8 cm; "
    "location = head;\npancreas tumor 2: type = cyst; certainty = low; "
    "size = multiple; location = tail;\nliver tumor 1: type = hcc; "
    "certainty = u; size = 31 mm; location = segment 8;\n",
    "liver malignant tumor size = 1.5 cm; location = segment 2;\n"
    "liver malignant tumor size = 22 mm; location = segment 7;\n"
    "pancreas malignant tumor size = 4 x 3 x 2.5 cm; location = head;",
    "<think>x</think>\nliver tumor 1: type = HCC; certainty = high; "
    "size = 3.2 cm; location = segment 8; arterial enhancement = yes; "
    "washout = yes; capsule = no; threshold growth = u; LI-RADS = LR-5;\n"
    "Liver Tumor 2: type = cyst; certainty = high; size = u; "
    "location = u; arterial enhancement = no; washout = no;\n",
    "abnormalities = ['pancreatic duct dilation', 'liver cyst']",
    "abnormalities = []",
    "synonyms = {'PDAC': ['pancreatic adenocarcinoma'], "
    "'cyst': ['cystic lesion', 'fluid, collection']}",
    "first diagnosis report = 3;\npre-diagnosis reports = 1, 2;",
    "first diagnosis report = none;",
    "tumor types: PDAC; Cyst;",
    "- decision: exclude\nconfidence: high\nhuman review required: no",
    "decision: include",
    "same report = yes;",
    "same report = no;",
    "<think>hindsight</think>\nvery likely malignancy in pancreas in the "
    "first exam = yes;\npancreas malignant tumor size = 1.2 x 0.8 cm; "
    "location = head;\n",
    "very likely malignancy in liver in the first exam = no;",
    "unchanged from the 2020 exam; 2 subcentimeter lesions",
]


class StubClient:
    """``chat_batch`` answers from `ANSWERS` by a hash of the step's system
    prompt and the report; every seventh prompt fails (None) unless
    `fail` is off, as a lost request does."""

    def __init__(self, fail=True):
        self.fail = fail
        self.prompts = []

    def chat_batch(self, system, users):
        out = []
        for u in users:
            self.prompts.append(u)
            h = zlib.crc32((system + u).encode())
            out.append(None if self.fail and h % 7 == 0
                       else ANSWERS[h % len(ANSWERS)])
        return out


def _reports(path, n=50, seed=0):
    """A seeded reports CSV: ids under ``BDMAP ID``, texts with commas,
    quotes and line breaks (a few missing), the detection flags, patients,
    dates with ties and the time machine's timeline."""
    rng = np.random.default_rng(seed)
    words = ["liver", "mass", "2 cm", "pancreatic", "cyst,", "\"hypodense\"",
             "kidney", "normal", "\n", "lesion", "segment 7", "head"]
    timelines = ["pre-diagnosis", "first positive", "", "post-treatment",
                 "pre-diagnosis, early"]
    df = pd.DataFrame({
        "BDMAP ID": [f"BDMAP_{i:05d}" for i in rng.permutation(n)],
        "Report Text": [" ".join(rng.choice(words, int(rng.integers(3, 9))))
                        if rng.random() > 0.08 else None for _ in range(n)],
        "Liver Tumor": rng.integers(0, 2, n),
        "Kidney Tumor": rng.integers(0, 2, n),
        "Pancreas Tumor": rng.integers(0, 2, n),
        "Assigned Number": rng.integers(0, 12, n),
        "Exam Started Date": [f"20{int(rng.integers(18, 23))}-0"
                              f"{int(rng.integers(1, 4))}-01"
                              for _ in range(n)],
        "pancreatic cancer timeline": [timelines[int(i)] for i in
                                       rng.integers(0, len(timelines), n)],
        "note": rng.normal(size=n).round(3),
    })
    df.to_csv(path, index=False)
    return df


def _same_tree(a, b):
    names = sorted(p.name for p in a.iterdir())
    assert names == sorted(p.name for p in b.iterdir())
    for name in names:
        assert (a / name).read_bytes() == (b / name).read_bytes(), name
    return names


@pytest.mark.parametrize("step", sorted(jrun.STEPS))
def test_every_step_writes_the_jax_bytes(tmp_path, step):
    """Two parts, a resumed part, then postprocessing: the raw answers and
    every CSV equal to the JAX package's, byte for byte."""
    assert sorted(trun.STEPS) == sorted(jrun.STEPS)
    assert trun.STEPS[step] == jrun.STEPS[step]
    csv = tmp_path / "reports.csv"
    _reports(csv)
    organ = "pancreas" if "pancreas" in step or step == "time_machine" \
        else "liver"
    outs = {}
    for name, mod in (("jax", jrun), ("port", trun)):
        out = tmp_path / name
        clients = [StubClient(), StubClient(), StubClient(fail=False)]
        for part, client in zip((0, 1, 0), clients):
            mod.run_extraction(str(csv), str(out), client, parts=2,
                               part=part, batch=4, step=step, organ=organ)
        mod.postprocess_answers(str(out), step=step, organ=organ)
        outs[name] = (out, [c.prompts for c in clients])
    assert outs["jax"][1] == outs["port"][1]
    names = _same_tree(outs["jax"][0], outs["port"][0])
    assert any(n.endswith(".csv") for n in names)
    # the resumed part asked only for what the first pass lost
    assert 0 < len(outs["port"][1][2]) < len(outs["port"][1][0])


def test_read_reports_and_time_machine_pairs_equal_pandas(tmp_path):
    csv = tmp_path / "reports.csv"
    df = _reports(csv)
    jt = jrun.read_reports(str(csv), "Report Text")
    tt = trun.read_reports(str(csv), "Report Text")
    assert 0 < len(tt) < len(df)  # rows without a report dropped
    jt.to_csv(tmp_path / "j.csv", index=False)
    tt.to_csv(str(tmp_path / "t.csv"))
    assert (tmp_path / "j.csv").read_bytes() == (tmp_path / "t.csv").read_bytes()

    jt = jt.rename(columns={"BDMAP ID": "BDMAP_ID"})
    tt = tt.rename({"BDMAP ID": "BDMAP_ID"})
    jp = jrun.pair_time_machine_reports(jt)
    tp = trun.pair_time_machine_reports(tt)
    assert len(tp) > 1
    jp.to_csv(tmp_path / "jp.csv", index=False)
    tp.to_csv(str(tmp_path / "tp.csv"))
    assert (tmp_path / "jp.csv").read_bytes() == \
        (tmp_path / "tp.csv").read_bytes()

    # numeric dates sort as pandas sorts numbers (numpy's quicksort)
    num = pd.DataFrame({
        "BDMAP_ID": [f"C{i}" for i in range(40)],
        "Assigned Number": [i % 3 for i in range(40)],
        "Exam Started Date": [20200101 + (i * 7) % 3 for i in range(40)],
        "pancreatic cancer timeline": ["first positive", "pre-diagnosis"] * 20,
        "Report Text": [f"report {i}" for i in range(40)],
    })
    num.to_csv(tmp_path / "num.csv", index=False)
    jrun.pair_time_machine_reports(num).to_csv(tmp_path / "jn.csv",
                                               index=False)
    trun.pair_time_machine_reports(
        Table.read_csv(str(tmp_path / "num.csv"))).to_csv(
            str(tmp_path / "tn.csv"))
    assert (tmp_path / "jn.csv").read_bytes() == \
        (tmp_path / "tn.csv").read_bytes()


@pytest.mark.parametrize("suffix", [".xlsx", ".xls", ".feather"])
def test_other_formats_raise_naming_the_format(tmp_path, suffix):
    """``.xlsx`` and ``.feather`` are read; ``.xls`` (xlrd's BIFF8) raises
    naming the format."""
    path = tmp_path / f"reports{suffix}"
    rows = [["BDMAP ID", "Report Text", "n"], ["A", "a mass", 1],
            ["B", None, 2], ["C", "normal", 3]]
    if suffix == ".xlsx":
        _write_xlsx(path, [("Sheet1", rows)])
    elif suffix == ".feather":
        pd.DataFrame(rows[1:], columns=rows[0]).to_feather(
            path, compression="uncompressed")
    else:
        path.write_bytes(b"")
        with pytest.raises(ValueError, match=suffix.split("s")[0]):
            trun.read_reports(str(path), "Report Text")
        return
    t = trun.read_reports(str(path), "Report Text")
    assert list(t.rows()) == [{"BDMAP ID": "A", "Report Text": "a mass",
                               "n": 1},
                              {"BDMAP ID": "C", "Report Text": "normal",
                               "n": 3}]
    assert t["n"].kind == "int"


# ------------------------------------------------------------ .xlsx, .feather
_XLSX_MAIN = "http://schemas.openxmlformats.org/spreadsheetml/2006/main"
_XLSX_REL = ("http://schemas.openxmlformats.org/officeDocument/2006/"
             "relationships")
_EXCEL_EPOCH = datetime.datetime(1899, 12, 30)


def _col(j):
    name = ""
    while j:
        j, r = divmod(j - 1, 26)
        name = chr(65 + r) + name
    return name


def _xml_text(t):
    return (t.replace("&", "&amp;").replace("<", "&lt;")
            .replace(">", "&gt;"))


def _write_xlsx(path, sheets, date1904=False):
    """An ``.xlsx`` written by hand (no openpyxl here): `sheets` is a list
    of (name, rows); a row is a list of cells, or ``("at", r, cells)`` to
    put it at row number r (rows in between are missing). A cell is None
    (no ``<c>``: a gap), text (shared strings and inline strings in
    turns), ``("rich", [runs])`` (a shared string of runs),
    ``("formula", text)`` (a formula's cached text, ``t="str"``),
    ``("error", "#N/A")``, a bool, a number, or a datetime (a serial day
    number in the built-in date format 14 if it is midnight, else in the
    custom format ``yyyy-mm-dd hh:mm:ss``)."""
    shared, turn = [], [0]
    epoch = datetime.datetime(1904, 1, 1) if date1904 else _EXCEL_EPOCH

    def cell(ref, v):
        if isinstance(v, tuple) and v[0] == "rich":
            shared.append("".join(f"<r><rPr><b/></rPr><t xml:space="
                                  f'"preserve">{_xml_text(t)}</t></r>'
                                  for t in v[1]))
            return f'<c r="{ref}" t="s"><v>{len(shared) - 1}</v></c>'
        if isinstance(v, tuple) and v[0] == "formula":
            return (f'<c r="{ref}" t="str"><f>CONCAT("a")</f>'
                    f"<v>{_xml_text(v[1])}</v></c>")
        if isinstance(v, tuple) and v[0] == "error":
            return f'<c r="{ref}" t="e"><v>{v[1]}</v></c>'
        if isinstance(v, str):
            turn[0] += 1
            if turn[0] % 2:
                shared.append(f"<t>{_xml_text(v)}</t>")
                return f'<c r="{ref}" t="s"><v>{len(shared) - 1}</v></c>'
            return (f'<c r="{ref}" t="inlineStr"><is><t>{_xml_text(v)}'
                    f"</t></is></c>")
        if isinstance(v, bool):
            return f'<c r="{ref}" t="b"><v>{int(v)}</v></c>'
        if isinstance(v, datetime.datetime):
            days = (v - epoch).total_seconds() / 86400
            style = 1 if v.time() == datetime.time() else 2
            return f'<c r="{ref}" s="{style}"><v>{days!r}</v></c>'
        return f'<c r="{ref}"><v>{v!r}</v></c>'

    files = {}
    for k, (name, rows) in enumerate(sheets, 1):
        lines, r = [], 0
        for row in rows:
            r = row[1] if isinstance(row, tuple) else r + 1
            cells = row[2] if isinstance(row, tuple) else row
            body = "".join(cell(f"{_col(j)}{r}", v)
                           for j, v in enumerate(cells, 1) if v is not None)
            lines.append(f'<row r="{r}">{body}</row>')
        files[f"xl/worksheets/sheet{k}.xml"] = (
            f'<worksheet xmlns="{_XLSX_MAIN}"><sheetData>'
            + "".join(lines) + "</sheetData></worksheet>")
    files["xl/sharedStrings.xml"] = (
        f'<sst xmlns="{_XLSX_MAIN}">'
        + "".join(f"<si>{si}</si>" for si in shared) + "</sst>")
    files["xl/styles.xml"] = (
        f'<styleSheet xmlns="{_XLSX_MAIN}"><numFmts count="1">'
        '<numFmt numFmtId="164" formatCode="yyyy-mm-dd hh:mm:ss"/></numFmts>'
        '<cellXfs count="3"><xf numFmtId="0"/><xf numFmtId="14"/>'
        '<xf numFmtId="164"/></cellXfs></styleSheet>')
    files["xl/workbook.xml"] = (
        f'<workbook xmlns="{_XLSX_MAIN}" xmlns:r="{_XLSX_REL}">'
        + ('<workbookPr date1904="1"/>' if date1904 else "") + "<sheets>"
        + "".join(f'<sheet name="{n}" sheetId="{k}" r:id="rId{k}"/>'
                  for k, (n, _) in enumerate(sheets, 1))
        + "</sheets></workbook>")
    rel = "http://schemas.openxmlformats.org/package/2006/relationships"
    kinds = [(f"rId{k}", "worksheet", f"worksheets/sheet{k}.xml")
             for k in range(1, len(sheets) + 1)]
    kinds += [("rIdS", "sharedStrings", "sharedStrings.xml"),
              ("rIdT", "styles", "styles.xml")]
    files["xl/_rels/workbook.xml.rels"] = (
        f'<Relationships xmlns="{rel}">'
        + "".join(f'<Relationship Id="{i}" Type="{_XLSX_REL}/{t}" '
                  f'Target="{tg}"/>' for i, t, tg in kinds)
        + "</Relationships>")
    files["_rels/.rels"] = (
        f'<Relationships xmlns="{rel}"><Relationship Id="rId1" '
        f'Type="{_XLSX_REL}/officeDocument" Target="xl/workbook.xml"/>'
        "</Relationships>")
    files["[Content_Types].xml"] = (
        '<Types xmlns="http://schemas.openxmlformats.org/package/2006/'
        'content-types"/>')
    with zipfile.ZipFile(path, "w") as zf:
        for name, text in files.items():
            zf.writestr(name, '<?xml version="1.0" encoding="UTF-8"?>' + text)


def _plain(cell):
    """A cell as pandas prints it after the CSV round trip: rich runs
    joined, a formula's text, errors and gaps empty, dates as a
    ``Timestamp`` prints."""
    if isinstance(cell, tuple):
        return "" if cell[0] == "error" else (
            "".join(cell[1]) if cell[0] == "rich" else cell[1])
    if cell is None:
        return ""
    if isinstance(cell, datetime.datetime):
        return str(pd.Timestamp(cell))
    return cell


def _opened(cell):
    """A cell as openpyxl reads it and pandas' Excel reader hands it to its
    parser."""
    if isinstance(cell, tuple):
        return float("nan") if cell[0] == "error" else _plain(cell)
    return "" if cell is None else cell


def _same_cells(table, frame):
    """Every column of the port's table equals the pandas frame's: missing
    with missing, dates by their text."""
    assert list(table.columns) == list(frame.columns)
    for name in frame.columns:
        want = [None if pd.isna(v) else
                str(v) if isinstance(v, (pd.Timestamp, datetime.datetime))
                else v for v in frame[name]]
        got = [None if isna(v) else
               str(v) if isinstance(v, datetime.datetime) else v
               for v in table[name].values]
        assert got == want, name


_XLSX_HEADER = ["BDMAP ID", "Report Text", "Assigned Number",
                "Exam Started Date", "score", "gappy", "flag",
                "pancreatic cancer timeline"]


def _xlsx_rows(n=24, seed=3):
    rng = np.random.default_rng(seed)
    rows = []
    for i in range(n):
        day = datetime.datetime(2019, 1, 1) + datetime.timedelta(
            days=int(rng.integers(0, 900)),
            seconds=int(rng.integers(0, 3)) * 3600 * 7)
        text = [None, "mass in the head", ("rich", ["bold ", "cyst, 2 cm"]),
                ("formula", "hypodense"), "normal, \"clear\""][i % 5]
        score = round(float(rng.normal()), 3)
        rows.append([f"BDMAP_{i:05d}", text, int(rng.integers(0, 6)),
                     day if i % 7 else None,
                     ("error", "#N/A") if i % 11 == 4 else score,
                     None if i % 3 else int(rng.integers(0, 100)),
                     bool(i % 2),
                     ["pre-diagnosis", "first positive", ""][i % 3] or None])
    return rows


@pytest.mark.parametrize("layout", ["second_sheet", "one_sheet"])
def test_xlsx_reads_as_the_csv_of_the_same_table(tmp_path, layout):
    """A hand-written ``.xlsx`` (shared, inline and rich-text strings, a
    formula's cached text, an error cell, gaps in the cell references, a
    missing row, bools, numbers, dates in a built-in and a custom format)
    read by ``read_reports`` (sheet 1; a one-sheet workbook falls back to
    its first) gives the rows and kinds the JAX ``read_reports`` gives
    for the same table saved as ``.csv``, dates as pandas prints them."""
    rows = _xlsx_rows()
    body = [_XLSX_HEADER] + rows[:10] + [("at", 14, rows[10])] + rows[11:]
    other = [["something", "else"], [1, 2]]
    sheets = [("Reports", body)] if layout == "one_sheet" else \
        [("Summary", other), ("Reports", body)]
    _write_xlsx(tmp_path / "r.xlsx", sheets)
    plain = [[_plain(c) for c in r] for r in rows]
    blank = [[""] * len(_XLSX_HEADER)] * 2  # rows 12 and 13 are missing
    pd.DataFrame(plain[:10] + blank + plain[10:],
                 columns=_XLSX_HEADER).to_csv(tmp_path / "r.csv", index=False)
    jt = jrun.read_reports(str(tmp_path / "r.csv"), "Report Text")
    tt = trun.read_reports(str(tmp_path / "r.xlsx"), "Report Text")
    assert 0 < len(tt) < len(rows)
    _same_cells(tt, jt)
    # the kinds are those pandas' Excel reader gives the cells openpyxl
    # reads (its parser on them: a bool column with a blank is float
    # there, object in a CSV)
    cells = [[_opened(c) for c in r] for r in rows]
    xf = TextParser([_XLSX_HEADER] + cells[:10] + blank + cells[10:],
                    header=0, skip_blank_lines=False).read()
    xf = xf.dropna(subset=["Report Text"])
    _same_cells(tt, xf)
    kinds = {"int64": "int", "float64": "float", "bool": "bool"}
    for name in _XLSX_HEADER:
        want = "datetime" if str(xf[name].dtype).startswith("datetime") \
            else kinds.get(str(xf[name].dtype), "object")
        assert tt[name].kind == want, name
    assert jrun.read_reports(str(tmp_path / "r.csv")).shape[0] == \
        len(trun.read_reports(str(tmp_path / "r.xlsx"))) == len(rows) + 2


def test_xlsx_cells_as_openpyxl_reads_them(tmp_path):
    """Sheet choice by index and name, the 1904 date system, a time of
    day, the elapsed-time format and the kinds of mixed columns."""
    from rsuper_tpu_torch.data import table as T

    _write_xlsx(tmp_path / "a.xlsx", [
        ("one", [["x"], [1]]),
        ("two", [["when", "mixed", "bools"],
                 [datetime.datetime(2001, 2, 3, 4, 5, 6), "a", True],
                 [datetime.datetime(2001, 2, 3), 3, None]])],
        date1904=True)
    t = Table.read_xlsx(str(tmp_path / "a.xlsx"), "two")
    assert [str(v) for v in t["when"].values] == ["2001-02-03 04:05:06",
                                                  "2001-02-03 00:00:00"]
    assert t["mixed"].values == ["a", 3] and t["mixed"].kind == "object"
    assert t["bools"].kind == "float" and t["bools"].values[0] == 1.0
    assert list(Table.read_xlsx(str(tmp_path / "a.xlsx"), 0).rows()) == \
        [{"x": 1}]
    with pytest.raises(IndexError):
        Table.read_xlsx(str(tmp_path / "a.xlsx"), 2)
    assert str(T._from_excel(0.5625, T._WINDOWS_EPOCH, False)) == "13:30:00"
    td = T.Column.from_objects([T._from_excel(1.0625, T._WINDOWS_EPOCH, True),
                                ""])
    assert td.kind == "timedelta" and str(td.values[0]) == "1 days 01:30:00"
    assert str(td.values[1]) == "NaT"


def _feather_frame(tmp_path):
    csv = tmp_path / "reports.csv"
    df = _reports(csv)
    rng = np.random.default_rng(1)
    df["Exam Started Date"] = pd.to_datetime(df["Exam Started Date"]) + \
        pd.to_timedelta(rng.integers(0, 3, len(df)) * 5400, unit="s")
    df.loc[3, "Exam Started Date"] = pd.NaT
    df["Assigned Number"] = df["Assigned Number"].astype("int32")
    df["score"] = [None if i % 4 == 0 else i for i in range(len(df))]
    df["flag"] = [True if i % 3 else None for i in range(len(df))]
    df["flag"] = df["flag"].astype(object)
    df["done"] = [i % 2 == 0 for i in range(len(df))]
    return df


@pytest.mark.parametrize("compression", ["lz4", "uncompressed"])
def test_feather_reads_as_pandas(tmp_path, compression):
    """A table of strings, ints, floats, blanks and dates written by
    pandas' ``to_feather``: the port's ``read_reports`` gives pandas' rows
    and kinds, and the time machine's pairs and payloads are pandas'."""
    df = _feather_frame(tmp_path)
    path = tmp_path / "r.feather"
    df.to_feather(path, compression=compression)
    jt = jrun.read_reports(str(path), "Report Text")
    tt = trun.read_reports(str(path), "Report Text")
    assert 0 < len(tt) < len(df)
    _same_cells(tt, jt)
    kinds = {"int64": "int", "int32": "int", "float64": "float",
             "bool": "bool"}
    for name in jt.columns:
        want = "datetime" if str(jt[name].dtype).startswith("datetime") \
            else kinds.get(str(jt[name].dtype), "object")
        assert tt[name].kind == want, name
    jp = jrun.pair_time_machine_reports(
        jt.rename(columns={"BDMAP ID": "BDMAP_ID"}))
    tp = trun.pair_time_machine_reports(tt.rename({"BDMAP ID": "BDMAP_ID"}))
    assert len(tp) > 1 and any("00:00" in p for p in tp["Report Text"])
    jp.to_csv(tmp_path / "jp.csv", index=False)
    tp.to_csv(str(tmp_path / "tp.csv"))
    assert (tmp_path / "jp.csv").read_bytes() == \
        (tmp_path / "tp.csv").read_bytes()


def _categorical_frame(tmp_path):
    """``_feather_frame`` with pandas categoricals: string categories with
    missing cells, ordered integer categories with missing cells, float
    categories, and a category column of one value."""
    df = _feather_frame(tmp_path)
    n = len(df)
    rng = np.random.default_rng(2)
    df["timeline"] = df["pancreatic cancer timeline"].astype("category")
    df["organ"] = pd.Categorical(
        rng.choice(["liver", "pancreas", "kidney", None], n))
    df["grade"] = pd.Categorical(rng.choice([3, 1, 2, None], n),
                                 categories=[1, 2, 3], ordered=True)
    df["size"] = pd.Categorical(rng.choice([1.5, 2.25, np.nan], n))
    df["site"] = pd.Categorical(["A"] * n)
    return df


def _same_as_pandas(path, tt):
    """The port's table holds pandas' cells of the same file, cell for cell
    and type for type (categoricals as ``astype(object)`` gives them), and
    pandas' kinds."""
    jt = jrun.read_reports(str(path), "Report Text")
    _same_cells(tt, jt)
    kinds = {"int64": "int", "int32": "int", "float64": "float",
             "bool": "bool"}
    for name in jt.columns:
        want = "datetime" if str(jt[name].dtype).startswith("datetime") \
            else kinds.get(str(jt[name].dtype), "object")
        assert tt[name].kind == want, name
        if str(jt[name].dtype) == "category":
            cells = [None if pd.isna(v) else type(v).__name__
                     for v in jt[name].astype(object)]
            assert [None if isna(v) else type(v).__name__
                    for v in tt[name].values] == cells, name


@pytest.mark.parametrize("compression", ["zstd", "lz4", "uncompressed"])
def test_feather_categoricals_read_as_pandas(tmp_path, compression):
    """Categorical columns written by pandas' ``to_feather`` (several
    record batches through `chunksize`, one dictionary each) under each
    compression: the port's ``read_reports`` gives pandas' cells and
    kinds."""
    df = _categorical_frame(tmp_path)
    path = tmp_path / "c.feather"
    df.to_feather(path, compression=compression, chunksize=7)
    tt = trun.read_reports(str(path), "Report Text")
    assert 0 < len(tt) < len(df)
    _same_as_pandas(path, tt)


@pytest.mark.parametrize("index_type", ["int8", "int16", "int32", "int64"])
def test_feather_dictionary_deltas_read_as_pandas(tmp_path, index_type):
    """A file of three record batches whose dictionaries grow by delta
    batches (pyarrow's ``emit_dictionary_deltas``), ZSTD bodies, string and
    integer dictionaries indexed by `index_type`, missing cells."""
    import pyarrow as pa
    import pyarrow.ipc as ipc

    it = getattr(pa, index_type)()
    words = ["liver", "kidney", "pancreas", "spleen", "aorta", "colon"]
    batches, known = [], 2
    for b, idx in enumerate(([0, 1, None, 1], [2, 0, 3, None, 1],
                             [5, 4, 0, None, 5, 2])):
        known = max([known] + [i + 1 for i in idx if i is not None])
        text = pa.DictionaryArray.from_arrays(pa.array(idx, it),
                                              pa.array(words[:known]))
        nums = pa.DictionaryArray.from_arrays(
            pa.array([None if i is None else known - 1 - i for i in idx],
                     it), pa.array([10 * k for k in range(known)]))
        report = pa.array([f"report {b}-{i}" for i in range(len(idx))])
        batches.append((text, nums, report))
    schema = pa.schema([("organ", batches[0][0].type),
                        ("grade", batches[0][1].type),
                        ("Report Text", pa.large_string())])
    path = tmp_path / "d.feather"
    opts = ipc.IpcWriteOptions(emit_dictionary_deltas=True,
                               compression="zstd")
    with ipc.new_file(str(path), schema, options=opts) as w:
        for cols in batches:
            w.write_batch(pa.record_batch(list(cols), schema=schema))
    tt = trun.read_reports(str(path), "Report Text")
    assert len(tt) == 15 and tt["organ"].values[-2] == "colon"
    _same_as_pandas(path, tt)


def test_feather_zstd_and_categoricals_raise(tmp_path):
    """What the reader still refuses: a ZSTD frame that names a dictionary
    (pyarrow never writes one), a corrupt ZSTD body, a dictionary index out
    of range, and a time zone other than UTC."""
    import pyarrow as pa
    import pyarrow.ipc as ipc

    df = _categorical_frame(tmp_path)
    df.to_feather(tmp_path / "z.feather", compression="zstd")
    data = (tmp_path / "z.feather").read_bytes()
    at = data.index(ZSTD_MAGIC)
    fhd = data[at + 4]
    assert fhd & 3 == 0  # no dictionary ID field: make one of two bytes
    named = data[:at + 4] + bytes([fhd | 2]) + data[at + 5:]
    (tmp_path / "named.feather").write_bytes(named)
    with pytest.raises(ValueError, match="dictionary"):
        trun.read_reports(str(tmp_path / "named.feather"), "Report Text")
    bad = data[:at] + b"\0" * 4 + data[at + 4:]
    (tmp_path / "bad.feather").write_bytes(bad)
    with pytest.raises(ValueError, match="Zstandard"):
        trun.read_reports(str(tmp_path / "bad.feather"), "Report Text")
    arr = pa.DictionaryArray.from_arrays(pa.array([0, 1], pa.int8()),
                                         pa.array(["a", "b"]))
    schema = pa.schema([("c", arr.type)])
    path = tmp_path / "range.feather"
    with ipc.new_file(str(path), schema) as w:
        w.write_batch(pa.record_batch([arr], schema=schema))
    raw = bytearray(path.read_bytes())
    body = raw.index(bytes([0, 1]) + b"\0" * 6)  # the indices buffer
    raw[body + 1] = 7
    path.write_bytes(bytes(raw))
    with pytest.raises(ValueError, match="range"):
        Table.read_feather(str(path))
    pd.DataFrame({"t": pd.to_datetime(["2020-01-01"]).tz_localize(
        "Asia/Tokyo")}).to_feather(tmp_path / "tz.feather")
    with pytest.raises(ValueError, match="time zone"):
        Table.read_feather(str(tmp_path / "tz.feather"))


FIXTURE = ROOT / "tests" / "data" / "reports_zstd_categorical.feather"


def fixture_frame(n=1500, seed=11):
    """The table of ``tests/data/reports_zstd_categorical.feather``, which
    ``chip_smoke.py`` reads on the card's machine (no pandas there). Written
    with ``fixture_frame().to_feather(path, compression="zstd",
    chunksize=500)``."""
    rng = np.random.default_rng(seed)
    words = ["liver", "mass", "2 cm,", "pancreatic", "cyst", "kidney",
             "normal", "segment 7", "head", "lesion", "hypodense", "no"]
    text = [None if i % 17 == 0 else
            " ".join(rng.choice(words, int(rng.integers(20, 60))))
            for i in range(n)]
    dates = pd.to_datetime("2015-01-01") + pd.to_timedelta(
        rng.integers(0, 3000, n), unit="D")
    df = pd.DataFrame({
        "BDMAP ID": [f"BDMAP_{i:05d}" for i in range(n)],
        "Report Text": text,
        "Exam Started Date": dates,
        "Assigned Number": rng.integers(0, 400, n).astype("int32"),
        "organ": pd.Categorical(rng.choice(["liver", "pancreas", "kidney",
                                            None], n)),
        "grade": pd.Categorical(rng.choice([1, 2, 3, None], n),
                                categories=[1, 2, 3], ordered=True),
        "pancreatic cancer timeline": pd.Categorical(rng.choice(
            ["pre-diagnosis", "first positive", None], n)),
    })
    df.loc[5, "Exam Started Date"] = pd.NaT
    return df


def test_feather_fixture_reads_as_pandas():
    """The committed fixture holds ``fixture_frame()``; the port reads it as
    pandas does, and its digest is the one ``chip_smoke.py`` checks on the
    card."""
    import chip_smoke

    pd.testing.assert_frame_equal(pd.read_feather(FIXTURE), fixture_frame())
    data = FIXTURE.read_bytes()
    assert data.count(ZSTD_MAGIC) > 10  # ZSTD bodies, several batches
    tt = trun.read_reports(str(FIXTURE), "Report Text")
    _same_as_pandas(FIXTURE, tt)
    assert chip_smoke.table_digest(tt) == chip_smoke.FEATHER_DIGEST


ZSTD_MAGIC = bytes.fromhex("28b52ffd")


def _zstd_inputs():
    """Random, repetitive and text inputs, each across the 128 KiB block
    size."""
    rng = np.random.default_rng(0)
    words = [b"mass", b"pancreas", b"lesion", b"the", b"hypodense", b"cm",
             b"liver", b"of", b"in", b"no", b"kidney", b"cyst", b"with"]
    return {
        "random": rng.bytes(300_000),
        "repetitive": b"abcabcabd" * 30_000 + b"\0" * 100_000
        + rng.bytes(1000) * 60 + bytes(np.minimum(
            rng.geometric(0.3, 60_000), 255).astype(np.uint8))
        + b"".join(bytes([int(c)]) * int(k) for c, k in zip(
            rng.integers(0, 256, 1000), rng.integers(1, 300, 1000)))
        + bytes(rng.choice(np.frombuffer(b"acgt", np.uint8), 200_000)),
        "text": b" ".join(words[i] for i in rng.integers(0, len(words),
                                                         60_000)),
    }


@pytest.mark.parametrize("level", [-5, 1, 3, 19])
@pytest.mark.parametrize("kind", ["random", "repetitive", "text"])
def test_zstd_decoder_matches_pyarrow(level, kind):
    import pyarrow as pa

    from rsuper_tpu_torch.data.table import zstd_decompress

    data = _zstd_inputs()[kind]
    assert len(data) > 2 * 128 * 1024
    codec = pa.Codec("zstd", compression_level=level)
    packed = codec.compress(data, asbytes=True)
    assert zstd_decompress(packed) == data == codec.decompress(
        packed, decompressed_size=len(data), asbytes=True)


def _zstd_frame(blocks, checksum_of=None):
    """A hand-written frame: single segment, no content size, the given
    (type, payload, regenerated size) blocks, and a checksum of
    `checksum_of` if given."""
    import xxhash

    # single segment, content-size flag 0: a content size of one byte
    fhd = 0x20 | (4 if checksum_of is not None else 0)
    out = bytearray(ZSTD_MAGIC) + bytes([fhd, 0])
    size = 0
    for k, (kind, payload, regen) in enumerate(blocks):
        last = k == len(blocks) - 1
        head = int(last) | (kind << 1) | ((regen if kind == 1 else
                                           len(payload)) << 3)
        out += head.to_bytes(3, "little") + payload
        size += regen
    out[5] = size
    if checksum_of is not None:
        out += (xxhash.xxh64(checksum_of).intdigest()
                & 0xFFFFFFFF).to_bytes(4, "little")
    return bytes(out)


def test_zstd_frames_skippable_checksummed_and_hand_written():
    """Frames with content checksums (``zstandard``'s writer), skippable
    frames between them, RLE blocks, and hand-written RLE and raw blocks
    and a compressed block of RLE literals without sequences; a wrong
    checksum raises."""
    import zstandard

    from rsuper_tpu_torch.data.table import zstd_decompress

    inputs = _zstd_inputs()
    skip = (0x184D2A53).to_bytes(4, "little") + (5).to_bytes(4, "little") \
        + b"hello"
    parts, want = [], b""
    for lvl, (kind, data) in zip((1, 9, 19), inputs.items()):
        parts += [zstandard.ZstdCompressor(
            level=lvl, write_checksum=True).compress(data[:150_000]), skip]
        want += data[:150_000]
    assert zstd_decompress(b"".join(parts)) == want
    zeros = zstandard.ZstdCompressor(level=3).compress(b"\0" * 300_000)
    assert zstd_decompress(zeros) == b"\0" * 300_000
    lits = bytes([(20 << 3) | 1]) + b"q" + b"\0"  # RLE literals, no seqs
    content = b"z" * 7 + b"raw!" + b"q" * 20
    frame = _zstd_frame([(1, b"z", 7), (0, b"raw!", 4), (2, lits, 20)],
                        checksum_of=content)
    assert zstd_decompress(frame) == content
    wrong = frame[:-1] + bytes([frame[-1] ^ 1])
    with pytest.raises(ValueError, match="checksum"):
        zstd_decompress(wrong)


def test_zstd_corrupt_frames_raise():
    """Truncations, a wrong magic number, reserved bits and block types,
    and flipped bytes of a checksummed frame raise ``ValueError``."""
    import zstandard

    from rsuper_tpu_torch.data.table import zstd_decompress

    data = _zstd_inputs()["text"][:200_000]
    frame = zstandard.ZstdCompressor(level=3, write_checksum=True) \
        .compress(data)
    assert zstd_decompress(frame) == data
    rng = np.random.default_rng(4)
    bad = [frame[:n] for n in (3, 5, 9, 40, len(frame) // 2,
                               len(frame) - 3)]
    bad.append(b"\x27" + frame[1:])
    bad.append(frame[:4] + bytes([frame[4] | 0x08]) + frame[5:])
    head = 6 + (frame[4] >> 6 == 1) * 2  # the first block header's offset
    h = int.from_bytes(frame[head:head + 3], "little") | (3 << 1)
    bad.append(frame[:head] + h.to_bytes(3, "little") + frame[head + 3:])
    for at in rng.integers(head + 3, len(frame) - 4, 12):
        bad.append(frame[:at] + bytes([frame[at] ^ 0x5A]) + frame[at + 1:])
    for b in bad:
        with pytest.raises(ValueError):
            zstd_decompress(b)


def test_xxh64_matches_xxhash():
    import xxhash

    from rsuper_tpu_torch.data.table import xxh64

    rng = np.random.default_rng(1)
    for n in list(range(0, 70)) + [1000, 4099]:
        data = rng.bytes(n)
        assert xxh64(data) == xxhash.xxh64(data).intdigest(), n


def test_lz4_frame_decoder_on_long_matches():
    """Overlapping matches, long literal and match runs, linked blocks:
    the frames pyarrow's LZ4 writes for a large repetitive buffer decode
    to it."""
    import pyarrow as pa

    from rsuper_tpu_torch.data.table import lz4_frame_decompress

    rng = np.random.default_rng(0)
    data = b"".join([b"a" * 300, rng.bytes(700), b"xyz" * 5000,
                     rng.bytes(70_000), b"\0" * 200_000, b"report " * 3000])
    packed = pa.compress(data, codec="lz4", asbytes=True)
    assert len(packed) < len(data)
    assert lz4_frame_decompress(packed) == data


def test_example_records_match_jax(tmp_path):
    csv = tmp_path / "reports.csv"
    df = _reports(csv)
    df = df.rename(columns={"BDMAP ID": "BDMAP_ID"})
    df.to_csv(csv, index=False)
    jt, tt = pd.read_csv(csv), Table.read_csv(str(csv))
    ids = [i for i, r in zip(df["BDMAP_ID"], df["Report Text"])
           if isinstance(r, str)][:3]
    for label in (None, "note", "Liver Tumor"):
        want = jrun.example_records(jt, ids, "BDMAP_ID", "Report Text", label)
        assert trun.example_records(tt, ids, "BDMAP_ID", "Report Text",
                                    label) == want
    assert tprompts.build_examples_block(
        trun.example_records(tt, ids, "BDMAP_ID", "Report Text")) == \
        jprompts.build_examples_block(
            jrun.example_records(jt, ids, "BDMAP_ID", "Report Text"))
    missing = [i for i, r in zip(df["BDMAP_ID"], df["Report Text"])
               if not isinstance(r, str)][:1]
    for bad in (["NOPE"], missing):
        for mod, table in ((jrun, jt), (trun, tt)):
            with pytest.raises(ValueError):
                mod.example_records(table, bad, "BDMAP_ID", "Report Text")
    no_flags = tt.rename({"Liver Tumor": "x"})
    with pytest.raises(ValueError, match="no label available"):
        trun.example_records(no_flags, ids, "BDMAP_ID", "Report Text")


def test_few_shot_prompts_match_jax(tmp_path):
    csv = tmp_path / "reports.csv"
    df = _reports(csv, n=12)
    ids = [i for i, r in zip(df["BDMAP ID"], df["Report Text"])
           if isinstance(r, str)][:2]
    got = []
    for mod in (jrun, trun):
        client = StubClient(fail=False)
        mod.run_extraction(str(csv), str(tmp_path / mod.__name__), client,
                           step="tumor_detection", examples=ids)
        got.append(client.prompts)
    assert got[0] == got[1] and "Report 2 labels:" in got[1][0]


def test_parsers_match_jax():
    rng = np.random.default_rng(0)
    corpus = list(ANSWERS)
    for _ in range(40):  # answers spliced from two others
        a, b = rng.integers(0, len(ANSWERS), 2)
        cut = int(rng.integers(0, len(ANSWERS[a])))
        corpus.append(ANSWERS[a][:cut] + ANSWERS[b][cut // 2:])
    for ans in corpus:
        for name in ("parse_lesion_answer", "parse_tumor_detection",
                     "parse_diagnoses", "parse_synonyms",
                     "parse_longitudinal", "parse_longitudinal_diagnosis",
                     "parse_matching_reports", "parse_hcc"):
            assert getattr(tparse, name)(ans) == getattr(jparse, name)(ans), \
                (name, ans)
        for strict in (False, True):
            assert tparse.parse_refine_normal_pancreas(ans, strict) == \
                jparse.parse_refine_normal_pancreas(ans, strict)
        for organ in ORGANS:
            for name in ("parse_malignancy", "parse_single_organ_lesions",
                         "parse_malignant_size", "parse_time_machine"):
                assert getattr(tparse, name)(ans, organ) == \
                    getattr(jparse, name)(ans, organ), (name, organ, ans)


def test_metadata_matches_jax(tmp_path):
    for name in ("ORGAN_SYNONYMS", "CYST_TERMS", "_LIVER_SEGMENT_VARIATIONS",
                 "_LIVER_PHRASE_GROUPS", "_PANCREAS_REGION_VARIATIONS",
                 "_PANCREAS_PHRASE_COMBOS", "_MALIGNANT_BY_ORGAN",
                 "_BENIGN_BY_ORGAN", "_MALIGNANT_GLOBAL", "_BENIGN_GLOBAL"):
        assert getattr(tmeta, name) == getattr(jmeta, name), name
    phrases = sorted({p for table in (jmeta.ORGAN_SYNONYMS,
                                      jmeta._LIVER_SEGMENT_VARIATIONS,
                                      jmeta._LIVER_PHRASE_GROUPS,
                                      jmeta._PANCREAS_REGION_VARIATIONS,
                                      jmeta._PANCREAS_PHRASE_COMBOS,
                                      jmeta._MALIGNANT_BY_ORGAN,
                                      jmeta._BENIGN_BY_ORGAN)
                      for ps in table.values() for p in ps})
    rng = np.random.default_rng(1)
    phrases += [" ".join(rng.choice(phrases, 2)) for _ in range(200)]
    phrases += ["Right Lobe", "u", "", "nan", "left and right", None,
                float("nan"), 3]
    organs = [None, "liver", "pancreas", "kidney", "lung", "spleen",
              "mesentery", "Liver "]
    for p in phrases:
        assert tmeta.standardize_organ(p) == jmeta.standardize_organ(p), p
        for fn in ("map_liver_location", "map_pancreas_location",
                   "map_bilateral_location"):
            assert getattr(tmeta, fn)(p) == getattr(jmeta, fn)(p), (fn, p)
        for o in organs:
            assert tmeta.standardize_location(p, o) == \
                jmeta.standardize_location(p, o)
            assert tmeta.classify_two(o, p) == jmeta.classify_two(o, p)
            assert tmeta.classify_lesion(p, o) == jmeta.classify_lesion(p, o)

    parsed = {f"C{i}": jparse.parse_lesion_answer(a)
              for i, a in enumerate(ANSWERS[:5] * 2)}
    parsed["C7"] = []
    jt = jmeta.build_per_tumor_csv(parsed)
    tt = tmeta.build_per_tumor_csv(parsed)
    jt.to_csv(tmp_path / "jt.csv", index=False)
    tt.to_csv(str(tmp_path / "tt.csv"))
    assert (tmp_path / "jt.csv").read_bytes() == \
        (tmp_path / "tt.csv").read_bytes()
    jmeta.build_per_ct_csv(jt).to_csv(tmp_path / "jc.csv", index=False)
    tmeta.build_per_ct_csv(tt).to_csv(str(tmp_path / "tc.csv"))
    assert (tmp_path / "jc.csv").read_bytes() == \
        (tmp_path / "tc.csv").read_bytes()
    assert len(tmeta.build_per_tumor_csv({})) == 0
    # a repeated (case, tumour) pair keeps its last row, as pandas does
    dup = Table.from_rows([{"BDMAP_ID": "A", "Tumor ID": 1, "v": "x"},
                           {"BDMAP_ID": "B", "Tumor ID": 1, "v": "y"},
                           {"BDMAP_ID": "A", "Tumor ID": 1, "v": "z"}])
    kept = dup.drop_duplicates(["BDMAP_ID", "Tumor ID"], keep="last")
    assert list(kept["v"]) == ["y", "z"]
    assert list(dup.drop_duplicates("BDMAP_ID")["v"]) == ["x", "y"]


def test_prompts_equal_jax():
    names = [n for n in dir(jprompts) if n.isupper()]
    assert len(names) > 20
    for n in names:
        assert getattr(tprompts, n) == getattr(jprompts, n), n
    assert tprompts.build_time_machine_payload("a", "2020", "b", 3) == \
        jprompts.build_time_machine_payload("a", "2020", "b", 3)
    assert tprompts.build_examples_block([]) == ""


class _Response:
    def __init__(self, body):
        self.body = body

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def read(self):
        return self.body


def test_client_sends_the_jax_request_and_retries(monkeypatch):
    """The HTTP call is a stub: the request each client builds, its
    retries and back-off, and the batch's failures are the JAX client's."""
    calls, sleeps = [], []

    def urlopen(req, timeout):
        calls.append((req.full_url, req.data, sorted(req.header_items()),
                      timeout))
        if "fail" in req.data.decode():
            raise OSError("refused")
        text = json.loads(req.data)["messages"][1]["content"]
        return _Response(json.dumps(
            {"choices": [{"message": {"content": text.upper()}}]}).encode())

    monkeypatch.setattr(jclient.urllib.request, "urlopen", urlopen)
    monkeypatch.setattr(tclient.urllib.request, "urlopen", urlopen)
    monkeypatch.setattr(jclient.time, "sleep", sleeps.append)
    monkeypatch.setattr(tclient.time, "sleep", sleeps.append)
    got = []
    for mod in (jclient, tclient):
        calls.clear()
        sleeps.clear()
        c = mod.LLMClient(base_url="http://stub/v1/", model="m",
                          max_retries=2, timeout=5.0)
        out = [c.chat("sys", "hello")]
        with pytest.raises(RuntimeError, match="after retries"):
            c.chat("sys", "fail always")
        out.append(c.chat_batch("sys", ["a", "b"], workers=1))
        got.append((out, list(calls), list(sleeps)))
    assert got[0] == got[1]
    assert got[1][0][0] == "HELLO" and got[1][2] == [1.0, 2.0]


def test_isin_matches_pandas_on_missing_cells(tmp_path):
    """The resume filter's ``isin``: a missing id is done when a missing id
    was answered, as in pandas."""
    (tmp_path / "ids.csv").write_text("BDMAP_ID,n\nA,1\n,2\n7,3\n")
    col = Table.read_csv(str(tmp_path / "ids.csv"))["BDMAP_ID"]
    ser = pd.read_csv(tmp_path / "ids.csv")["BDMAP_ID"]
    for done in ({"A"}, {"A", float("nan")}, {"7", 7}, set()):
        assert col.isin(done) == ser.isin(done).tolist(), done
