"""Resumable report extraction (counterpart of
``rsuper_tpu/report_extraction/run.py``; the reference's ``RunRadGPT.py``,
``RadGPT.inference_loop``, ``postprocess.py`` and ``create_metadata.py``):
read a reports table, shard it across parts, ask the LLM about each report
(skipping ids already answered), append the raw answers, then standardise
them into the per-tumour and per-CT CSVs, or one CSV for each other step.

Tables are ``data/table.py``'s: a ``.csv``, ``.xlsx`` or ``.feather`` is
read as pandas reads it and every CSV is written with the bytes of pandas'
``to_csv(index=False)``. An ``.xls`` (xlrd's format) raises
``ValueError``.

    python -m rsuper_tpu_torch.report_extraction.run \\
        --reports reports.csv --out_dir extraction/ \\
        --base_url http://localhost:8000/v1 --parts 4 --part 0
"""

from __future__ import annotations

import argparse
import json
import os
from typing import Dict, List, Sequence

import numpy as np

from ..data.table import Column, Table, isna, timestamp_ns
from . import parse as P
from . import prompts as PR
from .client import LLMClient
from .metadata import build_per_ct_csv, build_per_tumor_csv
from .parse import (
    parse_lesion_answer,
    parse_malignancy,
    parse_malignant_size,
    parse_single_organ_lesions,
    parse_tumor_detection,
)
from .prompts import ORGAN_LOCATIONS

# extraction steps of the reference's RadGPT prompt library
# (``get_instuctions`` / ``interpret_output``): 'type and size multi-organ'
# is the R-Super training step; the rest are its screening, per-organ and
# research steps
STEPS = {
    "type_and_size": (PR.LESION_EXTRACTION_SYSTEM, PR.LESION_EXTRACTION_USER),
    "tumor_detection": (PR.TUMOR_DETECTION_SYSTEM, PR.TUMOR_DETECTION_USER),
    "malignancy": (PR.MALIGNANCY_SYSTEM, PR.MALIGNANCY_USER),
    "type_and_size_organ": (PR.TYPE_SIZE_ORGAN_SYSTEM,
                            PR.TYPE_SIZE_ORGAN_USER),
    "type_and_size_pathology": (PR.TYPE_SIZE_PATHOLOGY_SYSTEM,
                                PR.TYPE_SIZE_PATHOLOGY_USER),
    "malignant_size": (PR.MALIGNANT_SIZE_SYSTEM, PR.MALIGNANT_SIZE_USER),
    "hcc": (PR.HCC_SYSTEM, PR.HCC_USER),
    "diagnoses": (PR.DIAGNOSES_SYSTEM, PR.DIAGNOSES_USER),
    "synonyms": (PR.SYNONYMS_SYSTEM, PR.SYNONYMS_USER),
    "longitudinal_pancreas": (PR.LONGITUDINAL_SYSTEM, PR.LONGITUDINAL_USER),
    "longitudinal_pancreas_diagnosis": (PR.LONGITUDINAL_DIAG_SYSTEM,
                                        PR.LONGITUDINAL_DIAG_USER),
    "refine_normal_pancreas": (PR.REFINE_NORMAL_SYSTEM,
                               PR.REFINE_NORMAL_USER),
    "matching_reports": (PR.MATCHING_REPORTS_SYSTEM,
                         PR.MATCHING_REPORTS_USER),
    "time_machine": (PR.TIME_MACHINE_SYSTEM, PR.TIME_MACHINE_USER),
}


def read_reports(path: str, report_column: str | None = None) -> Table:
    """The reports table in any of the reference's input formats
    (``RunRadGPT.py``): ``.csv``, ``.xlsx`` (sheet 1, falling back to the
    first sheet, as ``pandas.read_excel(sheet_name=1)`` then the default
    sheet) and ``.feather``, without the rows whose report text is missing.
    ``.xls`` (BIFF8, which pandas reads through xlrd) raises
    ``ValueError``."""
    lower = path.lower()
    if lower.endswith(".xls"):
        raise ValueError(
            f"{path}: .xls (BIFF8) report tables need pandas' xlrd reader, "
            "which the port does not have; save it as .xlsx or .csv")
    if lower.endswith(".xlsx"):
        try:
            table = Table.read_xlsx(path, 1)
        except Exception:  # the reference falls back on any failure
            table = Table.read_xlsx(path)
    elif lower.endswith(".feather"):
        table = Table.read_feather(path)
    else:
        table = Table.read_csv(path)
    if report_column and report_column in table:
        table = table.filter([not isna(v) for v in table[report_column]])
    return table


_DETECTION_LABEL_COLS = ("Liver Tumor", "Kidney Tumor", "Pancreas Tumor")


def example_records(table: Table, example_ids, id_column: str,
                    report_column: str, label_column: str | None = None):
    """(report, label) pairs for the few-shot example ids (reference
    ``get_report_n_label``: the label is either an explicit column or the
    detection-flag triple 'liver tumor=N; kidney tumor=N; pancreas
    tumor=N'). A missing report or label raises ``ValueError``, as in the
    reference."""
    recs = []
    ids = table[id_column].astype_str()
    for ex in example_ids:
        hit = [i for i, v in enumerate(ids) if v == str(ex)]
        if not hit:
            raise ValueError(f"example id {ex!r} not found in {id_column}")
        row = next(table.take(hit[:1]).rows())
        report = row[report_column]
        if not isinstance(report, str):
            raise ValueError(f"no report text for example {ex!r}")
        if label_column:
            label = row[label_column]
            if isna(label):
                raise ValueError(f"no {label_column!r} label for {ex!r}")
            label = str(label)
        else:
            try:
                label = "; ".join(
                    f"{c.split()[0].lower()} tumor={int(row[c])}"
                    for c in _DETECTION_LABEL_COLS)
            except (KeyError, TypeError, ValueError):
                raise ValueError(
                    f"no label available for example {ex!r}: need "
                    f"{list(_DETECTION_LABEL_COLS)} columns or "
                    "--label_column")
        recs.append((report, label))
    return recs


def _sort_order(col: Column) -> List[int]:
    """Row order of pandas' ``sort_values`` on one column: numbers and
    dates (by their nanoseconds) by numpy's quicksort (not stable), text
    stably; missing cells last."""
    present = [i for i, v in enumerate(col) if not isna(v)]
    missing = [i for i, v in enumerate(col) if isna(v)]
    values = [col.values[i] for i in present]
    if col.kind == "datetime":
        values = [timestamp_ns(v) for v in values]
    if col.kind in ("int", "float", "bool", "datetime"):
        order = np.argsort(np.asarray(values), kind="quicksort").tolist()
    else:
        order = sorted(range(len(values)), key=values.__getitem__)
    return [present[k] for k in order] + missing


def pair_time_machine_reports(
    table: Table,
    id_column: str = "BDMAP_ID",
    report_column: str = "Report Text",
    timeline_column: str = "pancreatic cancer timeline",
    patient_column: str = "Assigned Number",
    date_column: str = "Exam Started Date",
) -> Table:
    """The 'time machine' pairing (reference ``get_first_malignancy``):
    keep the exams whose timeline marks a 'pre-diagnosis' report, pair each
    with the same patient's chronologically first 'first positive' report,
    and compose the two-report payload of the prompt. A row without such a
    report is dropped (the reference raises; skipping keeps a sharded run
    alive). One sort finds every patient's first positive."""
    firsts_rows = table.filter([v == "first positive"
                                for v in table[timeline_column]])
    firsts_rows = firsts_rows.take(_sort_order(firsts_rows[date_column]))
    firsts: Dict[object, Dict[str, object]] = {}
    for patient, row in zip(firsts_rows[patient_column], firsts_rows.rows()):
        if not isna(patient):
            firsts.setdefault(patient, row)
    ids, payloads = [], []
    for r in table.rows():
        timeline = r.get(timeline_column)
        if not isinstance(timeline, str) or "pre-diagnosis" not in timeline:
            continue
        diag = firsts.get(r[patient_column])
        if diag is None:
            continue
        ids.append(r[id_column])
        payloads.append(PR.build_time_machine_payload(
            str(r[report_column]), r.get(date_column),
            str(diag[report_column]), diag[date_column]))
    return Table({id_column: Column.from_values(ids),
                  report_column: Column.from_values(payloads)})


def run_extraction(
    reports_csv: str,
    out_dir: str,
    client: LLMClient,
    id_column: str = "BDMAP_ID",
    report_column: str = "Report Text",
    parts: int = 1,
    part: int = 0,
    batch: int = 8,
    step: str = "type_and_size",
    organ: str = "liver",
    timeline_column: str = "pancreatic cancer timeline",
    examples=(),
    label_column: str | None = None,
) -> None:
    """Ask `client` about every report of part `part` of `parts` that has
    no answer in ``<out_dir>/raw_answers_part<part>.jsonl`` yet, `batch`
    reports a call, appending each answer there."""
    os.makedirs(out_dir, exist_ok=True)
    raw_path = os.path.join(out_dir, f"raw_answers_part{part}.jsonl")
    system, user = STEPS[step]
    system = system.replace("{organ}", organ).replace(
        "{organ_locations}", ORGAN_LOCATIONS.get(organ, "left, right")
    )

    table = read_reports(reports_csv, report_column)
    if "BDMAP ID" in table:
        table = table.rename({"BDMAP ID": id_column})
    prefix = ""
    if examples:
        prefix = PR.build_examples_block(example_records(
            table, examples, id_column, report_column, label_column))
    if step == "time_machine":
        # pair before sharding, so every part sees whole patients
        table = pair_time_machine_reports(table, id_column, report_column,
                                          timeline_column=timeline_column)
    table = table.take(range(part, len(table), parts))

    done = set()
    if os.path.exists(raw_path):
        with open(raw_path) as f:
            for line in f:
                try:
                    done.add(json.loads(line)["id"])
                except Exception:
                    pass

    todo = table.filter([not d for d in table[id_column].isin(done)])
    ids = todo[id_column].tolist()
    texts = todo[report_column].astype_str()
    for i in range(0, len(ids), batch):
        chunk_ids = ids[i: i + batch]
        prompts = [prefix + user.format(report=t)
                   for t in texts[i: i + batch]]
        answers = client.chat_batch(system, prompts)
        with open(raw_path, "a") as f:
            for cid, ans in zip(chunk_ids, answers):
                if ans is not None:
                    f.write(json.dumps({"id": cid, "answer": ans}) + "\n")


def _collect_answers(out_dir: str) -> Dict[str, str]:
    """The last answer of each id across every part (reference
    ``postprocess.py``)."""
    answers: Dict[str, str] = {}
    for name in sorted(os.listdir(out_dir)):
        if not name.startswith("raw_answers"):
            continue
        with open(os.path.join(out_dir, name)) as f:
            for line in f:
                try:
                    rec = json.loads(line)
                    answers[rec["id"]] = rec["answer"]
                except Exception:
                    continue
    return answers


def _write(rows: Sequence[Dict[str, object]], out_dir: str, name: str):
    Table.from_rows(rows).to_csv(os.path.join(out_dir, name))


def postprocess_answers(out_dir: str, step: str = "type_and_size",
                        organ: str = "liver") -> None:
    """Raw answers (all parts) → CSVs. `type_and_size` writes the per-tumor
    and per-CT training and evaluation CSVs; every other step one CSV."""
    answers = _collect_answers(out_dir)
    if step == "tumor_detection":
        _write([{"BDMAP_ID": cid, **parse_tumor_detection(ans)}
                for cid, ans in answers.items()],
               out_dir, "tumor_detection.csv")
        return
    if step == "malignancy":
        _write([{"BDMAP_ID": cid, **parse_malignancy(ans, organ)}
                for cid, ans in answers.items()],
               out_dir, f"malignancy_{organ}.csv")
        return
    if step == "malignant_size":
        _write([{"BDMAP_ID": cid, **parse_malignant_size(ans, organ)}
                for cid, ans in answers.items()],
               out_dir, f"malignant_size_{organ}.csv")
        return
    if step in ("type_and_size_organ", "type_and_size_pathology"):
        rows = []
        for cid, ans in answers.items():
            for i, t in enumerate(parse_single_organ_lesions(ans, organ)):
                rows.append({"BDMAP_ID": cid, "tumor": i + 1, **t})
        suffix = ("pathology_" if step == "type_and_size_pathology" else "")
        _write(rows, out_dir, f"type_and_size_{suffix}{organ}.csv")
        return
    if step == "hcc":
        rows = []
        for cid, ans in answers.items():
            for key, rec in P.parse_hcc(ans).items():
                rows.append({"BDMAP_ID": cid, "tumor": key, **rec})
        _write(rows, out_dir, "hcc_liver.csv")
        return
    if step == "diagnoses":
        _write([{"BDMAP_ID": cid,
                 "abnormalities": "; ".join(P.parse_diagnoses(ans) or [])}
                for cid, ans in answers.items()],
               out_dir, "diagnoses.csv")
        return
    if step == "synonyms":
        rows = []
        for cid, ans in answers.items():
            syn = P.parse_synonyms(ans) or {}
            for term, alts in syn.items():
                rows.append({"BDMAP_ID": cid, "term": term,
                             "synonyms": "; ".join(map(str, alts))})
        _write(rows, out_dir, "synonyms.csv")
        return
    if step == "longitudinal_pancreas":
        _write([{"BDMAP_ID": cid, **P.parse_longitudinal(ans)}
                for cid, ans in answers.items()],
               out_dir, "longitudinal_pancreas.csv")
        return
    if step == "longitudinal_pancreas_diagnosis":
        _write([{"BDMAP_ID": cid,
                 **(P.parse_longitudinal_diagnosis(ans)
                    or {"Tumor Types": None})}
                for cid, ans in answers.items()],
               out_dir, "longitudinal_pancreas_diagnosis.csv")
        return
    if step == "refine_normal_pancreas":
        _write([{"BDMAP_ID": cid, **P.parse_refine_normal_pancreas(ans)}
                for cid, ans in answers.items()],
               out_dir, "refine_normal_pancreas.csv")
        return
    if step == "matching_reports":
        _write([{"BDMAP_ID": cid, **P.parse_matching_reports(ans)}
                for cid, ans in answers.items()],
               out_dir, "matching_reports.csv")
        return
    if step == "time_machine":
        _write([{"BDMAP_ID": cid, **P.parse_time_machine(ans, organ)}
                for cid, ans in answers.items()],
               out_dir, f"time_machine_{organ}.csv")
        return
    parsed = {cid: parse_lesion_answer(ans) for cid, ans in answers.items()}
    per_tumor = build_per_tumor_csv(parsed)
    per_tumor.to_csv(os.path.join(out_dir, "per_tumor.csv"))
    build_per_ct_csv(per_tumor).to_csv(os.path.join(out_dir, "per_ct.csv"))


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--reports", required=True)
    p.add_argument("--out_dir", required=True)
    p.add_argument("--base_url", default="http://localhost:8000/v1")
    p.add_argument("--model", default="meta-llama/Llama-3.1-70B-Instruct-AWQ")
    p.add_argument("--report_column", default="Report Text")
    p.add_argument("--parts", type=int, default=1)
    p.add_argument("--part", type=int, default=0)
    p.add_argument("--step", default="type_and_size", choices=sorted(STEPS))
    p.add_argument("--organ", default="liver",
                   help="target organ for the malignancy step")
    p.add_argument("--timeline_column", default="pancreatic cancer timeline",
                   help="cohort timeline column for the time_machine step")
    p.add_argument("--examples", default="",
                   help="comma-separated ids of labeled reports to inject "
                        "as few-shot examples (reference "
                        "create_conversation examples loop)")
    p.add_argument("--label_column", default=None,
                   help="label column for --examples (default: the "
                        "detection-flag triple)")
    p.add_argument("--postprocess_only", action="store_true")
    args = p.parse_args(argv)
    if not args.postprocess_only:
        client = LLMClient(base_url=args.base_url, model=args.model)
        run_extraction(args.reports, args.out_dir, client,
                       report_column=args.report_column,
                       parts=args.parts, part=args.part,
                       step=args.step, organ=args.organ,
                       timeline_column=args.timeline_column,
                       examples=[e for e in args.examples.split(",") if e],
                       label_column=args.label_column)
    postprocess_answers(args.out_dir, step=args.step, organ=args.organ)


if __name__ == "__main__":
    main()
