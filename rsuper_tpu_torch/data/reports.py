"""Radiology-report supervision records (the port's own copy of
``rsuper_tpu/data/reports.py``, on ``data/table.Table`` instead of pandas).

Turns the per-tumour metadata CSV of the report-extraction pipeline (columns
``BDMAP_ID``, ``Standardized Organ``, ``Standardized Location``, ``Tumor Size
(mm)`` ("a x b x c" or one diameter), ``Unknow Tumor Size``, ``no lesion``)
into per-case supervision: which organ sub-segments hold tumours of known
size, the reported volumes and diameters, and the unknown-channel specs.
"""

from __future__ import annotations

import math
import re
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from .table import Column, Table, isna

MAX_TUMORS = 10
LATERAL_ORGANS = {"kidney", "adrenal_gland", "lung", "breast", "femur"}

PANCREAS_SEGMENTS = ["head", "body", "tail"]
LIVER_SEGMENTS = [f"segment {i}" for i in range(1, 9)]
KIDNEY_SEGMENTS = ["left", "right"]

_HEALTHY_TEXT = {"1", "1.0", "true", "t", "yes", "y"}
_HALLUCINATION = re.compile(r"^0\.0\s*x")
_DIGIT = re.compile(r"\d")


def is_healthy(col: Column) -> List[bool]:
    """True where the 'no lesion' flag marks a healthy case: a bool column
    as it is; else a cell equal to 1 as a number, or one of the texts
    1/true/t/yes/y."""
    if col.kind == "bool":
        return list(col.values)
    out = []
    for v, x in zip(col.values, col.to_numeric()):
        if not math.isnan(x):
            out.append(x == 1)
        else:
            out.append(str(v).strip().lower() in _HEALTHY_TEXT)
    return out


def load_reports(path: str) -> Table:
    t = Table.read_csv(path)
    if "BDMAP ID" in t:
        t = t.rename({"BDMAP ID": "BDMAP_ID"})
    return t


def _ids_where(t: Table, mask: Sequence[bool]) -> set:
    return {i for i, m in zip(t["BDMAP_ID"].values, mask) if m}


def _not(mask):
    return [not m for m in mask]


def _and(*masks):
    return [all(ms) for ms in zip(*masks)]


def _or(*masks):
    return [any(ms) for ms in zip(*masks)]


def clean_reports(
    reports: Table,
    annotated_tumors: Sequence[str],
    limit_healthy: bool = True,
    seed: int = 42,
) -> Tuple[Table, List[str], Dict[str, List[str]]]:
    """Filter usable report cases:

    * drop LLM hallucinations ("0.0 x ..." sizes);
    * keep tumours only in `annotated_tumors` organs (or healthy cases);
    * drop cases with any non-numeric / unknown tumour size;
    * for paired organs, require left/right laterality;
    * optionally cap healthy cases at the largest per-organ tumour count.

    Returns (filtered rows, usable case ids, per-organ id lists).
    """
    size_str = reports["Tumor Size (mm)"].astype_str()
    halluc = _ids_where(reports, [bool(_HALLUCINATION.search(s))
                                  or s in ("0.0", "0") for s in size_str])
    reports = reports.filter(_not(reports["BDMAP_ID"].isin(halluc)))

    healthy = is_healthy(reports["no lesion"])
    reports = reports.filter(_or(
        reports["Standardized Organ"].isin(annotated_tumors), healthy))
    healthy = is_healthy(reports["no lesion"])

    tumor_rows = _not(healthy)
    size_str = reports["Tumor Size (mm)"].astype_str()
    has_digit = [bool(_DIGIT.search(s)) for s in size_str]
    unk = [s.strip().lower() != "no"
           for s in reports["Unknow Tumor Size"].astype_str()]
    bad_ids = _ids_where(reports, _and(tumor_rows, _or(_not(has_digit), unk)))

    need_lr = _and(tumor_rows,
                   reports["Standardized Organ"].isin(LATERAL_ORGANS))
    loc = [s.lower() for s in reports["Standardized Location"].astype_str()]
    has_lr = ["left" in s or "right" in s for s in loc]
    bad_ids |= _ids_where(reports, _and(need_lr, _not(has_lr)))
    reports = reports.filter(_not(reports["BDMAP_ID"].isin(bad_ids)))

    healthy = is_healthy(reports["no lesion"])
    per_organ: Dict[str, List[str]] = {}
    keep_ids: set = set()
    organ_col = reports["Standardized Organ"].values
    sizes = reports["Tumor Size (mm)"].astype_str()
    unknown = [s.lower() for s in reports["Unknow Tumor Size"].astype_str()]
    locs = [s.lower() for s in reports["Standardized Location"].astype_str()]
    ids_col = reports["BDMAP_ID"].values
    for organ in annotated_tumors:
        sel = [o == organ and s not in ("u", "U", "multiple") and u == "no"
               for o, s, u in zip(organ_col, sizes, unknown)]
        if organ in LATERAL_ORGANS:
            sel = _and(sel, ["left" in s or "right" in s for s in locs])
        ids = Column([i for i, m in zip(ids_col, sel) if m], "object")
        per_organ[organ] = sorted(ids.unique())
        keep_ids.update(ids.values)

    healthy_df = reports.filter(healthy)
    if limit_healthy and per_organ:
        cap = max((len(v) for v in per_organ.values()), default=0)
        h_ids = sorted(healthy_df["BDMAP_ID"].unique())
        if len(h_ids) > cap and cap > 0:
            rng = np.random.default_rng(seed)
            h_ids = sorted(rng.choice(h_ids, size=cap, replace=False))
        healthy_df = healthy_df.filter(healthy_df["BDMAP_ID"].isin(h_ids))
    per_organ["healthy"] = sorted(healthy_df["BDMAP_ID"].unique())

    ids = sorted(keep_ids | set(healthy_df["BDMAP_ID"].values))
    return reports.filter(reports["BDMAP_ID"].isin(ids)), ids, per_organ


def _split_location(loc) -> Optional[List[str]]:
    if not isinstance(loc, str) or loc.lower() == "u" or loc == "":
        return None
    return loc.split(" / ")


def segment_to_label(seg: str) -> str:
    """Report sub-segment term → label-map class name."""
    return (
        seg.replace("segment ", "liver_segment_")
        .replace("head", "pancreas_head")
        .replace("body", "pancreas_body")
        .replace("tail", "pancreas_tail")
        .replace("left", "kidney_left")
        .replace("right", "kidney_right")
    )


def expand_segment_group(group: Sequence[str]) -> List[str]:
    """Whole-organ terms expand to all their sub-segments."""
    if list(group) == ["pancreas"]:
        return PANCREAS_SEGMENTS[:]
    if list(group) == ["liver"]:
        return LIVER_SEGMENTS[:]
    if list(group) == ["kidney"]:
        return KIDNEY_SEGMENTS[:]
    return list(group)


def lesion_class_for_segments(segments: Sequence[str], class_name: str) -> bool:
    """Does lesion channel `class_name` correspond to a crop on `segments`?"""
    joined = " ".join(segments)
    if ("segment" in joined or "liver" in joined) and "liver_lesion" in class_name:
        return True
    if (
        any(t in joined for t in ("head", "body", "tail", "pancreas"))
        and "pancreatic_lesion" in class_name
    ):
        return True
    if (
        any(t in joined for t in ("left", "right", "kidney"))
        and "kidney_lesion" in class_name
    ):
        return True
    return False


def case_supervision(case_rows: Optional[Table]) -> Dict:
    """Per-case tumour-location analysis.

    Returns a dict with:
      * ``segment_groups``: segment-term groups (tumours spanning several
        sub-segments stay grouped) whose tumours all have known sizes;
      * ``organs_known``: organs where every tumour has known size + location;
      * ``tumor_organs`` / ``tumor_segments_flat``: everything mentioned;
      * ``has_tumor``: bool.
    """
    if (case_rows is None or len(case_rows) == 0
            or all(is_healthy(case_rows["no lesion"]))):
        return {
            "segment_groups": [],
            "organs_known": [],
            "tumor_organs": [],
            "tumor_segments_flat": [],
            "has_tumor": False,
        }

    locs = case_rows["Standardized Location"].tolist()
    sizes = case_rows["Tumor Size (mm)"].tolist()
    organs = case_rows["Standardized Organ"].tolist()

    organs_unk_seg, organs_unk_size, segs_unk_size = set(), set(), set()
    for loc, size, organ in zip(locs, sizes, organs):
        size_unknown = isna(size) or str(size).lower() in ("u", "multiple")
        group = _split_location(loc)
        if size_unknown:
            if isinstance(organ, str):
                organs_unk_size.add(organ)
            if group:
                segs_unk_size.update(group)
        if group is None:
            if isinstance(organ, str):
                organs_unk_seg.add(organ)

    # segments inside organs that have any unknown tumour
    segs_in_unk_organs = set()
    for loc, organ in zip(locs, organs):
        group = _split_location(loc)
        if group and organ in (organs_unk_seg | organs_unk_size):
            segs_in_unk_organs.update(group)

    groups = []
    for loc in locs:
        g = _split_location(loc)
        if g and g not in groups:
            groups.append(g)
    flat = sorted({s for g in groups for s in g})

    tumor_organs = sorted(
        {o for o in organs if isinstance(o, str) and o.lower() != "u"}
    )
    organs_known = sorted(
        set(tumor_organs) - organs_unk_seg - organs_unk_size
    )

    # keep only fully-known segment groups (merging groups sharing a segment)
    known_groups = []
    banned = segs_unk_size | segs_in_unk_organs
    for seg in sorted(set(flat) - banned):
        related = sorted({s for g in groups if seg in g for s in g})
        if any(s in banned for s in related):
            continue
        if related not in known_groups:
            known_groups.append(related)

    return {
        "segment_groups": known_groups,
        "organs_known": organs_known,
        "tumor_organs": tumor_organs,
        "tumor_segments_flat": flat,
        "has_tumor": True,
    }


def parse_size_mm(size) -> Optional[Tuple[float, List[float]]]:
    """'d' or 'a x b x c' (mm) → (volume mm³, [d1, d2, d3]).

    A sphere for one diameter, an ellipsoid for more; a missing third axis is
    the mean of the other two.
    """
    s = str(size)
    if "x" not in s:
        try:
            d = float(s)
        except ValueError:
            return None
        return (4.0 / 3.0) * math.pi * (d / 2.0) ** 3, [d, d, d]
    parts = [p.strip() for p in s.split("x")]
    try:
        dims = [float(p) for p in parts]
    except ValueError:
        return None
    if len(dims) == 2:
        dims.append(sum(dims) / 2.0)
    dims = dims[:3]
    vol = (4.0 / 3.0) * math.pi * (dims[0] / 2) * (dims[1] / 2) * (dims[2] / 2)
    return vol, dims


def estimate_tumor_volumes(
    case_rows: Optional[Table], crop_segments: Optional[Sequence[str]]
) -> Tuple[np.ndarray, np.ndarray]:
    """Volumes (T,) and diameters (T, 3) of the report tumours fully inside
    the cropped segment group; zero-padded to MAX_TUMORS.

    `crop_segments`: the segment-term group the crop targeted (or organ
    names), or None/'random' → all zeros.
    """
    vols = np.zeros((MAX_TUMORS,), np.float32)
    dias = np.zeros((MAX_TUMORS, 3), np.float32)
    if crop_segments is None or crop_segments == "random" or case_rows is None:
        return vols, dias
    if isinstance(crop_segments, str):
        crop_segments = [crop_segments]
    joined = "".join(crop_segments)
    if any(o in joined for o in ("liver", "kidney", "pancreas")):
        col = "Standardized Organ"
    else:
        col = "Standardized Location"

    i = 0
    for row in case_rows.rows():
        group = _split_location(row[col])
        if group is None:
            continue
        if not all(g in crop_segments for g in group):
            continue
        parsed = parse_size_mm(row["Tumor Size (mm)"])
        if parsed is None:
            continue
        if i >= MAX_TUMORS:
            break
        vols[i], dias[i] = parsed[0], parsed[1]
        i += 1
    return vols, dias
