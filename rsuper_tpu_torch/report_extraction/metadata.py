"""Metadata standardisation: raw parsed lesions → training and evaluation
CSVs (counterpart of ``rsuper_tpu/report_extraction/metadata.py``).

Equivalent of the reference's ``report_extraction/create_metadata.py``:
* organ-name standardisation (:760 ``standardize_organ`` over the
  ``organ_mapping`` synonym table :650-753);
* location mapping — liver segments incl. lobe/dome→segment-group rules
  (:892 ``map_liver_location``), pancreas head/body/tail with junction
  phrases (:966 ``map_pancreas_location``), bilateral left/right (:1036);
* lesion-type → (metastasis, malignancy) classification via per-organ
  vocabulary with a global fallback (:346 ``classify_two``; here the
  vocabularies are curated per organ for the R-Super training organs and a
  shared pool for the rest);
* the **per-tumor CSV** consumed by training (columns ``BDMAP_ID``,
  ``Standardized Organ``, ``Standardized Location``, ``Tumor Size (mm)``,
  ``Unknow Tumor Size``, ``no lesion``) and the **per-CT CSV** used as eval
  ground truth (``number of {organ} lesion instances``).

Location strings feed ``data/reports.segment_to_label`` → the ball/volume
losses' sub-segment targeting, so every phrase that silently falls to 'u'
WEAKENS supervision — the tables below cover the reference's phrase space.

The functions that build the CSVs return ``data/table.py`` tables;
``Table.to_csv`` writes the bytes pandas' ``to_csv(index=False)`` writes
for the same rows.
"""

from __future__ import annotations

import re
from typing import Dict, List, Optional, Sequence, Tuple

from ..data.table import Table, isna


def _word(text: str, term: str) -> bool:
    return bool(re.search(rf"\b{re.escape(term)}\b", text))


# --------------------------------------------------------------------------
# Organ standardisation (reference organ_mapping, create_metadata.py:650-753)
# --------------------------------------------------------------------------

ORGAN_SYNONYMS: Dict[str, List[str]] = {
    # canonical -> words/phrases (whole-word matched, longest checked first)
    "liver": ["liver", "hepatic", "hepatis", "hepatic lobe", "hepatic dome"],
    "pancreas": ["pancreas", "pancreatic", "uncinate", "uncinate process",
                 "pancreatic head", "pancreatic body", "pancreatic tail"],
    "kidney": ["kidney", "kidneys", "renal", "renal cortex", "renal pelvis"],
    "spleen": ["spleen", "splenic"],
    "adrenal_gland": ["adrenal", "adrenal gland", "adrenal glands"],
    "lung": ["lung", "lungs", "pulmonary"],
    "gallbladder": ["gallbladder", "gall bladder", "gallbladder fossa"],
    "bladder": ["bladder", "urinary bladder"],
    "breast": ["breast"],
    "bone": ["bone", "osseous", "vertebra", "vertebral body", "rib",
             "iliac bone", "iliac wing", "femur", "sternum", "spine"],
    "colon": ["colon", "colonic", "sigmoid", "sigmoid colon", "cecum",
              "rectosigmoid"],
    "stomach": ["stomach", "gastric"],
    "esophagus": ["esophagus", "esophageal"],
    "uterus": ["uterus", "uterine", "endometrium", "endometrial"],
    "ovary": ["ovary", "ovaries", "ovarian", "adnexa", "adnexal"],
    "prostate": ["prostate", "prostatic", "prostate gland"],
    "duodenum": ["duodenum", "duodenal"],
    "small intestine": ["small intestine", "small bowel", "jejunum", "ileum"],
    "lymph node": ["lymph node", "lymph nodes", "mesenteric lymph nodes",
                   "retroperitoneal lymph nodes"],
    "peritoneum": ["peritoneum", "peritoneal", "peritoneal cavity"],
    "mesentery": ["mesentery", "omentum", "omental"],
    "rectum": ["rectum", "rectal"],
    "bile_duct": ["bile duct", "common bile duct", "biliary"],
    "thyroid": ["thyroid", "thyroid gland"],
    "appendix": ["appendix", "appendiceal"],
    "ureter": ["ureter"],
    "seminal_vesicle": ["seminal vesicle", "seminal vesicles"],
    "soft_tissue": ["soft tissue", "soft tissues", "subcutaneous tissue",
                    "abdominal wall", "muscle", "psoas muscle"],
    "pelvis": ["pelvis", "pelvic sidewall", "pelvic wall"],
    "retroperitoneum": ["retroperitoneum", "retroperitoneal space"],
    "cervix": ["cervix", "cervical"],
    "vagina": ["vagina", "vaginal"],
    "pleura": ["pleura", "pleural"],
    "mediastinum": ["mediastinum", "mediastinal"],
    "diaphragm": ["diaphragm"],
    "aorta": ["aorta", "aortic"],
    "heart": ["heart", "cardiac"],
    "brain": ["brain"],
    "skin": ["skin"],
    "testicle": ["testicle", "testis", "testicular"],
}

_UNKNOWN_TOKENS = {"u", "", "no lesion", "nan", "none"}


def standardize_organ(raw: str) -> Optional[str]:
    """Free-text organ → canonical name, or None if unrecognised.

    Matching order mirrors the reference (:762-776): exact synonym equality
    first, then whole-word containment (longest synonyms first, so
    'gallbladder fossa' wins over 'gallbladder' → 'liver' never steals it).
    """
    if not isinstance(raw, str):
        return None
    low = raw.strip().lower()
    if low in _UNKNOWN_TOKENS:
        return None
    for organ, syns in ORGAN_SYNONYMS.items():
        if low in syns:
            return organ
    best: Tuple[int, Optional[str]] = (0, None)
    for organ, syns in ORGAN_SYNONYMS.items():
        for s in syns:
            if len(s) > best[0] and _word(low, s):
                best = (len(s), organ)
    return best[1]


# --------------------------------------------------------------------------
# Liver: free text -> Couinaud segment list (reference map_liver_location)
# --------------------------------------------------------------------------

_LIVER_SEGMENT_VARIATIONS: Dict[str, List[str]] = {
    "segment 1": ["segment 1", "seg 1", "segment i", "caudate lobe", "caudate",
                  "porta hepatis", "hilum"],
    "segment 2": ["segment 2", "seg 2", "segment ii"],
    "segment 3": ["segment 3", "seg 3", "segment iii"],
    "segment 4": ["segment 4", "seg 4", "segment iv", "segment 4a",
                  "segment 4b", "segment iv-a", "segment iva", "segment ivb",
                  "along the falciform ligament", "central", "medial segment",
                  "left medial segment"],
    "segment 5": ["segment 5", "seg 5", "segment v",
                  "adjacent to the gallbladder fossa"],
    "segment 6": ["segment 6", "seg 6", "segment vi"],
    "segment 7": ["segment 7", "seg 7", "segment vii",
                  "posterior right hepatic lobe", "right posterior lobe"],
    "segment 8": ["segment 8", "seg 8", "segment viii", "right hepatic dome",
                  "hepatic dome", "liver dome"],
}

# exact-phrase rules checked BEFORE the segment regex (reference :925-944):
# lobes and the dome map to canonical segment GROUPS
_LIVER_PHRASE_GROUPS: Dict[str, List[str]] = {
    "segment 5 / segment 6 / segment 7 / segment 8": [
        "right lobe", "right hepatic lobe", "right dome", "right hepatic",
        "inferior right hepatic lobe",
    ],
    "segment 2 / segment 3 / segment 4": [
        "left lobe", "left hepatic lobe", "left lateral segment",
        "lateral segment of the left lobe", "lateral segment",
        "left medial segment",
    ],
    "segment 1": ["caudate lobe", "segment 1"],
    "segment 7 / segment 8": [
        "dome", "hepatic dome", "liver dome", "right liver dome",
        "dome of the right lobe", "near the dome", "hepatic dome segment",
    ],
    "u": ["u", "segment u"],
}


def _match_variation_set(low: str, variations: Dict[str, List[str]]) -> List[str]:
    """All canonical keys whose variation phrases appear in `low`, with longer
    phrases shadowing their substrings (so 'right posterior lobe' does not
    also fire bare 'lobe' rules elsewhere)."""
    hits = set()
    for key, phrases in variations.items():
        for p in phrases:
            if _word(low, p):
                hits.add(key)
                break
    return sorted(hits)


def map_liver_location(raw: str) -> str:
    """'right hepatic lobe' → 'segment 5 / segment 6 / segment 7 / segment 8';
    'segment ii and segment 3' → 'segment 2 / segment 3'; unknown → 'u'.
    (reference ``map_liver_location``, create_metadata.py:892-960)."""
    if not isinstance(raw, str):
        return "u"
    low = raw.strip().lower()
    if low in _UNKNOWN_TOKENS:
        return "u"
    for group, phrases in _LIVER_PHRASE_GROUPS.items():
        if low in phrases:
            return group
    segs = _match_variation_set(low, _LIVER_SEGMENT_VARIATIONS)
    if segs:
        return " / ".join(segs)
    return "u"


# --------------------------------------------------------------------------
# Pancreas: free text -> head/body/tail (reference map_pancreas_location)
# --------------------------------------------------------------------------

_PANCREAS_REGION_VARIATIONS: Dict[str, List[str]] = {
    "head": ["head", "uncinate", "uncinate process", "neck",
             "proximal pancreatic head", "inferior head", "posterior head",
             "anterior head", "neck of pancreas", "pancreatic neck",
             "near the pancreatic head", "adjacent to the pancreatic head"],
    "body": ["body", "mid body", "proximal body", "distal body",
             "posterior body", "anterior body", "proximal pancreatic body",
             "posterior aspect of the pancreatic body",
             "anterior to the pancreatic body", "near the pancreatic body"],
    "tail": ["tail", "distal tail", "pancreatic tail", "near the tail",
             "adjacent to the pancreatic tail",
             "inferior to the pancreatic tail", "posterior to the tail",
             "anterior to the pancreatic tail"],
}

# exact combination phrases first (reference :1005-1016)
_PANCREAS_PHRASE_COMBOS: Dict[str, List[str]] = {
    "head": ["head/neck", "head and neck", "head/uncinate process",
             "head and uncinate process",
             "junction of the pancreatic head and uncinate process"],
    "head / body": ["head/body", "head and body", "junction of head and body",
                    "neck/body", "head/body junction", "neck/proximal body",
                    "junction of the pancreatic neck and body"],
    "head / tail": ["head/tail", "tail and head", "head and tail",
                    "tail and uncinate process"],
    "body / tail": ["body/tail", "body and tail", "distal body and tail",
                    "body-tail junction", "junction of body and tail",
                    "tail and distal body"],
    "body / head / tail": ["all regions", "entire pancreas", "head/body/tail"],
}


def map_pancreas_location(raw: str) -> str:
    """'uncinate process' → 'head'; 'body and tail' → 'body / tail'
    (reference ``map_pancreas_location``, create_metadata.py:966-1032)."""
    if not isinstance(raw, str):
        return "u"
    low = raw.strip().lower()
    if low in _UNKNOWN_TOKENS:
        return "u"
    for combo, phrases in _PANCREAS_PHRASE_COMBOS.items():
        if low in phrases:
            return combo
    regions = _match_variation_set(low, _PANCREAS_REGION_VARIATIONS)
    if regions:
        return " / ".join(regions)
    return "u"


def map_bilateral_location(raw: str) -> str:
    """left/right organs (kidney, adrenal, lung, breast...) — reference
    ``map_bilateral_location`` (create_metadata.py:1036-1050): 'left' wins
    when both appear (a single tumor is never truly bilateral)."""
    if not isinstance(raw, str):
        return "u"
    low = raw.lower()
    if "left" in low:
        return "left"
    if "right" in low:
        return "right"
    return "u"


def standardize_location(raw: str, organ: Optional[str]) -> str:
    """Dispatch to the organ-appropriate mapper (reference applies
    map_liver/map_pancreas/map_bilateral by organ column)."""
    if organ == "liver":
        return map_liver_location(raw)
    if organ == "pancreas":
        return map_pancreas_location(raw)
    if organ in ("kidney", "adrenal_gland", "lung", "breast", "ovary",
                 "femur", "adnexa"):
        return map_bilateral_location(raw)
    return "u"


# --------------------------------------------------------------------------
# Lesion-type classification (reference classify_two, create_metadata.py:346)
# --------------------------------------------------------------------------

CYST_TERMS = ["cyst", "cysts", "ipmn", "pseudocyst", "cystic", "cystic lesion",
              "nabothian cyst", "lymphoepithelial cyst", "utricle cyst"]

# per-organ (metastasis, malignancy) vocabularies; term sets are curated from
# the reference's `grouped` tables for the R-Super organs plus a shared pool.
_MALIGNANT_BY_ORGAN: Dict[str, List[str]] = {
    "liver": ["hepatocellular carcinoma", "hcc", "cholangiocarcinoma",
              "malignant", "carcinoma", "neoplasm", "malignancy", "tumor"],
    "pancreas": ["adenocarcinoma", "pdac", "pancreatic cancer",
                 "neuroendocrine tumor", "pnet", "malignant", "carcinoma",
                 "neoplasm", "tumor", "mass"],
    "kidney": ["renal cell carcinoma", "rcc", "urothelial carcinoma",
               "malignant", "carcinoma", "neoplasm", "tumor", "lymphoma"],
    "spleen": ["lymphoma", "lymphomatous involvement", "malignant", "tumor",
               "hematologic malignancy"],
    "uterus": ["endometrial carcinoma", "endometrial cancer",
               "leiomyosarcoma", "malignant", "carcinoma", "tumor"],
    "prostate": ["prostate cancer", "carcinoma", "malignant", "malignancy",
                 "tumor", "mass"],
    "bladder": ["urothelial carcinoma", "adenocarcinoma", "carcinoma",
                "neoplasm", "malignant", "tumor", "lymphoma"],
    "duodenum": ["adenocarcinoma", "neuroendocrine tumor", "gist", "lymphoma",
                 "malignant", "tumor", "mass"],
}
_BENIGN_BY_ORGAN: Dict[str, List[str]] = {
    "liver": ["hemangioma", "fnh", "focal nodular hyperplasia", "adenoma",
              "benign", "granuloma", "hamartoma", "abscess", "hematoma",
              "calcification", "steatosis", "fat deposition"],
    "pancreas": ["serous cystadenoma", "benign", "lipoma", "abscess",
                 "pancreatitis", "fat infiltration", "calcification"],
    "kidney": ["angiomyolipoma", "aml", "oncocytoma", "benign", "abscess",
               "hematoma", "scarring", "calculus", "stone", "calcification",
               "infarct"],
    "spleen": ["hemangioma", "granuloma", "lymphangioma", "hamartoma",
               "infarct", "infarction", "laceration", "hematoma", "abscess",
               "benign", "calcification", "splenic cleft"],
    "uterus": ["fibroid", "fibroids", "leiomyoma", "leiomyomata", "polyp",
               "adenomyosis", "myoma", "benign", "hematoma"],
    "prostate": ["benign prostatic hyperplasia", "bph", "hyperplasia",
                 "prostatomegaly", "enlargement", "hypertrophy", "adenoma",
                 "prostatitis", "benign", "abscess", "calcification"],
    "bladder": ["polyp", "diverticulum", "stone", "calculus", "cystitis",
                "hematoma", "benign", "ureterocele"],
    "duodenum": ["diverticulum", "lipoma", "polyp", "adenoma",
                 "tubular adenoma", "benign", "abscess", "lymphangioma"],
}
# global fallback pools (union semantics, reference :361-366)
_MALIGNANT_GLOBAL = sorted(
    {t for v in _MALIGNANT_BY_ORGAN.values() for t in v}
    | {"metastasis", "metastases", "sarcoma", "melanoma"}
)
_BENIGN_GLOBAL = sorted(
    {t for v in _BENIGN_BY_ORGAN.values() for t in v}
    | {"lipoma", "cyst", "scar", "fibrosis"}
)


def classify_two(organ_raw, lesion_type) -> Tuple[str, str]:
    """(metastasis, malignancy), each in {'yes','no','u'} — reference
    ``classify_two`` (create_metadata.py:346-410): metastasis checked first
    and implies malignant; organ-specific vocabulary, then global fallback."""
    if lesion_type is None or (isinstance(lesion_type, float) and isna(lesion_type)):
        return "u", "u"
    t = str(lesion_type).strip().lower()
    if t in _UNKNOWN_TOKENS:
        return "u", "u"
    if "metasta" in t:
        return "yes", "yes"

    organ = str(organ_raw).strip().lower() if isinstance(organ_raw, str) else ""

    def against(mal, ben) -> str:
        if any(_word(t, m) or t == m for m in mal):
            return "yes"
        if any(_word(t, b) or t == b for b in ben):
            return "no"
        return "u"

    local = "u"
    if organ in _MALIGNANT_BY_ORGAN:
        local = against(_MALIGNANT_BY_ORGAN[organ], _BENIGN_BY_ORGAN[organ])
    if organ not in _MALIGNANT_BY_ORGAN or local == "u":
        g = against(_MALIGNANT_GLOBAL, _BENIGN_GLOBAL)
        return ("u" if g == "u" else "no"), g
    return ("u" if local == "u" else "no"), local


def classify_lesion(lesion_type: str, organ: Optional[str] = None) -> str:
    """'cyst' / 'benign' / 'lesion' — the training-side split (cysts are
    excluded from lesion-instance counts; everything non-cyst supervises)."""
    if not isinstance(lesion_type, str):
        return "lesion"
    low = lesion_type.lower()
    if any(_word(low, t) or low == t for t in CYST_TERMS):
        return "cyst"
    _, malignancy = classify_two(organ or "", lesion_type)
    if malignancy == "no":
        return "benign"
    return "lesion"


# --------------------------------------------------------------------------
# The CSVs
# --------------------------------------------------------------------------

def build_per_tumor_csv(parsed: Dict[str, List[Dict[str, str]]]) -> Table:
    """{case_id: [lesion dicts from parse_lesion_answer]} → per-tumor rows
    (the last row of a repeated (case, tumour) pair kept)."""
    rows = []
    for case_id, lesions in parsed.items():
        if not lesions:
            continue
        if lesions[0].get("no_lesion") == "1":
            rows.append({
                "BDMAP_ID": case_id, "Tumor ID": 0,
                "Standardized Organ": "", "Standardized Location": "",
                "Tumor Size (mm)": "", "Unknow Tumor Size": "",
                "Lesion Class": "", "Metastasis": "", "Malignant": "",
                "no lesion": 1,
            })
            continue
        for i, les in enumerate(lesions, 1):
            organ = standardize_organ(les.get("organ", ""))
            loc = standardize_location(les.get("location", ""), organ)
            size = les.get("size", "u")
            unknown = "yes" if size in ("u", "multiple", "tiny") else "no"
            met, mal = classify_two(organ, les.get("type", ""))
            rows.append({
                "BDMAP_ID": case_id, "Tumor ID": i,
                "Standardized Organ": organ or "u",
                "Standardized Location": loc,
                "Tumor Size (mm)": size,
                "Unknow Tumor Size": unknown,
                "Lesion Class": classify_lesion(les.get("type", ""), organ),
                "Metastasis": met, "Malignant": mal,
                "no lesion": 0,
            })
    table = Table.from_rows(rows)
    if len(table):
        table = table.drop_duplicates(["BDMAP_ID", "Tumor ID"], keep="last")
    return table


def build_per_ct_csv(
    per_tumor: Table,
    organs: Sequence[str] = ("liver", "pancreatic", "kidney"),
) -> Table:
    """Per-CT lesion-instance counts — the eval ground-truth table
    (reference ``create_metadata.py`` header :80); one row a case in sorted
    order, as pandas' ``groupby`` gives them."""
    organ_key = {"pancreatic": "pancreas", "liver": "liver", "kidney": "kidney"}
    groups: Dict[object, List[Dict[str, object]]] = {}
    for case_id, r in zip(per_tumor["BDMAP_ID"], per_tumor.rows()):
        if not isna(case_id):
            groups.setdefault(case_id, []).append(r)
    rows = []
    for case_id in sorted(groups):
        grp = groups[case_id]
        row = {"BDMAP_ID": case_id}
        healthy = all(r["no lesion"] == 1 for r in grp)
        for org in organs:
            src = organ_key.get(org, org)
            if healthy:
                row[f"number of {org} lesion instances"] = 0
                continue
            sel = [r for r in grp if r["Standardized Organ"] == src
                   and r["Lesion Class"] != "cyst"]
            row[f"number of {org} lesion instances"] = int(len(sel))
        rows.append(row)
    return Table.from_rows(rows)
