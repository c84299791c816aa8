"""Parse structured LLM lesion answers (counterpart of
``rsuper_tpu/report_extraction/parse.py``).

Consumes the line contract of ``prompts.LESION_EXTRACTION_SYSTEM`` —
identical to what the reference's ``interpret_output(step='type and size
multi-organ')`` parses (``report_extraction/RadGPT.py:1509-1560``) — into a
list of lesion dicts. Chain-of-thought before a closing ``</think>`` tag is
stripped first.
"""

from __future__ import annotations

import re
from typing import Dict, List

_LESION_RE = re.compile(
    r"lesion\s*\d+\s*:\s*type\s*=\s*(?P<type>.+?);\s*certainty\s*=\s*"
    r"(?P<certainty>.+?);\s*size\s*=\s*(?P<size>.+?);\s*organ\s*=\s*"
    r"(?P<organ>.+?);\s*location\s*=\s*(?P<location>.+?);\s*attenuation\s*=\s*"
    r"(?P<attenuation>.+?);"
)
_NUM_RE = re.compile(r"\d+\.\d+|\d+")
_UNIT_RE = re.compile(r"(.*?)(cm|mm)")
# the reference's size sentinels (RadGPT.py:1534-1542)
_UNKNOWN_SIZES = ("u", "unk", "unkn", "unknown", "n/a", "na", "not available")


def _normalize_size(raw: str) -> str:
    """'2.3 x 1.8 cm' → '23 x 18' (mm); '1.2 cm x 8 mm' → '12 x 8';
    'multiple'/'tiny'/'massive' sentinels pass through; unknown spellings → 'u'
    (mirrors ``get_value(step='all sizes')``, RadGPT.py:1319-1341, including
    per-segment cm→mm conversion for mixed-unit answers)."""
    raw = raw.strip().lower()
    if "multiple" in raw:
        return "multiple"
    if "tiny" in raw:
        return "tiny"
    if "massive" in raw:
        return "massive"
    if raw in _UNKNOWN_SIZES:
        return "u"
    nums = []
    segments = _UNIT_RE.findall(raw)
    if segments:
        for text, unit in segments:
            for n in _NUM_RE.findall(text):
                nums.append(float(n) * (10.0 if unit == "cm" else 1.0))
    else:  # unitless answer: take the numbers as millimetres
        nums = [float(n) for n in _NUM_RE.findall(raw)]
    if not nums:
        return "u"
    return " x ".join(f"{n:g}" for n in nums) if len(nums) > 1 else f"{nums[0]:g}"


def _strip_think(answer: str) -> str:
    return answer.split("</think>")[-1] if "</think>" in answer else answer


def _yes_no_u(pattern: str, text: str):
    """1/0/None from a 'X = yes/no/u'-style answer (reference ``get_value``
    non-size mode, RadGPT.py:1355-1360)."""
    m = re.findall(pattern, text.lower())
    if not m:
        return None
    if "yes" in m[0]:
        return 1
    if "no" in m[0]:
        return 0
    return None


def parse_tumor_detection(answer: str) -> Dict[str, object]:
    """The reference's 'tumor detection' step: per-organ presence flags
    (``interpret_output``, RadGPT.py:1452-1459)."""
    text = _strip_think(answer)
    out = {}
    for organ, key in (("liver", "Liver Tumor"), ("kidney", "Kidney Tumor"),
                       ("pancreas", "Pancreas Tumor")):
        pat = rf"{organ} tumor presence\s*[=:]\s*.*?(?:;|$|,|/|yes|no|u)"
        out[key] = _yes_no_u(pat, text)
    return out


def parse_malignancy(answer: str, organ: str = "liver") -> Dict[str, object]:
    """The reference's 'malignancy detection' step (RadGPT.py:1472-1474)."""
    text = _strip_think(answer)
    pat = rf"malignant tumor in {organ}\s*[=:]\s*.*?(?:;|$|,|/|yes|no|u)"
    return {f"Malignant Tumor in {organ}": _yes_no_u(pat, text)}


_MEASUREMENT_ONLY_RE = re.compile(r"^[\s\d.,x×*-]+$")
_UNITLESS_MAX_MM = 500.0  # plausibility bound for a bare-number tumor size


def _max_size_mm(raw: str):
    """Largest measurement in a size string, in mm (reference ``get_value``
    step='malignant size', RadGPT.py:1319-1346: per-segment cm→mm conversion,
    max over all numbers); None when no number parses.

    The unitless fallback (the size prompts establish 'no unit means mm')
    only fires when the segment is PURE measurement syntax and the values are
    plausible tumor sizes — so free-text answers that merely contain a number
    ('unchanged from the 2020 exam', '2 subcentimeter lesions') parse to
    None instead of poisoning the CSV with a bogus millimetre value."""
    sizes = []
    low = raw.lower()
    for text, unit in _UNIT_RE.findall(low):
        for n in _NUM_RE.findall(text):
            sizes.append(float(n) * (10.0 if unit == "cm" else 1.0))
    if not sizes and _MEASUREMENT_ONLY_RE.match(low.strip() or " "):
        sizes = [float(n) for n in _NUM_RE.findall(low)]
        if any(s > _UNITLESS_MAX_MM for s in sizes):
            sizes = []
    return max(sizes) if sizes else None


def parse_single_organ_lesions(answer: str, organ: str) -> List[Dict[str, str]]:
    """The reference's 'type and size' single-organ step
    (``interpret_output``, RadGPT.py:1485-1498): per-tumor type / certainty /
    size / location lines for one named organ. Sizes normalise like the
    multi-organ step ('multiple' passes through, max measurement in mm)."""
    text = _strip_think(answer).lower()
    pat = re.compile(
        rf"{re.escape(organ.lower())} tumor \d+\s*:\s*type\s*=\s*(?P<type>.+?);"
        r"\s*certainty\s*=\s*(?P<certainty>.+?);\s*size\s*=\s*(?P<size>.+?);"
        r"\s*location\s*=\s*(?P<location>.+?);"
    )
    out = []
    for m in pat.finditer(text):
        raw = m.group("size").strip()
        if "multiple" in raw:
            size = "multiple"
        else:
            mm = _max_size_mm(raw)
            size = "u" if mm is None else f"{mm:g}"
        out.append({
            "type": m.group("type").strip(),
            "certainty": m.group("certainty").strip(),
            "size": size,
            "location": m.group("location").strip(),
            "organ": organ.lower(),
        })
    return out


def parse_malignant_size(answer: str, organ: str) -> Dict[str, object]:
    """The reference's 'malignant size' step (RadGPT.py:1475-1479): the
    LARGEST malignant-tumor size in the organ, in mm (None if unparseable)."""
    text = _strip_think(answer).lower()
    pat = rf"{re.escape(organ.lower())} malignant tumor size\s*[=:]\s*(.*?)(?:[;\n]|$)"
    sizes = [
        mm for raw in re.findall(pat, text)
        if (mm := _max_size_mm(raw)) is not None
    ]
    return {f"Malignant Tumor in {organ}": max(sizes) if sizes else None}


def parse_time_machine(answer: str, organ: str) -> Dict[str, object]:
    """The reference's 'time machine' step (RadGPT.py:1480-1484): hindsight
    malignancy verdict on the earlier report (1/0/None like the malignancy
    step) + the largest size Report 1 gives for that lesion, in mm."""
    text = _strip_think(answer)
    verdict_pat = (rf"very likely malignancy in {re.escape(organ.lower())} "
                   rf"in the first exam\s*[=:]\s*.*?(?:;|$|,|/|yes|no|u)")
    size = parse_malignant_size(answer, organ)[f"Malignant Tumor in {organ}"]
    return {
        f"Very Likely Malignancy in {organ}": _yes_no_u(verdict_pat, text),
        f"Very Likely Malignant Tumor Size in {organ}": size,
    }


def parse_lesion_answer(answer: str) -> List[Dict[str, str]]:
    """LLM answer → list of lesion dicts; [] plus the no-lesion sentinel for
    healthy reports."""
    if "</think>" in answer:
        answer = answer.split("</think>")[-1]
    low = answer.lower()
    if "no lesions mentioned" in low and "lesion 1:" not in low:
        return [{
            "type": "no lesion", "certainty": "no lesion", "size": "no lesion",
            "organ": "no lesion", "location": "no lesion",
            "attenuation": "no lesion", "no_lesion": "1",
        }]
    out = []
    for m in _LESION_RE.finditer(low):
        out.append({
            "type": m.group("type").strip(),
            "certainty": m.group("certainty").strip(),
            "size": _normalize_size(m.group("size")),
            "organ": m.group("organ").strip(),
            "location": m.group("location").strip(),
            "attenuation": m.group("attenuation").strip(),
            "no_lesion": "0",
        })
    return out


def parse_hcc(answer: str, organ: str = "liver") -> Dict[str, Dict[str, str]]:
    """The reference's 'HCC' step (``extract_liver_tumors``,
    RadGPT.py:1363-1446): per-tumor LI-RADS fields. Tolerant variant: missing
    fields become 'u' instead of raising (the reference retries the LLM on a
    ValueError; a resumable pipeline prefers degraded rows)."""
    text = _strip_think(answer)
    chunks = re.split(rf"(?i)(?=(?:{re.escape(organ)}\s+tumor\s+\d+:))", text)
    out: Dict[str, Dict[str, str]] = {}
    fields = ("type", "certainty", "size", "location",
              "arterial enhancement", "washout", "capsule",
              "threshold growth", "LI-RADS")
    for chunk in chunks:
        m = re.match(rf"(?i){re.escape(organ)}\s+tumor\s+(\d+):", chunk.strip())
        if not m:
            continue
        rec = {}
        for f in fields:
            fm = re.search(rf"{re.escape(f)}\s*=\s*([^;\n]+)[;\n]", chunk,
                           re.IGNORECASE)
            rec[f] = fm.group(1).strip() if fm else "u"
        if "multiple" in rec["size"].lower():
            rec["size"] = "multiple"
        else:
            mm = _max_size_mm(rec["size"])
            rec["size"] = "u" if mm is None else f"{mm:g}"
        out[f"{organ} tumor {m.group(1)}"] = rec
    return out


def parse_diagnoses(answer: str):
    """The reference's 'diagnoses' step (RadGPT.py:1562-1578): the bracketed
    abnormality list after 'abnormalities ='. Returns a list of strings (the
    reference returns the raw bracketed string)."""
    text = _strip_think(answer)
    for marker in ("abnormalities =", "abnormalities="):
        if marker in text:
            start = text.rfind(marker) + len(marker)
            break
    else:
        start = text.find("[")
        if start < 0:
            return None
    end = text.rfind("]", start) + 1
    raw = text[start:end].strip()
    if not raw.startswith("["):
        b = raw.find("[")
        if b < 0:
            return None
        raw = raw[b:]
    items = re.findall(r"['\"]([^'\"]+)['\"]", raw)
    return [i.strip() for i in items]


def parse_synonyms(answer: str):
    """The reference's 'synonyms' step (RadGPT.py:1580-1592): the {...} dict
    string after 'synonyms ='. Returns {term: [synonyms]} via a guarded
    literal_eval (the reference returns the raw braces string)."""
    import ast

    text = _strip_think(answer)
    for marker in ("synonyms =", "synonyms="):
        if marker in text:
            start = text.rfind(marker) + len(marker)
            break
    else:
        start = text.find("{")
        if start < 0:
            return None
    end = text.rfind("}", start) + 1
    raw = text[start:end].strip()
    b = raw.find("{")
    if b < 0:
        return None
    try:
        val = ast.literal_eval(raw[b:])
        return val if isinstance(val, dict) else None
    except (ValueError, SyntaxError):
        return None


def parse_longitudinal(answer: str) -> Dict[str, object]:
    """'longitudinal pancreas' (RadGPT.py:1594-1603): which report index is
    the first diagnosis and which precede it."""
    text = _strip_think(answer)
    first = re.search(
        r"first diagnosis report\s*[=:]\s*(\d+|none)(?=[;\n.]|$)",
        text, re.IGNORECASE)
    pre = re.search(
        r"pre-diagnosis reports\s*[=:]\s*([\d,\s]+|none)(?=[;\n.]|$)",
        text, re.IGNORECASE)
    return {
        "First Diagnosis Report": first.group(1) if first else None,
        "Pre-Diagnosis Reports": pre.group(1).strip() if pre else None,
    }


def parse_longitudinal_diagnosis(answer: str):
    """'longitudinal pancreas diagnosis' (RadGPT.py:1605-1614): the
    'tumor types:' line."""
    m = re.search(r"tumor types\s*:\s*(.*?)(?=$|\n)", _strip_think(answer),
                  re.IGNORECASE)
    return {"Tumor Types": m.group(1).strip()} if m else None


def parse_refine_normal_pancreas(answer: str, strict: bool = False):
    """'refine normal pancreas' (+' 2') (RadGPT.py:1600-1628): the LLM's
    include/exclude screening decision (+ confidence / human-review flags in
    the full variant)."""
    text = _strip_think(answer)
    pats = {
        "Decision": r"^[\s]*[-*•]?\s*decision\s*[:=\-]\s*(exclude|include)",
        "Confidence": r"^\s*confidence\s*[:=\-]\s*(high|medium|low)",
        "Human Review Needed":
            r"^\s*human\s+review\s+required\s*[:=\-]\s*(yes|no)",
    }
    keys = ("Decision",) if strict else tuple(pats)
    out = {}
    for k in keys:
        m = re.search(pats[k], text, re.IGNORECASE | re.MULTILINE)
        out[k] = m.group(1).strip().capitalize() if m else None
    return out


def parse_matching_reports(answer: str) -> Dict[str, object]:
    """'find matching reports' (RadGPT.py:1469-1470): same-report yes/no."""
    pat = r"same report\s*[=:]\s*.*?(?:;|$|,|/|yes|no)"
    return {"Matching Reports": _yes_no_u(pat, _strip_think(answer))}
