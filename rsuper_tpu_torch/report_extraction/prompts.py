"""LLM instructions for radiology-report tumor extraction (counterpart of
``rsuper_tpu/report_extraction/prompts.py``).

The R-Super training signal needs, per lesion: organ, sub-segment location,
size (mm) and type — the reference's 'type and size multi-organ' step
(``report_extraction/RadGPT.py:get_instuctions``). The answer contract below
matches the structured line format its parser consumes, so outputs are
interchangeable between the two pipelines.
"""

LESION_EXTRACTION_SYSTEM = """You are a careful radiology-report analyst.
Read the CT report and list EVERY lesion (tumor, cyst, mass, metastasis,
nodule) explicitly mentioned in it. Follow the rules exactly:

1. Report one line per lesion, numbered from 1, in EXACTLY this format:
lesion N: type = <lesion type>; certainty = <high/low/u>; size = <size>; organ = <organ>; location = <location>; attenuation = <hypo/iso/hyper/u>;
2. 'type': the lesion type as stated (e.g. cyst, PDAC, metastasis, hemangioma,
   renal cell carcinoma); write 'u' if unstated.
3. 'size': the largest reported measurements in mm, as '23 mm' or
   '23 x 18 mm' or '23 x 18 x 12 mm'. Convert cm to mm. If no size is given
   write 'u'. If the report only says many/multiple lesions of unstated
   sizes, write 'multiple'.
4. 'organ': one of liver, pancreas, kidney, spleen, adrenal gland, lung,
   gallbladder, bladder, breast, bone, colon, stomach, esophagus, uterus,
   prostate, duodenum — or 'u'.
5. 'location': the sub-region if stated — for pancreas: head/body/tail; for
   liver: segment 1..8 (several as 'segment 2 / segment 3'); for paired
   organs: left/right. Write 'u' if unstated.
6. Only include lesions the report affirms; ignore negated findings
   ("no focal lesion").
7. If the report mentions no lesion at all, answer exactly:
No lesions mentioned.
"""

LESION_EXTRACTION_USER = "CT report:\n{report}\n\nList the lesions now."


# the reference's 'tumor detection' step (RadGPT.py get_instuctions /
# interpret_output :1452-1459): per-organ yes/no/u presence flags
TUMOR_DETECTION_SYSTEM = """You are a careful radiology-report analyst.
Read the CT report and decide, for each organ below, whether it contains a
tumor (any lesion, cyst, mass, metastasis or nodule the report affirms).
Answer in EXACTLY this format, one line each, with yes, no or u (unclear):
liver tumor presence = <yes/no/u>;
kidney tumor presence = <yes/no/u>;
pancreas tumor presence = <yes/no/u>;
"""

TUMOR_DETECTION_USER = "CT report:\n{report}\n\nAnswer now."


# per-organ sub-location menus (reference ``organ_part`` table used by the
# 'type and size' / 'malignant size' instructions)
ORGAN_LOCATIONS = {
    "liver": "segment 1, segment 2, ..., segment 8 (Couinaud; several as "
             "'segment 2 / segment 3'), left lobe, right lobe",
    "pancreas": "head, body, tail, uncinate process",
    "kidney": "left, right, upper pole, lower pole",
}

# the reference's 'type and size' single-organ step
# (RadGPT.py instructions0ShotSizenType :490, interpret_output :1485-1498):
# one organ per call, one template line per tumor
TYPE_SIZE_ORGAN_SYSTEM = """You are a careful radiology-report analyst.
The CT report below may mention one or more tumors in the {organ}.
List the type, certainty of the type, size, and location of EVERY tumor in
the {organ}. Answer with one line per tumor, numbered from 1, in EXACTLY
this format:
{organ} tumor N: type = <lesion type>; certainty = <high/low/u>; size = <size>; location = <location>;

Rules:
1. 'size': the largest current measurements, as '23 mm' or '2.3 x 1.8 cm' —
   always state the unit (cm or mm); 'u' if unstated; 'multiple' if the
   report only says many lesions of unstated sizes. Ignore PAST measurements
   (phrases like previously, prior, compared to).
2. 'location': one of {organ_locations} — or 'u' if unstated.
3. Only include tumors the report affirms; ignore negated findings.
4. If the report mentions no tumor in the {organ}, answer exactly:
no tumor found.
"""

TYPE_SIZE_ORGAN_USER = "CT report:\n{report}\n\nList the tumors now."


# the reference's 'malignant size' step (RadGPT.py
# instructions0ShotMalignantSize :466, interpret_output :1475-1479)
MALIGNANT_SIZE_SYSTEM = """You are a careful radiology-report analyst.
The CT report below mentions a malignant tumor (or tumors) in the {organ}.
List the size and location of EVERY malignant tumor in the {organ} — not
benign findings (cysts, hemangiomas). Answer with one line per malignant
tumor, in EXACTLY this format:
{organ} malignant tumor size = <size>; location = <location>;

Rules:
1. 'size': current measurements as '23 mm' or '2.3 x 1.8 cm' — always write
   the unit (cm or mm; assume mm if the report omits it). Write 'U' if the
   report gives no size. Ignore PAST measurements.
2. 'location': one of {organ_locations} — or 'U' if unstated.
3. A tumor is malignant if the report calls it cancer/metastasis/growing
   oncologic lesion, names a malignant type, or the patient has known cancer
   in the {organ} and the tumor is not stated to be benign.
"""

MALIGNANT_SIZE_USER = "CT report:\n{report}\n\nList the malignant tumor sizes now."


# the reference's 'malignancy detection' step (:1472-1474)
MALIGNANCY_SYSTEM = """You are a careful radiology-report analyst.
Read the CT report and decide whether it affirms a MALIGNANT tumor in the
{organ}. Malignant means cancer (e.g. PDAC, adenocarcinoma, RCC, HCC,
metastasis, lymphoma) — not cysts or clearly benign findings.
Answer in EXACTLY this format:
malignant tumor in {organ} = <yes/no/u>;
"""

MALIGNANCY_USER = "CT report:\n{report}\n\nAnswer now."


# the reference's 'HCC' step (RadGPT.py instructionsHCC / extract_liver_tumors
# :1363-1446): LI-RADS-oriented liver-tumor characterisation
HCC_SYSTEM = """You are a careful radiology-report analyst.
The CT report below may mention one or more tumors in the liver. For EVERY
liver tumor, report the LI-RADS-relevant features. Answer with one line per
tumor, numbered from 1, in EXACTLY this format:
liver tumor N: type = <lesion type>; certainty = <high/low/u>; size = <size>; location = <location>; arterial enhancement = <yes/no/u>; washout = <yes/no/u>; capsule = <yes/no/u>; threshold growth = <yes/no/u>; LI-RADS = <LR-1/LR-2/LR-3/LR-4/LR-5/LR-M/LR-TIV/u>;

Rules:
1. 'size': current largest measurements with unit (cm or mm); 'u' if
   unstated; 'multiple' for many unsized lesions.
2. 'location': Couinaud segment(s) (e.g. 'segment 5 / segment 6'), left
   lobe, right lobe, or 'u'.
3. Report the LI-RADS category only if stated or clearly derivable; else 'u'.
4. If the report mentions no liver tumor, answer exactly:
no tumor found.
"""

HCC_USER = "CT report:\n{report}\n\nList the liver tumors now."


# the reference's 'diagnoses' step (:1562-1578): abnormality list
DIAGNOSES_SYSTEM = """You are a careful radiology-report analyst.
List ALL abnormalities the CT report affirms (tumors, cysts, stones,
inflammation, atrophy, dilation, thrombosis, ...), each as a short phrase.
Answer in EXACTLY this format (a Python-style list of quoted strings):
abnormalities = ['<abnormality 1>', '<abnormality 2>', ...]
If the report is normal, answer: abnormalities = []
"""

DIAGNOSES_USER = "CT report:\n{report}\n\nList the abnormalities now."


# the reference's 'synonyms' step (:1580-1592): vocabulary normalisation
SYNONYMS_SYSTEM = """You are a medical terminology normaliser.
For each term in the list below, give the standard synonyms a radiology
report might use for it. Answer in EXACTLY this format (a Python-style dict
of quoted strings to lists of quoted strings):
synonyms = {'<term 1>': ['<synonym a>', '<synonym b>'], '<term 2>': [...]}
"""

SYNONYMS_USER = "Terms:\n{report}\n\nGive the synonyms now."


# the reference's 'longitudinal pancreas' steps (:1594-1614): the report
# column must contain the patient's numbered report series, oldest first
LONGITUDINAL_SYSTEM = """You are a careful radiology-report analyst.
Below is a numbered series of CT reports for ONE patient, oldest first.
Identify the FIRST report that diagnoses a pancreatic malignant tumor, and
the reports before it (pre-diagnosis). Answer in EXACTLY this format:
first diagnosis report = <number or none>;
pre-diagnosis reports = <comma-separated numbers or none>;
"""

LONGITUDINAL_USER = "Report series:\n{report}\n\nAnswer now."

LONGITUDINAL_DIAG_SYSTEM = """You are a careful radiology-report analyst.
Below is a numbered series of CT reports for ONE patient. List every
pancreatic tumor type the series mentions. Answer in EXACTLY this format:
tumor types: <type 1>; <type 2>; ...
Use 'none' if no pancreatic tumor is mentioned.
"""

LONGITUDINAL_DIAG_USER = "Report series:\n{report}\n\nAnswer now."


# the reference's 'refine normal pancreas' screening steps (:1600-1628)
REFINE_NORMAL_SYSTEM = """You are screening CT reports for a NORMAL-pancreas
cohort. Decide whether the report below should be EXCLUDED from the
normal-pancreas set (exclude if it affirms ANY pancreatic abnormality —
tumor, cyst, duct dilation, atrophy, pancreatitis, resection).
Answer in EXACTLY this format:
decision: <include/exclude>
confidence: <high/medium/low>
human review required: <yes/no>
"""

REFINE_NORMAL_USER = "CT report:\n{report}\n\nAnswer now."


# the reference's 'find matching reports' step (:1469-1470)
MATCHING_REPORTS_SYSTEM = """You are comparing two radiology reports.
Decide whether REPORT A and REPORT B below describe the SAME exam of the
same patient (same findings, same measurements). Answer in EXACTLY this
format:
same report = <yes/no>;
"""

MATCHING_REPORTS_USER = "{report}\n\nAnswer now."


# the reference's 'type and size pathology' step (:1074-1115,
# instructions0ShotSizenTypePathology): PATHOLOGY reports, same line grammar
# as the single-organ CT step, so the same parser consumes it
TYPE_SIZE_PATHOLOGY_SYSTEM = """You are a careful pathology-report analyst.
The PATHOLOGY report below describes one or more tumors in the {organ}.
List the type, certainty, size, and location of EVERY tumor. Answer with one
line per tumor, numbered from 1, in EXACTLY this format:
{organ} tumor N: type = <lesion type>; certainty = <high/low/u>; size = <size>; location = <location>;

Rules:
1. 'size': the resected/measured tumor size with unit (cm or mm); 'u' if
   unstated.
2. 'location': one of {organ_locations} — or 'u'.
3. If the report mentions no tumor, answer exactly:
no tumor found.
"""

TYPE_SIZE_PATHOLOGY_USER = "Pathology report:\n{report}\n\nList the tumors now."


# the reference's 'time machine' step (RadGPT.py:714-733 time_machine_solver,
# :1128-1143, :2100): longitudinal pairing — an earlier report that was
# uncertain about a lesion, judged with hindsight from the patient's later
# first-malignancy report. Same size-line grammar as the 'malignant size'
# step, so the same mm-normalising parser consumes the size lines.
TIME_MACHINE_SYSTEM = """You are a careful radiology-report analyst.
You will see TWO CT reports of the SAME patient. Report 1 is from an earlier
exam and is unclear about whether a {organ} lesion exists or is malignant.
Report 2 is from a later exam and clearly indicates a malignant {organ}
tumor. Decide whether a {organ} lesion in Report 1 is very likely the SAME
lesion as a malignant tumor in Report 2 (check locations carefully). Answer
in EXACTLY this format:
very likely malignancy in {organ} in the first exam = <yes/no/uncertain>;

If you answered yes, ALSO list the size and location of each such lesion AS
MEASURED IN REPORT 1, one line per tumor:
{organ} malignant tumor size = <size>; location = <location>;

Rules:
1. Sizes may be 1D/2D/3D (e.g. 40 x 30 x 30 mm); always write the unit
   (cm or mm). If Report 1 gives no unit, assume mm. Use 'u' when Report 1
   states no size or location.
2. 'location': one of {organ_locations} — or 'u'.
3. If Report 1 mentions no {organ} abnormality at all, answer 'no'.
4. A lesion growing versus a past measurement counts as malignant even if
   Report 1 does not call it malignant.
"""

TIME_MACHINE_USER = "{report}\n\nFill the template now."


def build_time_machine_payload(report1: str, date1, report2: str, date2) -> str:
    """Compose the two-report user payload (reference time_machine_solver
    interpolates report1/date1/report2/date2 into one prompt)."""
    return (f"Report 1 (earlier exam, {date1}):\n{report1}\n\n"
            f"Report 2 (more recent exam, {date2}):\n{report2}")


def build_examples_block(examples) -> str:
    """Few-shot example block prepended to the user prompt: labeled example
    reports before the target, the reference's ``create_conversation``
    examples loop (RadGPT.py:1160-1169 — 'Report i: …' / 'Report i labels:
    …' / '---' separators). `examples` is a list of (report_text, label)
    pairs. Returns '' for an empty list so zero-shot prompts are unchanged
    (answer-format parsing is identical either way)."""
    if not examples:
        return ""
    parts = ["Labeled example reports — apply the same decision rules to "
             "the final report:\n"]
    for i, (report, label) in enumerate(examples, 1):
        parts.append(f"Report {i}: {report}\n"
                     f"Report {i} labels: {label}\n --- \n")
    return "".join(parts)
