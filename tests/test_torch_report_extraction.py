"""The port's report extraction (``rsuper_tpu_torch/report_extraction/``)
against the JAX package's, on the CPU, with a stub LLM client.

Every step of ``STEPS`` runs through both packages' ``run_extraction`` and
``postprocess_answers`` on one seeded CSV of 50 reports, sharded in two
parts and resumed; the raw answer files and every CSV are compared byte for
byte. The parsers, the metadata tables and the client are held equal on
seeded corpora. No endpoint is contacted: the client's HTTP call is a stub.
"""

import json
import zlib

import numpy as np
import pandas as pd
import pytest

from rsuper_tpu.report_extraction import client as jclient
from rsuper_tpu.report_extraction import metadata as jmeta
from rsuper_tpu.report_extraction import parse as jparse
from rsuper_tpu.report_extraction import prompts as jprompts
from rsuper_tpu.report_extraction import run as jrun
from rsuper_tpu_torch.data.table import Table
from rsuper_tpu_torch.report_extraction import client as tclient
from rsuper_tpu_torch.report_extraction import metadata as tmeta
from rsuper_tpu_torch.report_extraction import parse as tparse
from rsuper_tpu_torch.report_extraction import prompts as tprompts
from rsuper_tpu_torch.report_extraction import run as trun

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
    path = tmp_path / f"reports{suffix}"
    path.write_bytes(b"")
    with pytest.raises(ValueError, match=suffix.split("s")[0]):
        trun.read_reports(str(path), "Report Text")


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
