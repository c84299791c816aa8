"""Joint CT-Mask + CT-Report dataset producing fixed-shape training records
(the port's own copy of ``rsuper_tpu/data/dataset.py``).

Behavioural equivalent of R-Super's UFO dataset:

* merges a mask dataset (per-voxel tumour labels) with a report dataset
  (organ/sub-segment masks + radiology-report tumour facts), balancing the
  two by oversampling;
* mask cases: tumour/organ/background-mix cropping;
* report cases: 90% crops targeted on a randomly chosen reported tumour
  segment group by bounding-box fit, falling back to random crops;
* report labels are remapped to the full class list with unknown-voxel
  masks, report volumes/diameters for the cropped segment and the chosen
  segment's mask broadcast to the matching lesion channel.

Every record has the same shapes — image (D,H,W) f32, label/unk/segment_mask
(C,D,H,W) u8, volumes (10,), diameters (10,3) — so batches stack. The affine
and intensity augmentation runs on the device (``augment.py``,
``pipeline.py``); records are cropped with the affine's margin.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from . import crops, reports as rep
from .preprocess import load_case
from .table import Table

MARGIN = (20, 40, 40)  # extra crop margin consumed by the on-device affine


@dataclasses.dataclass
class Case:
    case_id: str
    path: str
    is_report: bool  # True: CT-Report (no per-voxel tumors), False: CT-Mask


@dataclasses.dataclass
class RSuperDataConfig:
    classes: Tuple[str, ...]  # final (mask-dataset) class list, sorted
    report_classes: Tuple[str, ...]  # report-dataset class list, sorted
    crop_size: Tuple[int, int, int] = (96, 96, 96)
    tumor_classes: Tuple[str, ...] = ("kidney", "pancreas")
    augment_margin: bool = True
    segment_crop_prob: float = 0.9  # reference :870

    def __post_init__(self):
        for c in self.report_classes:
            low = c.lower()
            if any(t in low for t in ("lesion", " tumor", " mass", "cyst", "pdac", "pnet")):
                raise ValueError(
                    f"report-dataset class {c!r} looks like a lesion class; the "
                    "CT-Report data must not carry per-voxel tumor labels "
                    "(reference dataset_abdomenatlas_UFO.py:302-304)"
                )

    @property
    def load_size(self) -> Tuple[int, int, int]:
        if not self.augment_margin:
            return self.crop_size
        return tuple(c + m for c, m in zip(self.crop_size, MARGIN))

    def lesion_class_indices(self) -> List[int]:
        out = []
        for i, c in enumerate(self.classes):
            if "lesion" in c.lower():
                organ = c.lower().replace("_lesion", "").replace("pancreatic", "pancreas")
                if organ in self.tumor_classes:
                    out.append(i)
        return out

    def foreground_class_indices(self) -> List[int]:
        """Organ channels used for organ-mix crops (reference :585-604)."""
        names = set()
        for t in self.tumor_classes:
            if "pancrea" in t:
                names.add("pancreas")
            elif "kidney" in t:
                names.update(("kidney_left", "kidney_right"))
            elif "gall" in t:
                names.add("gall_bladder")
            else:
                names.add(t)
        return [i for i, c in enumerate(self.classes) if c in names]


def build_case_list(
    mask_cases: Sequence[Tuple[str, str]],
    report_cases: Sequence[Tuple[str, str]],
    balance: bool = True,
    seed: int = 0,
) -> List[Case]:
    """Merge + balance by oversampling the smaller source (reference :192-202).
    Each element: (case_id, npz_path)."""
    rng = np.random.default_rng(seed)
    mask = [Case(i, p, False) for i, p in mask_cases]
    report = [Case(i, p, True) for i, p in report_cases]
    if balance and mask and report:
        if len(mask) > len(report):
            extra = rng.choice(len(report), len(mask) - len(report))
            report = report + [report[i] for i in extra]
        elif len(report) > len(mask):
            extra = rng.choice(len(mask), len(report) - len(mask))
            mask = mask + [mask[i] for i in extra]
    cases = mask + report
    rng.shuffle(cases)
    return cases


def split_train_test(cases: List[Case], seed: int = 0, max_test: int = 200):
    rng = np.random.default_rng(seed)
    order = rng.permutation(len(cases))
    n_test = min(max_test, len(cases) // 10)
    test = [cases[i] for i in order[:n_test]]
    train = [cases[i] for i in order[n_test:]]
    return train, test


def kfold_split(cases: List[Case], k: int, fold: int, seed: int = 0):
    """Deterministic k-fold split (reference fold loop, ``train_ddp.py``
    ``split_seed``/``k_fold`` config): fold `fold` is the test shard."""
    assert 0 <= fold < k
    rng = np.random.default_rng(seed)
    order = rng.permutation(len(cases))
    shards = np.array_split(order, k)
    test = [cases[i] for i in shards[fold]]
    train = [cases[i] for s in range(k) if s != fold for i in shards[s]]
    return train, test


class RSuperDataset:
    """Index-based sampler: `sample(i, rng)` → fixed-shape record dict."""

    def __init__(
        self,
        cases: Sequence[Case],
        cfg: RSuperDataConfig,
        report_rows: Optional[Table] = None,
        class_proportions: Optional[Dict[str, float]] = None,
    ):
        self.cases = list(cases)
        self.cfg = cfg
        self.report_rows = report_rows
        # lesion-class prevalence for inverse-frequency weighting
        # (reference --class_weights; see data/class_weights.py)
        self.class_proportions = class_proportions
        self._report_cls_idx = {c: i for i, c in enumerate(cfg.report_classes)}
        self._cls_idx = {c: i for i, c in enumerate(cfg.classes)}
        self._rows_by_id: Optional[Dict[str, Table]] = None

    def __len__(self):
        return len(self.cases)

    # ------------------------------------------------------------------ utils
    def _case_rows(self, case_id: str) -> Optional[Table]:
        if self.report_rows is None:
            return None
        if self._rows_by_id is None:
            ids = self.report_rows["BDMAP_ID"].values
            self._rows_by_id = {
                c: self.report_rows.filter([i == c for i in ids])
                for c in {case.case_id for case in self.cases}}
        rows = self._rows_by_id.get(case_id)
        return rows if rows is not None and len(rows) else None

    def _segment_mask(self, labels_r: np.ndarray, group: Sequence[str]) -> np.ndarray:
        """Spatial union of a segment group's channels in report-label space."""
        segs = rep.expand_segment_group(list(group))
        out = np.zeros(labels_r.shape[1:], np.uint8)
        for s in segs:
            name = rep.segment_to_label(s)
            j = self._report_cls_idx.get(name)
            if j is not None:
                out |= labels_r[j] > 0
        return out

    # -------------------------------------------------------------- mask case
    def _sample_mask_case(self, case: Case, rng) -> Dict[str, np.ndarray]:
        image, labels = load_case(case.path, num_classes=len(self.cfg.classes))
        size = self.cfg.load_size
        image, labels = crops.pad_pair(image, labels, size)
        lesion_idx = self.cfg.lesion_class_indices()
        tumor_case = bool(labels[lesion_idx].any()) if lesion_idx else False
        img, lab = crops.random_crop_on_tumor(
            image, labels, lesion_idx, size, tumor_case,
            foreground_classes=self.cfg.foreground_class_indices(), rng=rng,
        )
        # np.zeros = calloc (lazy zero pages) — zeros_like's empty+copyto
        # touches all 3·C·N bytes on the 1-core loader host
        zeros = np.zeros(lab.shape, np.uint8)
        return {
            "image": img,
            "label": np.ascontiguousarray(lab, np.uint8),
            "unk": zeros,
            "segment_mask": zeros,
            "volumes": np.zeros((rep.MAX_TUMORS,), np.float32),
            "diameters": np.zeros((rep.MAX_TUMORS, 3), np.float32),
            # mask/random crops may be affine-augmented on device (ref. :573)
            "apply_affine": np.ones((), np.float32),
        }

    # ------------------------------------------------------------ report case
    def _assign_labels(
        self, labels_r: np.ndarray, sup: Dict
    ) -> Tuple[np.ndarray, np.ndarray]:
        """Remap report-space labels to the full class list + unknown masks
        (reference ``assign_labels`` :1154-1298)."""
        cfg = self.cfg
        spatial = labels_r.shape[1:]

        # every segment with tumors anywhere in the CT (organ terms expanded)
        tumor_segments: List[str] = []
        for g in sup["segment_groups"]:
            tumor_segments.extend(g)
        for s in sup["tumor_segments_flat"]:
            if s not in tumor_segments:
                tumor_segments.append(s)
        for organ in sup["tumor_organs"]:
            if organ == "liver" and not any("segment" in s for s in tumor_segments):
                tumor_segments.extend(rep.LIVER_SEGMENTS)
            elif organ == "pancreas" and not any(
                s in ("head", "body", "tail") for s in tumor_segments
            ):
                tumor_segments.extend(rep.PANCREAS_SEGMENTS)
            elif organ == "kidney" and not any(
                s in ("left", "right") for s in tumor_segments
            ):
                tumor_segments.extend(rep.KIDNEY_SEGMENTS)
        tumor_labels = sorted({rep.segment_to_label(s) for s in tumor_segments})

        # per-organ-family union of tumor-bearing segments present in the crop
        unk_family = {
            "liver": np.zeros(spatial, np.uint8),
            "pancreas": np.zeros(spatial, np.uint8),
            "kidney": np.zeros(spatial, np.uint8),
        }
        unk_lesion_organs = set()
        for seg in tumor_labels:
            j = self._report_cls_idx.get(seg)
            if j is None or not labels_r[j].any():
                continue
            for fam, lesion_organ in (
                ("liver", "liver"), ("pancreas", "pancreatic"), ("kidney", "kidney")
            ):
                if fam in seg:
                    unk_family[fam] |= labels_r[j] > 0
                    unk_lesion_organs.add(lesion_organ)
                    break

        label = np.zeros((len(cfg.classes),) + spatial, np.uint8)
        unk = np.zeros_like(label)
        for j, cls in enumerate(cfg.classes):
            if cls in self._report_cls_idx:
                label[j] = labels_r[self._report_cls_idx[cls]]
            elif "lesion" not in cls.lower():
                if cls == "liver":
                    for i in range(1, 9):
                        k = self._report_cls_idx.get(f"liver_segment_{i}")
                        if k is not None:
                            label[j] |= labels_r[k] > 0
                elif cls == "pancreas":
                    for s in ("head", "body", "tail"):
                        k = self._report_cls_idx.get(f"pancreas_{s}")
                        if k is not None:
                            label[j] |= labels_r[k] > 0
                else:
                    unk[j] = 1  # organ truly unannotated in report data
            else:
                for organ in unk_lesion_organs:
                    if organ in cls:
                        fam = "pancreas" if organ == "pancreatic" else organ
                        unk[j] = unk_family[fam]
                        break
        return label, unk

    def _sample_report_case(self, case: Case, rng) -> Dict[str, np.ndarray]:
        image, labels_r = load_case(case.path, num_classes=len(self.cfg.report_classes))
        size = self.cfg.load_size
        image, labels_r = crops.pad_pair(image, labels_r, size)

        rows = self._case_rows(case.case_id)
        sup = rep.case_supervision(rows)
        options = [g for g in sup["segment_groups"]]
        if not options and sup["organs_known"]:
            options = [[o] for o in sup["organs_known"]]

        chosen: Optional[List[str]] = None
        img = lab_r = None
        if options and rng.random() < self.cfg.segment_crop_prob:
            order = list(rng.permutation(len(options)))
            for oi in order:
                group = options[oi]
                fg = self._segment_mask(labels_r, group)
                if not fg.any():
                    continue
                # segment-targeted crops are exact crop_size and never
                # affine-augmented (reference crop() :902 uses no affine);
                # pad back to load_size so every record has one shape.
                out = crops.crop_foreground(
                    image, labels_r, fg, self.cfg.crop_size, rng=rng
                )
                if isinstance(out, tuple):
                    img, lab_r, _ = out
                    img, lab_r = crops.pad_pair(img, lab_r, size)
                    chosen = list(group)
                    break
        if chosen is None:
            img, lab_r = crops.random_crop_on_tumor(
                image, labels_r, [], size, tumor_case=False,
                foreground_classes=None, rng=rng,
            )

        label, unk = self._assign_labels(lab_r, sup)

        volumes = np.zeros((rep.MAX_TUMORS,), np.float32)
        diameters = np.zeros((rep.MAX_TUMORS, 3), np.float32)
        segment_mask = np.zeros_like(label)
        if chosen is not None and rows is not None:
            volumes, diameters = rep.estimate_tumor_volumes(rows, chosen)
            if volumes.sum() > 0:
                spatial_mask = self._segment_mask(lab_r, chosen)
                for j, cls in enumerate(self.cfg.classes):
                    if rep.lesion_class_for_segments(chosen, cls):
                        segment_mask[j] = spatial_mask
                if not segment_mask.any():
                    # crop lost the segment — degrade to a plain report-free record
                    volumes[:] = 0
                    diameters[:] = 0
        return {
            "image": img,
            "label": label,
            "unk": unk,
            "segment_mask": segment_mask,
            "volumes": volumes,
            "diameters": diameters,
            "apply_affine": np.asarray(1.0 if chosen is None else 0.0, np.float32),
        }

    # ---------------------------------------------------------------- public
    def crop_organs(self) -> List[str]:
        """A tag a case for organ-homogeneous CLIP batches: ``"mask"`` for a
        CT-Mask case, ``"healthy"`` for a report case without tumour rows or
        organs, else the case's most reported ``Standardized Organ`` (lower
        case; ties to the alphabetically first). Crops are drawn online, so
        the tag is the case's, where the reference reads each saved crop's
        organ."""
        out: List[str] = []
        for case in self.cases:
            if not case.is_report:
                out.append("mask")
                continue
            rows = self._case_rows(case.case_id)
            organs = [] if rows is None else [
                o.strip().lower() for o in rows["Standardized Organ"].tolist()
                if isinstance(o, str) and o.strip()]
            if not organs:
                out.append("healthy")
                continue
            counts: Dict[str, int] = {}
            for o in organs:
                counts[o] = counts.get(o, 0) + 1
            out.append(max(sorted(counts), key=counts.get))
        return out

    def sample(self, index: int, rng=None) -> Dict[str, np.ndarray]:
        rng = rng or np.random.default_rng()
        case = self.cases[index % len(self.cases)]
        if case.is_report:
            rec = self._sample_report_case(case, rng)
        else:
            rec = self._sample_mask_case(case, rng)
        if self.class_proportions is not None:
            from .class_weights import sample_class_weights

            rec["class_weights"] = sample_class_weights(
                rec["label"], self.class_proportions, self.cfg.classes
            )
        self._sanity(rec)
        return rec

    def _sanity(self, rec):
        """Reference invariants (``SanityAssertOutput`` :1417-1464 and the
        calculate_loss guards :864-869)."""
        assert rec["image"].shape == rec["label"].shape[1:]
        assert rec["label"].shape == rec["unk"].shape == rec["segment_mask"].shape
        if rec["segment_mask"].any():
            assert rec["volumes"].sum() > 0, "segment mask without report volumes"
            assert rec["unk"].any(), "segment mask without unknown voxels"


def to_channels_last(rec: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
    """(C, D, H, W) → (D, H, W, C) + add the image channel axis."""
    out = {
        "image": rec["image"][..., None].astype(np.float32),
        "volumes": rec["volumes"],
        "diameters": rec["diameters"],
    }
    for k in ("label", "unk", "segment_mask"):
        out[k] = np.moveaxis(rec[k], 0, -1)
    for k, v in rec.items():  # extras: apply_affine, class_weights, embeddings
        if k not in out and k != "image":
            out[k] = v
    return out
