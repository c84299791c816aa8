"""Dataset maintenance for the organ-masks stage (counterpart of
``rsuper_tpu/organ_masks/maintenance.py``; the reference's one-off repair
and debug scripts of ``organ_masks/``):

* ``fix-bladder``: urinary-bladder masks of the nnU-Net stage sometimes
  swallow the gallbladder (``correct_bug_in_gallbladder.py``); subtract the
  sibling gallbladder mask (when the grids match) and keep the largest
  connected component, in place;
* ``fix-bladder-npz``: the same repair inside the packed ``.npz`` label
  stacks of ``data/preprocess.py``;
* ``copy-dataset``: stage a listed set of cases into the nnU-Net raw layout
  (``imagesTr/{id}_0000.nii.gz``, ``labelsTr/{id}.nii.gz``), reporting
  missing sources;
* ``npz2nii-debug``: dump a random sample of packed cases back to one NIfTI
  a class (identity geometry), leaving the sources as they are.

All of it is host numpy on the port's NIfTI reader (``data/nifti.py``) and
scipy's connected components. An id list is a ``.txt``/``.list`` file or a
CSV read through ``data/table.py``. Work splits with ``--part/--parts``.

    python -m rsuper_tpu_torch.organ_masks.maintenance fix-bladder --root DIR
"""

from __future__ import annotations

import argparse
import os
import shutil
from pathlib import Path
from typing import List, Optional, Sequence

import numpy as np

from ..data.nifti import read_nifti, write_nifti
from ..data.table import Column, Table, isna

GALL_NAMES = ("gall_bladder.nii.gz", "gallbladder.nii.gz")


def largest_component(mask: np.ndarray) -> np.ndarray:
    """Largest 26-connected component of a binary volume (uint8)."""
    from scipy import ndimage

    mask = mask > 0
    if not mask.any():
        return mask.astype(np.uint8)
    lab, n = ndimage.label(mask, structure=np.ones((3, 3, 3)))
    if n <= 1:
        return mask.astype(np.uint8)
    sizes = np.bincount(lab.ravel())
    sizes[0] = 0
    return (lab == int(sizes.argmax())).astype(np.uint8)


def fix_bladder_volume(bladder: np.ndarray,
                       gall: Optional[np.ndarray]) -> np.ndarray:
    """Subtract the gallbladder (same-grid only) and keep the largest CC."""
    out = bladder > 0
    if gall is not None and gall.shape == bladder.shape:
        out &= ~(gall > 0)
    return largest_component(out)


def _part_slice(items: Sequence, part: int, parts: int) -> Sequence:
    import math

    chunk = math.ceil(len(items) / max(parts, 1))
    return items[part * chunk: (part + 1) * chunk]


def _read_id_list(path: str) -> set:
    p = Path(path)
    if p.suffix.lower() in (".txt", ".list"):
        return {ln.strip() for ln in p.read_text().splitlines() if ln.strip()}
    table = Table.read_csv(str(p))
    for col in ("BDMAP ID", "BDMAP_ID", "BDMAP Name", "BDMAP", "ID"):
        if col in table:
            return _present_text(table[col])
    return _present_text(next(iter(table.columns.values())))


def _present_text(col: Column) -> set:
    """``set(col.dropna().astype(str))`` of pandas: ``"20"`` in an int
    column, ``"20.0"`` in a float one (an integer column with a missing
    cell)."""
    return {s for v, s in zip(col, col.astype_str()) if not isna(v)}


def fix_bladder_tree(root: str, ids: Optional[set] = None, part: int = 0,
                     parts: int = 1, skip_no_gall: bool = True,
                     dry_run: bool = False) -> List[tuple]:
    """Repair every ``.../{id}/segmentations/bladder.nii.gz`` under `root`
    in place. Returns (path, status) rows."""
    paths = sorted(
        p for p in Path(root).rglob("bladder.nii.gz")
        if p.parent.name == "segmentations"
        and (ids is None or p.parent.parent.name in ids)
    )
    paths = _part_slice(paths, part, parts)
    results = []
    for p in paths:
        gall_path = next(
            (p.with_name(n) for n in GALL_NAMES if p.with_name(n).exists()),
            None,
        )
        if gall_path is None and skip_no_gall:
            results.append((str(p), "skipped_no_gall"))
            continue
        try:
            img = read_nifti(str(p))
            gall = read_nifti(str(gall_path)).data if gall_path else None
            fixed = fix_bladder_volume(img.data, gall)
            if not dry_run:
                write_nifti(str(p), fixed.astype(np.uint8), img.affine)
            results.append((str(p), "ok" if gall is not None
                            else "ok_no_gall"))
        except Exception as e:  # noqa: BLE001 — per-case degrade, keep going
            results.append((str(p), f"error: {e}"))
    return results


def fix_bladder_npz(npz_paths: Sequence[str], classes: Sequence[str],
                    bladder_class: str = "bladder",
                    gall_class: str = "gall_bladder",
                    dry_run: bool = False) -> List[tuple]:
    """The same repair inside this framework's packed label stacks
    (`data/preprocess.py` .npz layout: packbits labels along the class
    axis). Rewrites each file atomically."""
    from ..data.preprocess import load_case

    classes = list(classes)
    if bladder_class not in classes:
        raise ValueError(f"{bladder_class!r} not in classes")
    bi = classes.index(bladder_class)
    gi = classes.index(gall_class) if gall_class in classes else None
    results = []
    for path in npz_paths:
        try:
            with np.load(path) as z:
                extras = {k: z[k] for k in z.files if k != "labels"}
            _, labels = load_case(path, num_classes=len(classes))
            if labels is None:
                results.append((path, "skipped_no_labels"))
                continue
            labels[bi] = fix_bladder_volume(
                labels[bi], labels[gi] if gi is not None else None)
            if not dry_run:
                extras["labels"] = np.packbits(labels, axis=0)
                tmp = path + ".tmp.npz"
                np.savez_compressed(tmp, **extras)
                os.replace(tmp, path)
            results.append((path, "ok"))
        except Exception as e:  # noqa: BLE001
            results.append((path, f"error: {e}"))
    return results


def copy_dataset(ids: Sequence[str], source_ct_dir: str,
                 source_mask_dir: str, dest_dir: str,
                 ct_name: str = "ct.nii.gz",
                 mask_name: str = "combined_labels.nii.gz",
                 workers: int = 8) -> List[str]:
    """Stage cases into the nnU-Net raw layout (reference
    ``copy_dataset.py``): ``{dest}/imagesTr/{id}_0000.nii.gz`` +
    ``{dest}/labelsTr/{id}.nii.gz``; missing sources are reported, not
    fatal."""
    from concurrent.futures import ThreadPoolExecutor

    img_dir = Path(dest_dir) / "imagesTr"
    lab_dir = Path(dest_dir) / "labelsTr"
    img_dir.mkdir(parents=True, exist_ok=True)
    lab_dir.mkdir(parents=True, exist_ok=True)

    def one(case: str) -> str:
        src_ct = Path(source_ct_dir) / case / ct_name
        src_mask = Path(source_mask_dir) / case / mask_name
        if not src_ct.exists():
            return f"CT not found for {case}"
        if not src_mask.exists():
            return f"Mask not found for {case}"
        shutil.copy(src_ct, img_dir / f"{case}_0000.nii.gz")
        shutil.copy(src_mask, lab_dir / f"{case}.nii.gz")
        return f"Copied {case}"

    with ThreadPoolExecutor(max_workers=workers) as ex:
        return list(ex.map(one, ids))


def npz_to_debug_niis(root: str, classes: Optional[Sequence[str]] = None,
                      num: int = 5, seed: int = 0,
                      out_root: Optional[str] = None) -> List[str]:
    """Dump `num` random packed cases under `root` back to per-class NIfTI
    (``{root}_debugging/{id}/segmentations/{class}.nii.gz`` + ct.nii.gz),
    identity geometry — the reference's npz2nii_debug.py eyeball tool."""
    from ..data.preprocess import load_case

    rng = np.random.default_rng(seed)
    paths = sorted(Path(root).rglob("*.npz"))
    if not paths:
        return []
    pick = [paths[i] for i in rng.permutation(len(paths))[:num]]
    out_root = Path(out_root or (str(Path(root)) + "_debugging"))
    written = []
    for p in pick:
        case = p.stem
        image, labels = load_case(
            str(p), num_classes=len(classes) if classes else None)
        dest = out_root / case
        (dest / "segmentations").mkdir(parents=True, exist_ok=True)
        write_nifti(str(dest / "ct.nii.gz"), image.astype(np.float32),
                    np.eye(4))
        n = labels.shape[0] if labels is not None else 0
        names = (sorted(classes, key=str.casefold) if classes
                 else [f"label_{i:02d}" for i in range(n)])
        for i in range(n):
            write_nifti(str(dest / "segmentations" / f"{names[i]}.nii.gz"),
                        labels[i].astype(np.uint8), np.eye(4))
            written.append(str(dest / "segmentations" / f"{names[i]}.nii.gz"))
    return written


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    sub = ap.add_subparsers(dest="cmd", required=True)

    fb = sub.add_parser("fix-bladder")
    fb.add_argument("--root", required=True)
    fb.add_argument("--ids", help="csv/txt of BDMAP ids to restrict to")
    fb.add_argument("--part", type=int, default=0)
    fb.add_argument("--parts", type=int, default=1)
    fb.add_argument("--no-skip-no-gall-bladder", action="store_true")
    fb.add_argument("--dry-run", action="store_true")

    fn = sub.add_parser("fix-bladder-npz")
    fn.add_argument("npz", nargs="+")
    fn.add_argument("--classes", required=True,
                    help="comma-separated class list of the packed stacks")
    fn.add_argument("--bladder-class", default="bladder")
    fn.add_argument("--gall-class", default="gall_bladder")
    fn.add_argument("--dry-run", action="store_true")

    cp = sub.add_parser("copy-dataset")
    cp.add_argument("--ids", required=True)
    cp.add_argument("--source-ct-dir", required=True)
    cp.add_argument("--source-mask-dir", required=True)
    cp.add_argument("--dest", required=True)
    cp.add_argument("--workers", type=int, default=8)

    dbg = sub.add_parser("npz2nii-debug")
    dbg.add_argument("--root", required=True)
    dbg.add_argument("--classes")
    dbg.add_argument("--num", type=int, default=5)
    dbg.add_argument("--seed", type=int, default=0)
    dbg.add_argument("--out")

    args = ap.parse_args(argv)
    if args.cmd == "fix-bladder":
        rows = fix_bladder_tree(
            args.root, _read_id_list(args.ids) if args.ids else None,
            args.part, args.parts,
            skip_no_gall=not args.no_skip_no_gall_bladder,
            dry_run=args.dry_run)
    elif args.cmd == "fix-bladder-npz":
        rows = fix_bladder_npz(args.npz, args.classes.split(","),
                               args.bladder_class, args.gall_class,
                               dry_run=args.dry_run)
    elif args.cmd == "copy-dataset":
        rows = copy_dataset(sorted(_read_id_list(args.ids)),
                            args.source_ct_dir, args.source_mask_dir,
                            args.dest, workers=args.workers)
    else:
        rows = npz_to_debug_niis(
            args.root, args.classes.split(",") if args.classes else None,
            args.num, args.seed, args.out)
    for r in rows:
        print(r if isinstance(r, str) else f"{r[0]}: {r[1]}")


if __name__ == "__main__":
    main()
