"""nnU-Net organ and sub-segment inference (counterpart of
``rsuper_tpu/organ_masks/predict_suborgans.py``; the reference's wrapper
around ``nnunetv2``'s ``nnUNetPredictor``, ``PredictSubOrgansnUnet.py``):
the same flags (``--pth/--outdir/--checkpoint/--num_parts/--part_id/
--workers/--BDMAP_format/--ids/--reset``), the same contiguous split into
parts, the same resume by existing outputs.

The network is an external dependency (the published ``prasb/
OrganSubSegmenter`` ResEnc-L checkpoint, ``nnunetv2`` its runtime): this
module is the case discovery, sharding and resume as plain functions, and a
``main`` that runs the predictor where ``nnunetv2`` is installed. ``main``
runs on CUDA unless ``--device cpu`` is given, and raises without CUDA
otherwise. The ``--ids`` CSV is read through ``data/table.py``. Label
splitting and combining downstream: ``organ_masks/labels.py``.

    python -m rsuper_tpu_torch.organ_masks.predict_suborgans \
        --pth CTs/ --outdir masks/ --checkpoint nnUNetOrgansAndSubSegments/ \
        --num_parts 4 --part_id 0 --gpu 0
"""

from __future__ import annotations

import argparse
import os
from typing import List, Optional, Sequence, Tuple


def split_files(
    files_input: Sequence,
    files_output: Sequence,
    num_parts: int,
    part_id: int,
) -> Tuple[list, list]:
    """Contiguous-block split (reference ``split_files`` :21-44): part `i`
    gets rows [i*ceil(N/parts), ...)."""
    assert len(files_input) == len(files_output)
    assert 0 <= part_id < num_parts
    per = (len(files_input) + num_parts - 1) // num_parts
    s = part_id * per
    e = min(s + per, len(files_input))
    return list(files_input[s:e]), list(files_output[s:e])


def filter_existing_outputs(
    files_input: Sequence,
    files_output: Sequence,
) -> Tuple[list, list]:
    """Drop cases whose ``<out>.nii.gz`` already exists (resume;
    reference :72-94)."""
    fi, fo = [], []
    for inp, out in zip(files_input, files_output):
        if os.path.exists(out + ".nii.gz"):
            continue
        fi.append(inp)
        fo.append(out)
    return fi, fo


def collect_cases(
    pth: str,
    outdir: str,
    bdmap_format: bool = False,
    ids: Optional[Sequence[str]] = None,
) -> Tuple[List[List[str]], List[str]]:
    """Input/output file lists in nnU-Net's list-of-lists convention.

    * flat layout: ``<pth>/<id>.nii.gz`` per case;
    * ``bdmap_format``: ``<pth>/<BDMAP_xxx>/ct.nii.gz`` per case
      (reference :120-135).
    """
    if ids is None:
        ids = sorted(os.listdir(pth))
    else:
        ids = sorted(ids)
    if bdmap_format:
        ids = [i for i in ids if "BDMAP" in i]
        files_input = [[os.path.join(pth, i, "ct.nii.gz")] for i in ids]
        files_output = [os.path.join(outdir, i) for i in ids]
    else:
        ids = [
            i[: -len(".nii.gz")] if i.endswith(".nii.gz") else i
            for i in ids
            if not i.startswith(".")
        ]
        # de-dup while keeping order (listdir may carry non-nii entries)
        seen = set()
        ids = [i for i in ids if not (i in seen or seen.add(i))]
        # keep input/output pairing aligned: drop ids whose input file is
        # missing (stray subdirs, csvs) from BOTH lists, not by truncation
        if os.path.isdir(pth):
            ids = [i for i in ids
                   if os.path.exists(os.path.join(pth, f"{i}.nii.gz"))]
        files_input = [[os.path.join(pth, f"{i}.nii.gz")] for i in ids]
        files_output = [os.path.join(outdir, i) for i in ids]
    return files_input, files_output


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--pth", required=True, help="input CT folder")
    p.add_argument("--outdir", required=True, help="prediction output folder")
    p.add_argument("--checkpoint", required=True,
                   help="trained nnU-Net model folder "
                        "(HF prasb/OrganSubSegmenter download)")
    p.add_argument("--num_parts", type=int, default=1)
    p.add_argument("--part_id", type=int, default=0)
    p.add_argument("--gpu", type=int, default=0)
    p.add_argument("--workers", type=int, default=2)
    p.add_argument("--BDMAP_format", action="store_true")
    p.add_argument("--ids", default=None,
                   help="CSV with a 'BDMAP ID' column restricting the cases")
    p.add_argument("--reset", action="store_true", help="overwrite outputs")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    return p.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    from ..utils.device import resolve_device

    device = resolve_device(
        f"cuda:{args.gpu}" if args.device == "cuda" else args.device)
    try:
        from nnunetv2.inference.predict_from_raw_data import nnUNetPredictor
    except ImportError as e:  # pragma: no cover - external dependency
        raise SystemExit(
            "nnunetv2 is required for organ-mask inference (pip install "
            "nnunetv2; checkpoint: huggingface prasb/OrganSubSegmenter). "
            f"Import failed: {e}"
        )

    ids = None
    if args.ids is not None:
        from ..data.table import Table

        table = Table.read_csv(args.ids)
        col = "BDMAP ID" if "BDMAP ID" in table else "BDMAP_ID"
        ids = table[col].tolist()

    files_input, files_output = collect_cases(
        args.pth, args.outdir, args.BDMAP_format, ids
    )
    if not args.reset:
        files_input, files_output = filter_existing_outputs(
            files_input, files_output
        )
    files_input, files_output = split_files(
        files_input, files_output, args.num_parts, args.part_id
    )
    print(f"cases to predict in part {args.part_id}: {len(files_input)}")
    if not files_input:
        return

    predictor = nnUNetPredictor(
        tile_step_size=0.5,
        use_gaussian=True,
        use_mirroring=True,
        perform_everything_on_device=device.type == "cuda",
        device=device,
        verbose=False,
        verbose_preprocessing=False,
        allow_tqdm=True,
    )
    predictor.initialize_from_trained_model_folder(
        args.checkpoint, use_folds=("all",), checkpoint_name="checkpoint_final.pth"
    )
    os.makedirs(args.outdir, exist_ok=True)
    predictor.predict_from_files(
        files_input,
        files_output,
        save_probabilities=False,
        overwrite=args.reset,
        num_processes_preprocessing=args.workers,
        num_processes_segmentation_export=args.workers,
        folder_with_segs_from_prev_stage=None,
        num_parts=1,
        part_id=0,
    )


if __name__ == "__main__":
    main()
