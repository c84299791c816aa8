#!/usr/bin/env python
"""Detection evaluation CLI of the port — counterpart of the JAX package's
``evaluate.py`` (the reference's ``eval_AUC.py`` +
``calculate_sensitivity_specificity_F1_AUC.py``):

    python -m rsuper_tpu_torch.evaluate --pred_dir preds/ \\
        --ground_truth per_ct.csv --out_dir eval/ [--parts 4 --part 0]

Writes ``tumor_detection_results_th{th}.csv`` per confidence threshold
(with ``--parts``, this part's ``...part{part}of{parts}.csv``; the part that
finds every part written merges them) and ``metrics_th{th}.csv``, and prints
the best F1 of each organ. Host only (numpy and scipy): no device flag.
"""

import argparse
import os


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--pred_dir", required=True,
                   help="predict output dir (with *_lesion_prob.nii.gz), or "
                        "an nnU-Net prediction folder with --nnunet")
    p.add_argument("--ground_truth", required=True, help="per-CT metadata CSV")
    p.add_argument("--out_dir", required=True)
    p.add_argument("--organs", nargs="+",
                   default=["liver", "pancreatic", "kidney"])
    p.add_argument("--parts", type=int, default=1)
    p.add_argument("--part", type=int, default=0)
    p.add_argument("--nnunet", action="store_true",
                   help="pred_dir holds flat nnU-Net BDMAP_*.npz probability "
                        "stacks (reference eval_AUC_nnunet.py layout)")
    args = p.parse_args(argv)

    from rsuper_tpu_torch.eval.detection import (
        detection_table,
        detection_table_nnunet,
        merge_detection_parts,
        write_detection_parts,
    )
    from rsuper_tpu_torch.eval.sens_spec import (best_f1, evaluate_detection,
                                                 load_ground_truth)

    os.makedirs(args.out_dir, exist_ok=True)
    if args.nnunet:
        tables = detection_table_nnunet(args.pred_dir,
                                        parts=args.parts, part=args.part)
    else:
        tables = detection_table(args.pred_dir, organs=tuple(args.organs),
                                 parts=args.parts, part=args.part)
    if args.parts > 1:
        # this part is written atomically; the part that lands last finds
        # the full set, merges it and goes on to the metrics
        write_detection_parts(args.out_dir, tables, args.parts, args.part)
        tables = merge_detection_parts(args.out_dir, args.parts)
        if tables is None:
            print(f"[eval] part {args.part}/{args.parts} written; "
                  "other parts still pending — metrics run with the last part")
            return None
    else:
        for th, df in tables.items():
            df.to_csv(os.path.join(args.out_dir,
                                   f"tumor_detection_results_th{th}.csv"))

    gt = load_ground_truth(args.ground_truth, organs=tuple(args.organs))
    evaluated = evaluate_detection(gt, tables, organs=tuple(args.organs))
    for conf, df in evaluated.items():
        df.to_csv(os.path.join(args.out_dir, f"metrics_th{conf}.csv"))
    for organ in args.organs:
        print(organ, best_f1(evaluated, organ))
    return evaluated


if __name__ == "__main__":
    main()
