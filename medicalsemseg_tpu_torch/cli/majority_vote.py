"""K-fold majority-vote ensembling of NIfTI predictions (counterpart of
medicalsemseg_tpu/cli/majority_vote.py).

    python -m medicalsemseg_tpu_torch.cli.majority_vote --in_folder out \
        --n_classes 14 --folds 5 [--prefix pred] [--out_folder vote]

Globs ``Fold{k}/{prefix}/*`` under ``--in_folder`` for each fold, checks that
every fold holds as many volumes, votes per volume (ties go to background)
and writes uint8 labels with the fold-0 affine. Host-only: NumPy and the
port's NIfTI reader.
"""

from __future__ import annotations

import argparse
import glob
import os

import numpy as np

from medicalsemseg_tpu_torch.data import nifti
from medicalsemseg_tpu_torch.infer.ensemble import majority_vote_np


def get_args(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--in_folder", type=str, required=True,
                   help="Folder containing Fold{k} prediction directories")
    p.add_argument("--out_folder", type=str, default=None)
    p.add_argument("--n_classes", type=int, required=True)
    p.add_argument("--folds", type=int, default=5)
    p.add_argument("--prefix", type=str, default="pred",
                   help="Subdirectory inside each fold dir")
    return p.parse_args(argv)


def main(args):
    fold_files = []
    for k in range(args.folds):
        pattern = os.path.join(args.in_folder, f"Fold{k}", args.prefix, "*")
        files = sorted(glob.glob(pattern))
        if not files:
            raise FileNotFoundError(f"no predictions under {pattern}")
        fold_files.append(files)
    n_vols = len(fold_files[0])
    for k, files in enumerate(fold_files):
        if len(files) != n_vols:
            raise ValueError(f"Fold{k} has {len(files)} volumes, expected "
                             f"{n_vols}")

    out_folder = args.out_folder or os.path.join(args.in_folder,
                                                 "majority_vote")
    os.makedirs(out_folder, exist_ok=True)
    for i in range(n_vols):
        imgs = [nifti.load(fold_files[k][i]) for k in range(args.folds)]
        labels = np.stack([np.asarray(img.data, np.int64) for img in imgs])
        vote = majority_vote_np(labels, args.n_classes).astype(np.uint8)
        name = os.path.basename(fold_files[0][i])
        nifti.save(nifti.NiftiImage(vote, imgs[0].affine),
                   os.path.join(out_folder, name))
        print(f"[{i + 1}/{n_vols}] {name}: ensembled over {args.folds} folds")


if __name__ == "__main__":
    main(get_args())
