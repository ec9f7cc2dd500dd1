"""Leave-2-out cross-validation of VOCSIFTFisher over a small VOC set (the
counterpart of ``tools/voc_leave2out_cv.py``, ACCURACY.md §2).

Five folds of two held-out images each, from ``default_rng(0)``'s
permutation; each fold fits on the other images and scores the average
precision of the classes present in the held-out pair and seen in
training.  Prints the JAX tool's lines: the labels, one line per fold, and
the mean held-out MAP.

Usage:
    python -m keystone_tpu_torch.tools.voc_leave2out_cv \\
        --vocDir DIR --labels CSV [--device cuda|cpu]

``--vocDir`` is a tar, or a directory of tars, holding
``VOCdevkit/VOC2007/JPEGImages/`` members; ``--labels`` the VOC labels CSV.
Both are required (the JAX tool reads the reference repository's test
fixtures at a fixed path outside its checkout).
"""

from __future__ import annotations

import argparse

import numpy as np


def main(argv=None) -> list:
    """Run the five folds; returns each fold's ``(test, test_classes,
    scored, aps, fold_map)``."""
    p = argparse.ArgumentParser("voc_leave2out_cv")
    p.add_argument("--vocDir", required=True)
    p.add_argument("--labels", required=True)
    p.add_argument("--device", default="cuda",
                   help="'cuda' (default; raises without a card) or 'cpu'")
    a = p.parse_args(argv)

    from ..loaders.image_loaders import MultiLabeledImages, voc_loader
    from ..utils.platform import resolve_device
    from ..workloads.voc_sift_fisher import SIFTFisherConfig, run

    device = str(resolve_device(a.device))
    data = voc_loader(a.vocDir, a.labels)
    n = len(data)
    print(f"{n} images; labels per image: {data.labels}")
    conf = SIFTFisherConfig(lam=0.05, desc_dim=16, vocab_size=8, num_pca_samples=6000,
                            num_gmm_samples=6000, device=device)
    perm = np.random.default_rng(0).permutation(n)

    def sub(idx):
        return MultiLabeledImages([data.images[i] for i in idx], [data.labels[i] for i in idx],
                                  [data.filenames[i] for i in idx])

    folds = []
    for f in range(5):
        held = set(perm[2 * f:2 * f + 2].tolist())
        tr = [i for i in range(n) if i not in held]
        te = sorted(held)
        res = run(conf, sub(tr), sub(te))
        train_classes = {c for i in tr for c in data.labels[i]}
        test_classes = sorted({c for i in te for c in data.labels[i]})
        # AP over the classes present in the fold AND learnable (seen in train)
        scored = [c for c in test_classes if c in train_classes]
        aps = [res["aps"][c] for c in scored]
        fold_map = float(np.mean(aps)) if aps else float("nan")
        folds.append((te, test_classes, scored, [round(float(x), 3) for x in aps], fold_map))
        print(f"fold {f}: test={te} test_classes={test_classes} scored={scored} "
              f"aps={folds[-1][3]} foldMAP={fold_map:.3f}")
    print(f"mean held-out MAP over 5 folds: {np.nanmean([fd[4] for fd in folds]):.4f}")
    return folds


if __name__ == "__main__":
    main()
