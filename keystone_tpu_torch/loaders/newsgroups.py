"""20 Newsgroups loader (counterpart of keystone_tpu/loaders/newsgroups.py).

Expects ``dir/<class name>/<one plain-text file per document>``; a class id
is the index of its directory's name in the fixed 20-class list.
"""

from __future__ import annotations

import os
from dataclasses import dataclass

import numpy as np

CLASSES = [
    "comp.graphics",
    "comp.os.ms-windows.misc",
    "comp.sys.ibm.pc.hardware",
    "comp.sys.mac.hardware",
    "comp.windows.x",
    "rec.autos",
    "rec.motorcycles",
    "rec.sport.baseball",
    "rec.sport.hockey",
    "sci.crypt",
    "sci.electronics",
    "sci.med",
    "sci.space",
    "misc.forsale",
    "talk.politics.misc",
    "talk.politics.guns",
    "talk.politics.mideast",
    "talk.religion.misc",
    "alt.atheism",
    "soc.religion.christian",
]


@dataclass
class NewsgroupsData:
    data: list  # of document strings
    labels: np.ndarray  # [N] int32


def newsgroups_loader(data_dir: str, classes: list[str] | None = None) -> NewsgroupsData:
    """Every file under each class directory, classes in list order and
    files in name order; a missing class directory is skipped."""
    classes = classes if classes is not None else CLASSES
    docs, labels = [], []
    for idx, cls in enumerate(classes):
        cls_dir = os.path.join(data_dir, cls)
        if not os.path.isdir(cls_dir):
            continue
        for fname in sorted(os.listdir(cls_dir)):
            path = os.path.join(cls_dir, fname)
            if not os.path.isfile(path):
                continue
            with open(path, errors="replace") as fh:
                docs.append(fh.read())
            labels.append(idx)
    return NewsgroupsData(docs, np.asarray(labels, np.int32))
