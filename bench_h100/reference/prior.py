# Frozen copy of the parts of odam_torch/mapping/prior.py
# that the benchmark's plain reference uses; it imports nothing of odam_torch.
"""Class-conditional scale priors for the mapping stage (a copy of
``odam_tpu/mapping/prior.py``).

The 8 Scan2CAD classes the pipeline cares about, their ShapeNet category ids
(reference: sq_libs.py:13-22 CLASS_MAPPER, eval_scan2cad.py:25-45), and the
per-class inverse covariance of object scale roots used as a Mahalanobis
anchor during optimization (weight 20, sq_libs.py:463-466).

The numeric tables below are the contents of the reference's ``scale_prior``
data artifact (a 1.1 KB pickle computed offline from Scan2CAD annotation
dimensions by prior_calculation.py:21-47), embedded as literals.
"""
from __future__ import annotations

import numpy as np

CLASS_NAMES = {
    "03211117": "display",
    "04379243": "table",
    "02808440": "bathtub",
    "02747177": "trashbin",
    "04256520": "sofa",
    "03001627": "chair",
    "02933112": "cabinet",
    "02871439": "bookshelf",
}

# detector class index -> ShapeNet category id (sq_libs.py:13-22)
CLASS_MAPPER = {
    0: "03211117",
    1: "04379243",
    2: "02808440",
    3: "02747177",
    4: "04256520",
    5: "03001627",
    6: "02933112",
    7: "02871439",
}

NUM_PRIOR_CLASSES = len(CLASS_MAPPER)

# Inverse covariance of per-class scale roots (data artifact; see module doc).
_SCALE_PRIOR_INVCOV = {
    "03211117": [
        [90.926284, 15.771541, -33.876753],
        [15.771541, 60.425513, -89.669298],
        [-33.876753, -89.669298, 203.075099],
    ],
    "04379243": [
        [15.898494, -3.236517, -3.589330],
        [-3.236517, 3.114279, -2.693837],
        [-3.589330, -2.693837, 38.768306],
    ],
    "02808440": [
        [56.393069, -21.609825, 4.106600],
        [-21.609825, 13.996107, -2.111154],
        [4.106600, -2.111154, 12.447898],
    ],
    "02747177": [
        [190.555564, -25.313971, -53.489841],
        [-25.313971, 152.421222, -37.485231],
        [-53.489841, -37.485231, 48.511322],
    ],
    "04256520": [
        [8.443606, -2.751535, -2.148203],
        [-2.751535, 3.782270, -2.838568],
        [-2.148203, -2.838568, 53.532523],
    ],
    "03001627": [
        [116.516804, -66.181124, -6.484149],
        [-66.181124, 108.322490, -16.785521],
        [-6.484149, -16.785521, 80.076090],
    ],
    "02933112": [
        [45.878904, 0.145301, -4.265090],
        [0.145301, 3.446627, 0.259046],
        [-4.265090, 0.259046, 6.485107],
    ],
    "02871439": [
        [77.991029, -3.489060, -0.937014],
        [-3.489060, 2.593919, -0.144027],
        [-0.937014, -0.144027, 2.963891],
    ],
}


def prior_invcov_table() -> np.ndarray:
    """[NUM_PRIOR_CLASSES, 3, 3] inverse-covariance table indexed by detector class."""
    table = np.zeros((NUM_PRIOR_CLASSES, 3, 3), np.float32)
    for cls_idx, catid in CLASS_MAPPER.items():
        table[cls_idx] = np.asarray(_SCALE_PRIOR_INVCOV[catid], np.float32)
    return table


def prior_invcov_for_classes(obj_class: np.ndarray) -> np.ndarray:
    """Gather [O, 3, 3] inverse covariances; out-of-range classes get zeros
    (no prior), which disables the Mahalanobis term for them."""
    table = prior_invcov_table()
    obj_class = np.asarray(obj_class, np.int64)
    out = np.zeros((len(obj_class), 3, 3), np.float32)
    in_range = (obj_class >= 0) & (obj_class < NUM_PRIOR_CLASSES)
    out[in_range] = table[obj_class[in_range]]
    return out


