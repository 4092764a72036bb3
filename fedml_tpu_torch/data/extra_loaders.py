"""Loaders beyond ``data/loader.py`` (the port of
``fedml_tpu/data/extra_loaders.py``): so far only the edge-case poisoned
sets that ``trust/attack/attacks.py``'s ``edge_case_backdoor`` reads when
they are on disk.  Host numpy, a copy of the reference's (the port imports
nothing of the JAX package).
"""

from __future__ import annotations

import logging
import pickle
from pathlib import Path

import numpy as np

log = logging.getLogger("fedml_tpu_torch.data.extra_loaders")


def load_edge_case_sets(cache: Path, poison_type: str = "southwest"):
    """The canonical poisoned example sets the reference downloads
    (``edge_case_examples/data_loader.py:460``): Southwest-airplane CIFAR
    pickles or ARDIS MNIST tensors, under ``cache/edge_case_examples``.
    Returns (train_examples, test_examples) as float arrays, or None when
    the files are absent (reference L251-281)."""
    d = cache / "edge_case_examples"
    try:
        if poison_type == "southwest":
            with open(d / "southwest_cifar10" / "southwest_images_new_train.pkl", "rb") as f:
                train = pickle.load(f)
            with open(d / "southwest_cifar10" / "southwest_images_new_test.pkl", "rb") as f:
                test = pickle.load(f)
            train = np.asarray(train, np.float32)
            test = np.asarray(test, np.float32)
            if train.max() > 1.5:  # uint8 pickles
                train, test = train / 255.0, test / 255.0
            return train, test
        if poison_type == "ardis":
            import torch

            ds = torch.load(d / "ARDIS" / "ardis_test_dataset.pt")
            imgs = np.asarray([np.asarray(s[0]) for s in ds], np.float32)
            if imgs.ndim == 3:
                imgs = imgs[..., None]
            n = len(imgs) // 2
            return imgs[:n], imgs[n:]
    except FileNotFoundError:
        return None
    except Exception:  # corrupt archive: treat as absent, synthesize instead
        log.exception("failed to read edge-case set %r under %s", poison_type, d)
        return None
    return None
