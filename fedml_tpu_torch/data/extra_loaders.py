"""Loaders beyond ``data/loader.py`` (the port of
``fedml_tpu/data/extra_loaders.py``): the ImageNet class-per-directory
reader, the UCI SUSY and room-occupancy tables, NUS-WIDE, and the edge-case
poisoned sets that ``trust/attack/attacks.py``'s ``edge_case_backdoor``
reads when they are on disk, and FeTS2021's prepared volumes with their
deterministic stand-in.  Host numpy, a copy of the reference's (the port
imports nothing of the JAX package).
"""

from __future__ import annotations

import csv
import logging
import pickle
from pathlib import Path
from typing import Optional

import numpy as np

log = logging.getLogger("fedml_tpu_torch.data.extra_loaders")


def _read_image_file(p: Path) -> Optional[np.ndarray]:
    """One image: a ``.npy`` array as stored, a PNG / JPEG as f32 RGB in
    [0, 1] through PIL (skipped with a warning when PIL is absent); None
    for any other file."""
    if p.suffix == ".npy":
        return np.load(p)
    if p.suffix.lower() in (".png", ".jpg", ".jpeg"):
        try:
            from PIL import Image
        except ImportError:
            log.warning("PIL not available; skipping %s (use .npy files)", p)
            return None
        return np.asarray(Image.open(p).convert("RGB"), dtype=np.float32) / 255.0
    return None


# in-RAM budget for folder datasets (~4 GB of float32): the reader
# materializes dense arrays, so full-size ILSVRC2012 must be subset or
# pre-resized first
MAX_FOLDER_ELEMENTS = int(1e9)


def load_image_folder(root: Path, splits=("train", "val")):
    """Class-per-directory reader (torchvision's ImageFolder layout;
    reference L64).  Classes are the sorted union of class-directory names
    across splits; every image must share one shape; every split must
    exist.  Returns ``(train_x, train_y, test_x, test_y, class_names)``."""
    classes = sorted({
        d.name for split in splits if (root / split).is_dir()
        for d in (root / split).iterdir() if d.is_dir()
    })
    if not classes:
        raise FileNotFoundError(f"no class directories under {root}/{splits}")
    cls_id = {c: i for i, c in enumerate(classes)}
    out = {}
    for split in splits:
        xs, ys = [], []
        base = root / split
        if not base.is_dir():
            raise FileNotFoundError(
                f"split directory {base} is missing (a rank-1 empty split "
                "would crash eval downstream; unpack all splits)")
        elements = 0
        for cdir in sorted(base.iterdir()):
            if not cdir.is_dir():
                continue
            for f in sorted(cdir.iterdir()):
                img = _read_image_file(f)
                if img is None:
                    continue
                elements += int(np.prod(img.shape))
                if elements > MAX_FOLDER_ELEMENTS:
                    raise MemoryError(
                        f"image folder {base} exceeds the in-RAM budget of "
                        f"{MAX_FOLDER_ELEMENTS} float32 elements; subsample "
                        "or pre-resize the dataset")
                xs.append(np.asarray(img, np.float32))
                ys.append(cls_id[cdir.name])
        if not xs:
            raise FileNotFoundError(f"no readable images under {base}")
        shapes = {x.shape for x in xs}
        if len(shapes) != 1:
            raise ValueError(f"inconsistent image shapes under {base}: {shapes}")
        out[split] = (np.stack(xs), np.asarray(ys, np.int32))
    return out[splits[0]] + out[splits[1]] + (classes,)


def load_susy(d: Path, test_frac: float = 0.2):
    """``SUSY.csv``: the label first, then 18 features (reference L125).
    The last ``test_frac`` of the rows is the test set."""
    x, y = [], []
    with open(d / "SUSY.csv") as f:
        for row in csv.reader(f):
            if not row:
                continue
            y.append(int(float(row[0])))
            x.append([float(v) for v in row[1:19]])
    x = np.asarray(x, np.float32)
    y = np.asarray(y, np.int32)
    n_test = max(1, int(len(x) * test_frac))
    return x[:-n_test], y[:-n_test], x[-n_test:], y[-n_test:]


def load_room_occupancy(d: Path):
    """UCI occupancy detection (reference L143): ``datatraining.txt`` /
    ``datatest.txt`` with columns id, date, Temperature, Humidity, Light,
    CO2, HumidityRatio, Occupancy; the five sensor channels are the
    features."""
    def read(p: Path):
        xs, ys = [], []
        with open(p) as f:
            reader = csv.reader(f)
            next(reader)  # the header
            for row in reader:
                if len(row) < 7:
                    continue
                xs.append([float(v) for v in row[-6:-1]])
                ys.append(int(float(row[-1])))
        return np.asarray(xs, np.float32), np.asarray(ys, np.int32)

    tr = read(d / "datatraining.txt")
    te = read(d / "datatest.txt")
    return tr[0], tr[1], te[0], te[1]


def load_nus_wide(d: Path, top_k: int = 5):
    """NUS-WIDE (reference L168): the prepared ``nus_wide_prepared.npz``
    (``train_x`` / ``train_y`` / ``test_x`` / ``test_y``) when present,
    else prepared once from the raw layout (:func:`_prepare_nus_wide`) and
    saved beside it."""
    npz = d / "nus_wide_prepared.npz"
    if npz.exists():
        z = np.load(npz)
        return (z["train_x"].astype(np.float32), z["train_y"].astype(np.int32),
                z["test_x"].astype(np.float32), z["test_y"].astype(np.int32))
    arrays = _prepare_nus_wide(d, top_k)
    np.savez(npz, train_x=arrays[0], train_y=arrays[1], test_x=arrays[2], test_y=arrays[3])
    return arrays


def _prepare_nus_wide(d: Path, top_k: int):
    """The reference's pandas pipeline (L186): the ``top_k`` labels by
    count, the rows with exactly one of them active, the normalized
    low-level features side by side."""
    try:
        import pandas as pd
    except ImportError as e:
        raise FileNotFoundError(
            f"{d}/nus_wide_prepared.npz absent and pandas unavailable to "
            "prepare it from the raw NUS-WIDE layout") from e
    labels_dir = d / "Groundtruth" / "AllLabels"
    counts = {}
    for f in sorted(labels_dir.iterdir()):
        label = f.stem.split("_")[-1]
        col = pd.read_csv(f, header=None)[0]
        counts[label] = int((col == 1).sum())
    selected = [k for k, _ in sorted(counts.items(), key=lambda kv: kv[1], reverse=True)[:top_k]]

    out = []
    for split in ("Train", "Test"):
        dfs = []
        for label in selected:
            f = d / "Groundtruth" / "TrainTestLabels" / f"Labels_{label}_{split}.txt"
            dfs.append(pd.read_csv(f, header=None).rename(columns={0: label}))
        lab = pd.concat(dfs, axis=1)
        mask = lab.sum(axis=1) == 1 if top_k > 1 else lab[selected[0]] == 1
        feats = []
        for f in sorted((d / "Low_Level_Features").iterdir()):
            if f.name.startswith(f"{split}_Normalized"):
                df = pd.read_csv(f, header=None, sep=" ").dropna(axis=1)
                feats.append(df)
        x = pd.concat(feats, axis=1).loc[mask[mask].index].to_numpy(np.float32)
        y = lab.loc[mask[mask].index, selected].to_numpy().argmax(axis=1).astype(np.int32)
        out.extend([x, y])
    return tuple(out)


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


def load_fets2021(d: Path):
    """Prepared FeTS2021 volumes: ``fets2021_prepared.npz`` holding
    ``train_x`` / ``test_x`` ``(N, H, W, modalities)`` and ``train_m`` /
    ``test_m`` ``(N, H, W)`` tissue masks (reference L217).  Returns
    ``(x, masks, tx, tmasks)`` as f32 and int32."""
    z = np.load(d / "fets2021_prepared.npz")
    return (z["train_x"].astype(np.float32), z["train_m"].astype(np.int32),
            z["test_x"].astype(np.float32), z["test_m"].astype(np.int32))


def synthesize_fets_like(n_train: int, n_test: int, seed: int, hw: int = 64,
                         modalities: int = 4, classes: int = 4):
    """The FeTS-shaped stand-in (reference L228), bitwise: normal
    "anatomy" and one disc a sample painted into its mask with a class in
    ``[1, classes)``, its pixels brightened by ``2 c / classes``, all from
    ``RandomState(0xFE75 ^ seed)``."""
    rs = np.random.RandomState(0xFE75 ^ seed)

    def gen(n):
        base = rs.normal(0, 1, (n, hw, hw, modalities)).astype(np.float32)
        masks = np.zeros((n, hw, hw), np.int32)
        yy, xx = np.mgrid[:hw, :hw]
        for i in range(n):
            c = rs.randint(1, classes)
            cx, cy = rs.randint(hw // 4, 3 * hw // 4, size=2)
            r = rs.randint(hw // 10, hw // 5)
            blob = (yy - cy) ** 2 + (xx - cx) ** 2 <= r * r
            masks[i][blob] = c
            base[i][blob] += 2.0 * c / classes
        return base, masks

    x, m = gen(n_train)
    tx, tm = gen(n_test)
    return x, m, tx, tm
