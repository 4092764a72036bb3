"""Dataset loading (the port of ``fedml_tpu/data/loader.py``).

``load`` -> ``_load_image_like`` for the dense datasets of
``_DATASET_SPECS`` (images, feature vectors, tables): the real files under
``data_cache_dir`` when present (CIFAR python batches, MNIST /
Fashion-MNIST idx files, the ILSVRC2012 class-per-directory layout, SUSY,
room occupancy, NUS-WIDE; ``data/extra_loaders.py``), else the
deterministic class-structured synthetic stand-in with the real shapes
(``synthetic_hard``: the low-SNR cluster mixture), capped at ~2e8
elements; ``synthetic_condshift`` -> ``_load_condshift`` (per-client train
and test shards); the text datasets (``shakespeare``,
``fed_shakespeare``, ``stackoverflow_nwp``, ``reddit``) ->
``_load_text_like`` -> a LEAF json under ``data_cache_dir/<name>/`` when
present, else a Markov-chain token stream; ``fets2021`` -> ``_load_fets``
(FedSeg's volumes and per-pixel masks: ``FeTS2021/fets2021_prepared.npz``
when present, else the deterministic stand-in).  Arrays are numpy and
bitwise equal to the reference's for the same config.
"""

from __future__ import annotations

import json
import logging
import os
import pickle
import zlib
from pathlib import Path

import numpy as np

from ..arguments import Config
from ..core.flags import cfg_extra
from . import partition as part
from .dataset import FederatedDataset

log = logging.getLogger("fedml_tpu_torch.data.loader")

_DATASET_SPECS = {
    # name: (feat shape, classes, default train size, default test size)
    "mnist": ((28, 28, 1), 10, 60000, 10000),
    "fashionmnist": ((28, 28, 1), 10, 60000, 10000),
    "femnist": ((28, 28, 1), 62, 60000, 10000),
    "cifar10": ((32, 32, 3), 10, 50000, 10000),
    "cifar100": ((32, 32, 3), 100, 50000, 10000),
    "cinic10": ((32, 32, 3), 10, 90000, 90000),
    "synthetic": ((60,), 10, 20000, 4000),
    # the low-SNR gaussian cluster mixture (_synthetic_hard)
    "synthetic_hard": ((32, 32, 3), 10, 20000, 4000),
    # federated Google Landmarks, resized 96x96
    "gld23k": ((96, 96, 3), 203, 23080, 2316),
    "gld160k": ((96, 96, 3), 2028, 164172, 14663),
    # StackOverflow tag prediction as bag-of-words logistic regression
    "stackoverflow_lr": ((10000,), 500, 50000, 10000),
    "lending_club": ((200,), 2, 50000, 10000),
    # ImageNet class-per-directory layout (real sizes come from disk)
    "ilsvrc2012": ((224, 224, 3), 1000, 1281167, 50000),
    # UCI tables
    "susy": ((18,), 2, 100000, 20000),
    "room_occupancy": ((5,), 2, 8143, 2665),
    # NUS-WIDE 634-dim low-level features, top-5 single-label selection
    "nus_wide": ((634,), 5, 60000, 40000),
    # FeTS2021 brain-tumour segmentation: 64x64 slices of 4 MRI modalities
    "fets2021": ((64, 64, 4), 4, 2000, 400),
}

# the synthetic stand-in's cap in f32 elements (~800 MB; reference L127):
# gld160k's real-size default would not fit a host
SYNTHETIC_CAP_ELEMENTS = int(2e8)

# name normalization for the reference's spellings
_DATASET_ALIASES = {"imagenet": "ilsvrc2012", "ilsvrc-2012": "ilsvrc2012"}

_TEXT_SPECS = {
    # name: (seq len, vocab)
    "shakespeare": (80, 90),
    "fed_shakespeare": (80, 90),
    "stackoverflow_nwp": (20, 10004),
    "reddit": (20, 10000),
}


def dataset_spec(name: str):
    """A dense dataset's ``(feat_shape, classes, n_train, n_test)`` under
    :func:`load`'s name normalization; None for text and unknown names
    (reference L84; ``models/model_hub.py`` picks the zoo's stem from it)."""
    n = name.lower()
    return _DATASET_SPECS.get(_DATASET_ALIASES.get(n, n))


def load(cfg: Config) -> FederatedDataset:
    name = cfg.dataset.lower()
    name = _DATASET_ALIASES.get(name, name)
    if name == "fets2021":
        return _load_fets(cfg)
    if name == "synthetic_condshift":
        return _load_condshift(cfg)
    if name in _DATASET_SPECS:
        return _load_image_like(cfg, name)
    if name in _TEXT_SPECS:
        return _load_text_like(cfg, name)
    raise ValueError(f"unknown dataset {cfg.dataset!r}")


def _load_image_like(cfg: Config, name: str) -> FederatedDataset:
    feat, classes, n_train, n_test = _DATASET_SPECS[name]
    cache = Path(os.path.expanduser(cfg.data_cache_dir))
    arrays = _try_load_real(name, cache)
    if arrays is None:
        if not cfg.synthetic_fallback:
            raise FileNotFoundError(f"{name} not found under {cache} and synthetic_fallback=False")
        n_train = cfg.synthetic_train_size or n_train
        n_test = cfg.synthetic_test_size or n_test
        # the reference caps the stand-in at ~2e8 float32 elements
        feat_elems = int(np.prod(feat))
        cap = max(1, SYNTHETIC_CAP_ELEMENTS // max(feat_elems, 1))
        if n_train > cap:
            log.warning("%s synthetic fallback capped at %d samples (was %d)", name, cap, n_train)
            n_train = cap
        test_cap = max(cap // 5, 1)
        if n_test > test_cap:
            log.warning("%s synthetic test set capped at %d samples (was %d)", name, test_cap, n_test)
            n_test = test_cap
        if name == "synthetic_hard":
            arrays = _synthetic_hard(feat, classes, n_train, n_test, cfg.random_seed)
        else:
            arrays = _synthetic_classification(name, feat, classes, n_train, n_test,
                                               cfg.random_seed)
    train_x, train_y, test_x, test_y = arrays
    idx_map = part.partition(
        cfg.partition_method, train_y, cfg.client_num_in_total, cfg.partition_alpha, cfg.random_seed
    )
    return FederatedDataset(
        train_x=train_x, train_y=train_y, test_x=test_x, test_y=test_y,
        client_idx=idx_map, class_num=classes, name=name,
    )


def _dominant_class(masks: np.ndarray) -> np.ndarray:
    """Each mask's most frequent foreground class (0 for an empty one;
    ties to the smaller class, as ``bincount().argmax()``)."""
    out = np.zeros(len(masks), np.int32)
    for i, mk in enumerate(masks):
        fg = mk[mk > 0]
        out[i] = np.bincount(fg).argmax() if fg.size else 0
    return out


def _load_fets(cfg: Config) -> FederatedDataset:
    """FeTS2021 (reference L149): volumes and per-pixel masks; ``train_y``
    holds each sample's dominant tissue class, which the partition reads,
    and the masks ride ``masks`` / ``test_masks`` for FedSeg."""
    from . import extra_loaders

    feat, classes, n_train, n_test = _DATASET_SPECS["fets2021"]
    cache = Path(os.path.expanduser(cfg.data_cache_dir))
    try:
        x, m, tx, tm = extra_loaders.load_fets2021(cache / "FeTS2021")
    except (FileNotFoundError, OSError):
        if not cfg.synthetic_fallback:
            raise FileNotFoundError(f"fets2021_prepared.npz not found under {cache}/FeTS2021 "
                                    "and synthetic_fallback=False")
        n_train = cfg.synthetic_train_size or n_train
        n_test = cfg.synthetic_test_size or n_test
        x, m, tx, tm = extra_loaders.synthesize_fets_like(
            n_train, n_test, cfg.random_seed, hw=feat[0], modalities=feat[2], classes=classes)
    y, ty = _dominant_class(m), _dominant_class(tm)
    idx_map = part.partition(
        cfg.partition_method, y, cfg.client_num_in_total, cfg.partition_alpha, cfg.random_seed
    )
    return FederatedDataset(
        train_x=x, train_y=y, test_x=tx, test_y=ty, client_idx=idx_map,
        class_num=int(max(m.max(), tm.max())) + 1, name="fets2021", masks=m, test_masks=tm,
    )


def _try_load_real(name: str, cache: Path):
    """The real dataset's ``(train_x, train_y, test_x, test_y)`` from
    ``cache`` (reference L190), or None when its files are absent."""
    from . import extra_loaders

    try:
        if name == "cifar10":
            d = cache / "cifar-10-batches-py"
            if d.is_dir():
                return _load_cifar_batches(d, ["data_batch_%d" % i for i in range(1, 6)], ["test_batch"], "labels")
        if name == "cifar100":
            d = cache / "cifar-100-python"
            if d.is_dir():
                return _load_cifar_batches(d, ["train"], ["test"], "fine_labels")
        if name in ("mnist", "fashionmnist"):
            d = cache / name.upper() / "raw" if (cache / name.upper()).is_dir() else cache / name
            if (d / "train-images-idx3-ubyte").exists():
                return _load_idx(d)
        if name == "ilsvrc2012":
            for sub in ("ILSVRC2012", "imagenet", "."):
                root = cache / sub
                if (root / "train").is_dir():
                    return extra_loaders.load_image_folder(root)[:4]
        if name == "susy" and (cache / "SUSY" / "SUSY.csv").exists():
            return extra_loaders.load_susy(cache / "SUSY")
        if name == "room_occupancy" and (cache / "room_occupancy" / "datatraining.txt").exists():
            return extra_loaders.load_room_occupancy(cache / "room_occupancy")
        if name == "nus_wide" and (cache / "NUS_WIDE").is_dir():
            return extra_loaders.load_nus_wide(cache / "NUS_WIDE")
    except (OSError, pickle.UnpicklingError, KeyError, IndexError, ValueError, MemoryError):
        # a present-but-unreadable real dataset must be loud: silently
        # flipping to the stand-in would train on fake data unnoticed
        log.exception(
            "real dataset %r found under %s but failed to load — falling "
            "back to the synthetic stand-in", name, cache,
        )
        return None
    return None


def _load_cifar_batches(d: Path, train_files, test_files, label_key):
    def load_batch(fname):
        with open(d / fname, "rb") as f:
            batch = pickle.load(f, encoding="bytes")
        x = batch[b"data"].reshape(-1, 3, 32, 32).transpose(0, 2, 3, 1).astype(np.float32) / 255.0
        y = np.array(batch[label_key.encode()], dtype=np.int32)
        return x, y

    xs, ys = zip(*[load_batch(f) for f in train_files])
    txs, tys = zip(*[load_batch(f) for f in test_files])
    mean = np.array([0.4914, 0.4822, 0.4465], np.float32)
    std = np.array([0.2470, 0.2435, 0.2616], np.float32)
    train_x = (np.concatenate(xs) - mean) / std
    test_x = (np.concatenate(txs) - mean) / std
    return train_x, np.concatenate(ys), test_x, np.concatenate(tys)


def _load_idx(d: Path):
    """MNIST-format idx files (``train-images-idx3-ubyte`` and the rest):
    ``(n, 28, 28, 1)`` images in [0, 1] and int32 labels."""
    def read_images(p):
        with open(p, "rb") as f:
            data = f.read()
        n = int.from_bytes(data[4:8], "big")
        arr = np.frombuffer(data, np.uint8, offset=16).reshape(n, 28, 28, 1)
        return arr.astype(np.float32) / 255.0

    def read_labels(p):
        with open(p, "rb") as f:
            data = f.read()
        return np.frombuffer(data, np.uint8, offset=8).astype(np.int32)

    return (
        read_images(d / "train-images-idx3-ubyte"),
        read_labels(d / "train-labels-idx1-ubyte"),
        read_images(d / "t10k-images-idx3-ubyte"),
        read_labels(d / "t10k-labels-idx1-ubyte"),
    )


def _load_condshift(cfg: Config) -> FederatedDataset:
    """The conditional-shift benchmark (reference L267): clients belong to
    ``extra.condshift_clusters`` clusters that share one set of class
    prototypes, but each cluster maps the prototypes to labels through its
    own rotation of the label set, so ``p(x | y)`` differs by cluster while
    ``p(x)`` matches.  Each client's test shard follows its own cluster
    (``test_client_idx``).  Draws in the reference's order from its seed."""
    rng = np.random.RandomState(0xC04D ^ (cfg.random_seed * 2654435761 % (2**31)))
    d, classes = 64, 6
    n_clients = cfg.client_num_in_total
    clusters = int(cfg_extra(cfg, "condshift_clusters"))
    if not 1 <= clusters <= 6:
        # np.roll wraps at 6 classes: more clusters would alias earlier ones
        raise ValueError(f"condshift_clusters={clusters} out of range [1, 6] "
                         "(label permutations alias beyond the class count)")
    per_client = int((cfg.synthetic_train_size or 4800) // max(n_clients, 1))
    test_per_client = int((cfg.synthetic_test_size or 1200) // max(n_clients, 1))
    scale = float(cfg_extra(cfg, "condshift_scale"))

    protos = rng.normal(0, 1.0, size=(classes, d)).astype(np.float32)
    protos /= np.linalg.norm(protos, axis=1, keepdims=True)
    perms = [np.roll(np.arange(classes), c) for c in range(clusters)]

    def gen(cluster: int, n: int):
        p = rng.randint(0, classes, size=n)
        x = scale * protos[p] + rng.normal(0, 1.0, size=(n, d)).astype(np.float32)
        return x.astype(np.float32), perms[cluster][p].astype(np.int32)

    xs, ys, txs, tys, client_idx, test_client_idx = [], [], [], [], [], []
    for cid in range(n_clients):
        x, y = gen(cid % clusters, per_client)
        tx, ty = gen(cid % clusters, test_per_client)
        xs.append(x)
        ys.append(y)
        txs.append(tx)
        tys.append(ty)
        client_idx.append(np.arange(cid * per_client, (cid + 1) * per_client))
        test_client_idx.append(np.arange(cid * test_per_client, (cid + 1) * test_per_client))
    return FederatedDataset(
        train_x=np.concatenate(xs), train_y=np.concatenate(ys),
        test_x=np.concatenate(txs), test_y=np.concatenate(tys),
        client_idx=client_idx, test_client_idx=test_client_idx,
        class_num=classes, name="synthetic_condshift")


def _synthetic_classification(name, feat, classes, n_train, n_test, seed):
    """Deterministic class-structured gaussians: per-class mean templates with
    additive noise, learnable by the real models."""
    rng = np.random.RandomState(zlib.crc32(name.encode()) % (2**31) ^ seed)
    templates = rng.normal(0, 1.0, size=(classes,) + feat).astype(np.float32)

    def gen(n):
        y = rng.randint(0, classes, size=n).astype(np.int32)
        x = templates[y] + rng.normal(0, 1.2, size=(n,) + feat).astype(np.float32)
        return x.astype(np.float32), y

    train_x, train_y = gen(n_train)
    test_x, test_y = gen(n_test)
    return train_x, train_y, test_x, test_y


def _synthetic_hard(feat, classes, n_train, n_test, seed, modes_per_class: int = 4,
                    center_scale: float = 0.1):
    """The low-SNR benchmark (reference L339): each class a mixture of
    ``modes_per_class`` gaussian clusters whose centers have per-coordinate
    scale ``center_scale`` against unit noise, so accuracy is limited by
    estimating the centers and grows with samples seen.  Image shapes get
    low-frequency centers (low-resolution noise upsampled 4x)."""
    rng = np.random.RandomState(0x5EED ^ (seed * 2654435761 % (2**31)))
    d = int(np.prod(feat))
    n_clusters = classes * modes_per_class
    if len(feat) == 3 and feat[0] % 4 == 0 and feat[1] % 4 == 0:
        low = rng.normal(0, center_scale,
                         size=(n_clusters, feat[0] // 4, feat[1] // 4, feat[2]))
        centers = np.kron(low, np.ones((1, 4, 4, 1))).reshape(n_clusters, d).astype(np.float32)
    else:
        centers = rng.normal(0, center_scale, size=(n_clusters, d)).astype(np.float32)
    cluster_class = (np.arange(n_clusters) % classes).astype(np.int32)

    def gen(n):
        k = rng.randint(0, n_clusters, size=n)
        x = centers[k] + rng.normal(0, 1.0, size=(n, d)).astype(np.float32)
        return x.reshape((n,) + feat).astype(np.float32), cluster_class[k]

    train_x, train_y = gen(n_train)
    test_x, test_y = gen(n_test)
    return train_x, train_y, test_x, test_y


def _load_text_like(cfg: Config, name: str) -> FederatedDataset:
    """Token sequences ``(n, seq_len)`` and their next-token targets
    (reference L397): the LEAF json when present (clients are its users),
    else Markov-chain streams from the seed, partitioned by their first
    target token."""
    seq_len, vocab = _TEXT_SPECS[name]
    cache = Path(os.path.expanduser(cfg.data_cache_dir))
    leaf = _try_load_leaf_text(name, cache, seq_len, vocab)
    if leaf is not None:
        train_x, train_y, test_x, test_y, client_idx = leaf
    else:
        if not cfg.synthetic_fallback:
            raise FileNotFoundError(f"{name} not found under {cache}")
        n_train = cfg.synthetic_train_size or 20000
        n_test = cfg.synthetic_test_size or 4000
        rng = np.random.RandomState(zlib.crc32(name.encode()) % (2**31) ^ cfg.random_seed)
        # a sparse transition matrix: the next token is learnable
        trans = rng.dirichlet(np.ones(vocab) * 0.05, size=vocab).astype(np.float64)

        def gen(n):
            seqs = np.empty((n, seq_len + 1), np.int32)
            seqs[:, 0] = rng.randint(0, vocab, size=n)
            for t in range(1, seq_len + 1):
                u = rng.random(n)
                cdf = np.cumsum(trans[seqs[:, t - 1]], axis=1)
                seqs[:, t] = (u[:, None] > cdf).sum(axis=1)
            return seqs[:, :-1], seqs[:, 1:]

        train_x, train_y = gen(n_train)
        test_x, test_y = gen(n_test)
        client_idx = part.partition(cfg.partition_method, train_y[:, 0], cfg.client_num_in_total,
                                    cfg.partition_alpha, cfg.random_seed)
    return FederatedDataset(
        train_x=train_x, train_y=train_y, test_x=test_x, test_y=test_y,
        client_idx=client_idx, class_num=vocab, name=name)


# the LEAF shakespeare character set; id 0 is every other character and the pad
_LEAF_CHARS = sorted(set(
    "\n !\"&'(),-.0123456789:;>?ABCDEFGHIJKLMNOPQRSTUVWXYZ[]abcdefghijklmnopqrstuvwxyz}"))


def _try_load_leaf_text(name: str, cache: Path, seq_len: int, vocab: int):
    """The LEAF json reader (reference L436): ``{"users": [...],
    "user_data": {user: {"x": [...], "y": [...]}}}`` from the first json
    of ``<cache>/<name>/train`` and ``/test``; None when either is missing.

    - char-level (the shakespeare family): the fixed character table,
      next-character targets;
    - word-level (``reddit``, ``stackoverflow_nwp``): whitespace tokens
      hashed into ``[1, vocab)`` by crc32, next-word targets.
    Returns ``(train_x, train_y, test_x, test_y, client_idx)``, one client
    per train user in sorted order."""
    d = cache / name
    train_file = next(iter(sorted((d / "train").glob("*.json"))), None) if d.is_dir() else None
    test_file = next(iter(sorted((d / "test").glob("*.json"))), None) if d.is_dir() else None
    if train_file is None or test_file is None:
        return None
    word_level = name in ("reddit", "stackoverflow_nwp")
    table = {c: i + 1 for i, c in enumerate(_LEAF_CHARS)}

    def encode(ids):
        arr = np.zeros(seq_len, np.int32)
        ids = ids[:seq_len]
        arr[:len(ids)] = ids
        return arr

    def chars(s: str) -> list:
        return [table.get(c, 0) for c in s]

    def words(tokens) -> list:
        return [1 + (zlib.crc32(t.encode()) % (vocab - 1)) for t in tokens]

    def tokens_of(sample) -> list:
        # a LEAF reddit sample is a string or a list of token lists
        if isinstance(sample, str):
            return sample.split()
        flat = []
        for piece in sample:
            flat.extend(piece if isinstance(piece, list) else str(piece).split())
        return flat

    def load_split(path):
        with open(path) as f:
            data = json.load(f)
        xs, ys, users = [], [], []
        for u in data["users"]:
            ud = data["user_data"][u]
            for sx, sy in zip(ud["x"], ud["y"]):
                if word_level:
                    tx = tokens_of(sx)
                    ty = tokens_of(sy) if sy else []
                    xs.append(encode(words(tx)))
                    ys.append(encode(words(tx[1:] + ty[:1])))
                else:
                    xs.append(encode(chars(sx)))
                    ys.append(encode(chars(sx[1:] + sy)))
                users.append(u)
        return np.stack(xs), np.stack(ys), users

    train_x, train_y, train_users = load_split(train_file)
    test_x, test_y, _ = load_split(test_file)
    users = sorted(set(train_users))
    of_user = {u: i for i, u in enumerate(users)}
    client_idx = [[] for _ in users]
    for i, u in enumerate(train_users):
        client_idx[of_user[u]].append(i)
    return train_x, train_y, test_x, test_y, [np.array(ix, np.int64) for ix in client_idx]
