"""Dataset loading: CIFAR images, the ``synthetic`` feature vectors, the
``synthetic_condshift`` benchmark and the token-sequence datasets.

The ported subset of ``fedml_tpu/data/loader.py``: ``load`` ->
``_load_image_like`` -> the real CIFAR python batches under
``data_cache_dir`` when present, else the deterministic class-structured
synthetic stand-in with the real shapes; ``synthetic_condshift`` ->
``_load_condshift`` (per-client train and test shards); the text datasets
(``shakespeare``, ``fed_shakespeare``, ``stackoverflow_nwp``, ``reddit``)
-> ``_load_text_like`` -> a LEAF json under ``data_cache_dir/<name>/`` when
present, else a Markov-chain token stream.  Arrays are numpy and bitwise
equal to the reference's for the same config.  Every other dataset belongs
to a later slice and raises ``NotImplementedError``.
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
    "cifar10": ((32, 32, 3), 10, 50000, 10000),
    "cifar100": ((32, 32, 3), 100, 50000, 10000),
    "synthetic": ((60,), 10, 20000, 4000),
}

_TEXT_SPECS = {
    # name: (seq len, vocab)
    "shakespeare": (80, 90),
    "fed_shakespeare": (80, 90),
    "stackoverflow_nwp": (20, 10004),
    "reddit": (20, 10000),
}


def load(cfg: Config) -> FederatedDataset:
    name = cfg.dataset.lower()
    if name == "synthetic_condshift":
        return _load_condshift(cfg)
    if name in _TEXT_SPECS:
        return _load_text_like(cfg, name)
    if name not in _DATASET_SPECS:
        ported = sorted(_DATASET_SPECS) + sorted(_TEXT_SPECS) + ["synthetic_condshift"]
        raise NotImplementedError(
            f"dataset {cfg.dataset!r} is not ported yet: the first port slice loaded "
            f"CIFAR, later ones the rest of {ported}")
    return _load_image_like(cfg, name)


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
        cap = max(1, int(2e8) // max(feat_elems, 1))
        if n_train > cap:
            log.warning("%s synthetic fallback capped at %d samples (was %d)", name, cap, n_train)
            n_train = cap
        test_cap = max(cap // 5, 1)
        if n_test > test_cap:
            log.warning("%s synthetic test set capped at %d samples (was %d)", name, test_cap, n_test)
            n_test = test_cap
        arrays = _synthetic_classification(name, feat, classes, n_train, n_test, cfg.random_seed)
    train_x, train_y, test_x, test_y = arrays
    idx_map = part.partition(
        cfg.partition_method, train_y, cfg.client_num_in_total, cfg.partition_alpha, cfg.random_seed
    )
    return FederatedDataset(
        train_x=train_x, train_y=train_y, test_x=test_x, test_y=test_y,
        client_idx=idx_map, class_num=classes, name=name,
    )


def _try_load_real(name: str, cache: Path):
    try:
        if name == "cifar10":
            d = cache / "cifar-10-batches-py"
            if d.is_dir():
                return _load_cifar_batches(d, ["data_batch_%d" % i for i in range(1, 6)], ["test_batch"], "labels")
        if name == "cifar100":
            d = cache / "cifar-100-python"
            if d.is_dir():
                return _load_cifar_batches(d, ["train"], ["test"], "fine_labels")
    except (OSError, pickle.UnpicklingError, KeyError, ValueError):
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
