"""Port parity: every dataset of ``fedml_tpu/data/loader.py``
(``fedml_tpu_torch/data/loader.py``) and the readers of
``fedml_tpu/data/extra_loaders.py`` (``data/extra_loaders.py``), bitwise.

The spec tables equal; the synthetic fallbacks at small sizes through both
``load``s (every array, the client index lists and the class count equal;
four specs narrowed alike on both sides, ``NARROWED``), the stand-in's cap (the
port's cap lowered, against the reference at the capped sizes), and the
real-file readers on files the tests write to ``tmp_path``: MNIST /
Fashion-MNIST idx files, an ILSVRC class-per-directory tree of ``.npy`` and
PNG images, SUSY's CSV, the room-occupancy tables, NUS-WIDE's prepared npz
and its raw layout (pandas), FeTS2021's prepared npz (volumes and masks,
their dominant-class labels and partition), and a corrupt file's loud
fallback.
"""

import logging

import numpy as np
import pytest

DENSE = ["mnist", "fashionmnist", "femnist", "cifar10", "cifar100", "cinic10", "synthetic",
         "synthetic_hard", "gld23k", "gld160k", "stackoverflow_lr", "lending_club",
         "ilsvrc2012", "imagenet", "ilsvrc-2012", "susy", "room_occupancy", "nus_wide"]
TEXT = ["shakespeare", "fed_shakespeare", "stackoverflow_nwp", "reddit"]


def _cfgs(tmp_path, **kw):
    import fedml_tpu.arguments as ref_args
    import fedml_tpu_torch.arguments as args

    base = dict(client_num_in_total=4, synthetic_train_size=48, synthetic_test_size=20,
                partition_method="hetero", partition_alpha=5.0, random_seed=3,
                data_cache_dir=str(tmp_path))
    base.update(kw)
    return ref_args.Config(**base), args.Config(**base)


def _assert_same(got, want):
    for f in ("train_x", "train_y", "test_x", "test_y"):
        a, b = getattr(got, f), getattr(want, f)
        assert a.dtype == b.dtype and a.shape == b.shape, f
        np.testing.assert_array_equal(a, b, err_msg=f)
    assert got.class_num == want.class_num and got.name == want.name
    assert len(got.client_idx) == len(want.client_idx)
    for a, b in zip(got.client_idx, want.client_idx):
        np.testing.assert_array_equal(a, b)
    assert (got.test_client_idx is None) == (want.test_client_idx is None)


# specs whose stand-in costs seconds a side at their real widths (a
# 10,004 x 10,004 Markov matrix, 1,000 or 2,028 class templates of 224x224x3
# or 96x96x3): both loaders get the same narrower spec for the bitwise check;
# the real tables are held equal below
NARROWED = {"stackoverflow_nwp": ("_TEXT_SPECS", (20, 600)), "reddit": ("_TEXT_SPECS", (20, 500)),
            "ilsvrc2012": ("_DATASET_SPECS", ((24, 24, 3), 1000, 1281167, 50000)),
            "gld160k": ("_DATASET_SPECS", ((24, 24, 3), 2028, 164172, 14663))}
_ALIASES = {"imagenet": "ilsvrc2012", "ilsvrc-2012": "ilsvrc2012"}


def test_spec_tables_are_the_reference_s():
    from fedml_tpu.data import loader as ref_loader
    from fedml_tpu_torch.data import loader

    assert loader._DATASET_SPECS == ref_loader._DATASET_SPECS
    assert loader._TEXT_SPECS == ref_loader._TEXT_SPECS
    assert loader._DATASET_ALIASES == ref_loader._DATASET_ALIASES


@pytest.mark.parametrize("name", DENSE + TEXT + ["synthetic_condshift"])
def test_synthetic_fallback_bitwise(tmp_path, monkeypatch, name):
    from fedml_tpu.data import loader as ref_loader
    from fedml_tpu_torch.data import loader

    spec = _ALIASES.get(name, name)
    if spec in NARROWED:
        table, narrow = NARROWED[spec]
        for mod in (loader, ref_loader):
            monkeypatch.setitem(getattr(mod, table), spec, narrow)
    ref_cfg, cfg = _cfgs(tmp_path, dataset=name)
    _assert_same(loader.load(cfg), ref_loader.load(ref_cfg))
    assert loader.dataset_spec(name) == ref_loader.dataset_spec(name)


def test_dataset_spec_and_refusals(tmp_path):
    from fedml_tpu.data import loader as ref_loader
    from fedml_tpu_torch.data import loader

    for name in DENSE + TEXT + ["FEMNIST", "ImageNet", "unknown", "fets2021"]:
        assert loader.dataset_spec(name) == ref_loader.dataset_spec(name)
    # FeTS2021's prepared volumes (reference extra_loaders L213), then with
    # the file absent and no fallback: FileNotFoundError in both packages
    rs = np.random.RandomState(7)
    d = tmp_path / "FeTS2021"
    d.mkdir()
    masks = rs.randint(0, 4, (40, 6, 6)).astype(np.int16)
    masks[3] = 0  # no foreground: dominant class 0
    masks[4] = [[1, 2, 2, 0, 1, 0]] * 6  # a tie between 1 and 2 goes to 1
    np.savez(d / "fets2021_prepared.npz", train_x=rs.randn(40, 6, 6, 4), train_m=masks,
             test_x=rs.randn(5, 6, 6, 4), test_m=rs.randint(0, 3, (5, 6, 6)))
    ref_cfg, cfg = _cfgs(tmp_path, dataset="fets2021", client_num_in_total=2)
    got, want = loader.load(cfg), ref_loader.load(ref_cfg)
    _assert_same(got, want)
    for f in ("masks", "test_masks"):
        assert getattr(got, f).dtype == np.int32
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f))
    assert got.train_x.dtype == np.float32 and got.train_y[3] == 0 and got.train_y[4] == 1
    (d / "fets2021_prepared.npz").unlink()
    for pkg_loader, c in ((loader, cfg), (ref_loader, ref_cfg)):
        c.synthetic_fallback = False
        with pytest.raises(FileNotFoundError, match="fets2021_prepared.npz"):
            pkg_loader.load(c)
    _, cfg = _cfgs(tmp_path, dataset="no_such_set")
    with pytest.raises(ValueError, match="unknown dataset"):
        loader.load(cfg)
    _, cfg = _cfgs(tmp_path, dataset="susy", synthetic_fallback=False)
    with pytest.raises(FileNotFoundError):
        loader.load(cfg)


def test_synthetic_cap(tmp_path, monkeypatch):
    """With the cap lowered to 2,000 elements of 60 features (33 samples, 6
    test), the stand-in is the reference's at those sizes."""
    from fedml_tpu.data import loader as ref_loader
    from fedml_tpu_torch.data import loader

    monkeypatch.setattr(loader, "SYNTHETIC_CAP_ELEMENTS", 2000)
    ref_cfg, _ = _cfgs(tmp_path, dataset="synthetic", synthetic_train_size=33,
                       synthetic_test_size=6, partition_method="homo")
    _, cfg = _cfgs(tmp_path, dataset="synthetic", synthetic_train_size=200,
                   synthetic_test_size=50, partition_method="homo")
    got = loader.load(cfg)
    assert got.train_x.shape == (33, 60) and got.test_x.shape == (6, 60)
    _assert_same(got, ref_loader.load(ref_cfg))


def _write_idx(d, rs, n, n_test):
    d.mkdir(parents=True)
    for prefix, count in (("train", n), ("t10k", n_test)):
        images = rs.randint(0, 256, size=(count, 28, 28), dtype=np.uint8)
        labels = rs.randint(0, 10, size=count, dtype=np.uint8)
        (d / f"{prefix}-images-idx3-ubyte").write_bytes(
            b"\x00\x00\x08\x03" + count.to_bytes(4, "big") + b"\x00\x00\x00\x1c" * 2
            + images.tobytes())
        (d / f"{prefix}-labels-idx1-ubyte").write_bytes(
            b"\x00\x00\x08\x01" + count.to_bytes(4, "big") + labels.tobytes())


def _write_folder(root, rs):
    from PIL import Image

    for split, per in (("train", 3), ("val", 2)):
        for cls in ("ant", "bee", "cat"):
            d = root / split / cls
            d.mkdir(parents=True)
            for i in range(per):
                if i % 2:
                    Image.fromarray(rs.randint(0, 256, (8, 8, 3), dtype=np.uint8)).save(
                        d / f"{i}.png")
                else:
                    np.save(d / f"{i}.npy", rs.rand(8, 8, 3).astype(np.float32))
            (d / "notes.txt").write_text("not an image")


def _write_nus_raw(d, rs):
    labels = ["sky", "tree", "car", "dog"]
    (d / "Groundtruth" / "AllLabels").mkdir(parents=True)
    (d / "Groundtruth" / "TrainTestLabels").mkdir(parents=True)
    (d / "Low_Level_Features").mkdir(parents=True)
    for k, lab in enumerate(labels):
        col = (rs.rand(30) < 0.2 + 0.15 * k).astype(int)
        (d / "Groundtruth" / "AllLabels" / f"Labels_{lab}.txt").write_text(
            "\n".join(map(str, col)) + "\n")
    for split, n in (("Train", 24), ("Test", 12)):
        onehot = np.eye(len(labels), dtype=int)[rs.randint(0, len(labels), n)]
        onehot[::5] = 0  # rows without a label
        for k, lab in enumerate(labels):
            (d / "Groundtruth" / "TrainTestLabels" / f"Labels_{lab}_{split}.txt").write_text(
                "\n".join(map(str, onehot[:, k])) + "\n")
        for feat, width in (("CH", 3), ("EDH", 2)):
            rows = [" ".join(f"{v:.6f}" for v in rs.rand(width)) + " " for _ in range(n)]
            (d / "Low_Level_Features" / f"{split}_Normalized_{feat}.dat").write_text(
                "\n".join(rows) + "\n")


@pytest.mark.parametrize("name", ["mnist", "fashionmnist", "ilsvrc2012", "susy",
                                  "room_occupancy", "nus_wide", "nus_wide_raw"])
def test_real_readers_bitwise(tmp_path, name):
    """Each reader on files written here, through both ``load``s."""
    from fedml_tpu.data import loader as ref_loader
    from fedml_tpu_torch.data import loader

    rs = np.random.RandomState(7)
    dataset = "nus_wide" if name == "nus_wide_raw" else name
    if name == "mnist":
        _write_idx(tmp_path / "MNIST" / "raw", rs, 40, 12)
    elif name == "fashionmnist":
        _write_idx(tmp_path / "fashionmnist", rs, 40, 12)
    elif name == "ilsvrc2012":
        _write_folder(tmp_path / "ILSVRC2012", rs)
    elif name == "susy":
        (tmp_path / "SUSY").mkdir()
        rows = [",".join([str(float(rs.randint(0, 2)))] + [f"{v:.7f}" for v in rs.randn(18)])
                for _ in range(40)]
        (tmp_path / "SUSY" / "SUSY.csv").write_text("\n".join(rows) + "\n\n")
    elif name == "room_occupancy":
        (tmp_path / "room_occupancy").mkdir()
        for f, n in (("datatraining.txt", 40), ("datatest.txt", 10)):
            rows = ['"id","date","Temperature","Humidity","Light","CO2","HumidityRatio",'
                    '"Occupancy"']
            rows += [f'"{i}","2015-02-04 17:51:00",' + ",".join(f"{v:.4f}" for v in rs.rand(5))
                     + f",{rs.randint(0, 2)}" for i in range(n)]
            (tmp_path / "room_occupancy" / f).write_text("\n".join(rows) + "\n")
    elif name == "nus_wide":
        (tmp_path / "NUS_WIDE").mkdir()
        np.savez(tmp_path / "NUS_WIDE" / "nus_wide_prepared.npz",
                 train_x=rs.rand(40, 634), train_y=rs.randint(0, 5, 40),
                 test_x=rs.rand(10, 634), test_y=rs.randint(0, 5, 10))
    else:
        pytest.importorskip("pandas")
        _write_nus_raw(tmp_path / "NUS_WIDE", rs)
    ref_cfg, cfg = _cfgs(tmp_path / "ref_unused", dataset=dataset, client_num_in_total=2,
                         partition_method="homo")
    ref_cfg.data_cache_dir = cfg.data_cache_dir = str(tmp_path)
    if name == "nus_wide_raw":  # the port prepares the npz; the reference reads its own
        from fedml_tpu.data import extra_loaders as ref_extra
        from fedml_tpu_torch.data import extra_loaders

        got = extra_loaders.load_nus_wide(tmp_path / "NUS_WIDE", top_k=3)
        (tmp_path / "NUS_WIDE" / "nus_wide_prepared.npz").unlink()
        want = ref_extra._prepare_nus_wide(tmp_path / "NUS_WIDE", 3)
        assert got[0].shape == (len(got[1]), 5)
        for a, b in zip(got, want):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)
        return
    got, want = loader.load(cfg), ref_loader.load(ref_cfg)
    _assert_same(got, want)
    sizes = {"mnist": 40, "fashionmnist": 40, "ilsvrc2012": 9, "susy": 32, "room_occupancy": 40,
             "nus_wide": 40}
    assert got.train_x.shape[0] == sizes[name]  # the files, not the stand-in


def test_corrupt_file_falls_back_loudly(tmp_path, caplog):
    """A present but unreadable dataset logs the failure and takes the
    stand-in, as the reference does."""
    from fedml_tpu_torch.data import loader

    (tmp_path / "SUSY").mkdir()
    (tmp_path / "SUSY" / "SUSY.csv").write_text("1.0,not-a-number\n")
    _, cfg = _cfgs(tmp_path, dataset="susy")
    with caplog.at_level(logging.ERROR):
        ds = loader.load(cfg)
    assert ds.train_x.shape == (48, 18)
    assert any("failed to load" in r.getMessage() for r in caplog.records)
