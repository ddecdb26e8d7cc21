"""The port's data pipeline (`training/data/*`) against the JAX package's on
the same on-disk datasets, all bit-exact: the codebook and pair datasets
(CLEVR and google_earth), the Loader's batches over two epochs at one seed
(serial and on threads), packed shards written by one side
and read by the other, the frame store, and the DataModule's packed
modes. The PNGs are Pillow's (adaptive row filters, Paeth among them),
decoded by the port's own reader (its C++ unfilter)."""
import json
import os

import numpy as np
import pytest
from PIL import Image

from sgam_neurips22_tpu.training.data import codebook_dataset as j_cb
from sgam_neurips22_tpu.training.data import datamodule as j_dm
from sgam_neurips22_tpu.training.data import packed as j_packed
from sgam_neurips22_tpu_torch.training.data import codebook_dataset as t_cb
from sgam_neurips22_tpu_torch.training.data import datamodule as t_dm
from sgam_neurips22_tpu_torch.training.data import packed as t_packed

RES = (32, 32)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _smooth_image(rng):
    """A gradient with noise, so that Pillow's encoder picks Sub, Up,
    Average and Paeth rows."""
    y, x = np.mgrid[0: RES[0], 0: RES[1]]
    base = np.stack([x * 7, y * 5, (x + y) * 3], -1)
    return ((base + rng.integers(0, 12, (*RES, 3))) % 256).astype(np.uint8)


def _write_scene(scene, n, rng, dataset):
    os.makedirs(scene)
    frames = []
    for i in range(n):
        c2w = np.eye(4)
        c2w[:3, 3] = [i * (0.5 if dataset == "clevr-infinite" else 0.05), 0, 0.01 * i]
        fr = {"transform_matrix": c2w.tolist(), "file_path": f"./im_{i:05d}.png"}
        if dataset == "google_earth":
            fr["is_valid"] = i != 3
        frames.append(fr)
        Image.fromarray(_smooth_image(rng)).save(scene / f"im_{i:05d}.png")
        lo, hi = (8, 14) if dataset == "clevr-infinite" else (0.5, 4.0)
        d = rng.uniform(lo, hi, RES).astype(np.float32)
        if dataset == "google_earth":
            d[:3, :3] = 65504.0
        np.save(scene / f"dm_{i:05d}.npy", d)
    with open(scene / "transforms.json", "w") as f:
        json.dump({"frames": frames}, f)


@pytest.fixture(params=["clevr-infinite", "google_earth"])
def pair_dir(request, tmp_path):
    dataset = request.param
    rng = np.random.default_rng(3)
    f = 20.0 if dataset == "clevr-infinite" else 320.0
    np.save(tmp_path / "K.npy", np.array([[f, 0, 15.5], [0, f, 15.5], [0, 0, 1]]))
    for split in ("train", "val"):
        for s in range(2):
            _write_scene(tmp_path / split / f"scene_{s:04d}", 6, rng, dataset)
    return dataset, str(tmp_path)


@pytest.fixture()
def codebook_dir(tmp_path):
    rng = np.random.default_rng(0)
    scene = tmp_path / "train" / "scene"
    os.makedirs(scene)
    np.save(tmp_path / "K.npy", np.array([[20.0, 0, 15.5], [0, 20.0, 15.5], [0, 0, 1]]))
    paths = []
    for i in range(7):
        Image.fromarray(_smooth_image(rng)).save(scene / f"im_{i:05d}.png")
        np.save(scene / f"dm_{i:05d}.npy", rng.uniform(8, 14, RES).astype(np.float32))
        paths.append(str(scene / f"im_{i:05d}.png"))
    (tmp_path / "train.txt").write_text("\n".join(paths))
    (tmp_path / "val.txt").write_text("\n".join(paths[:5]))
    return str(tmp_path)


def _equal_examples(a, b):
    assert set(a) == set(b)
    for k in a:
        assert a[k].dtype == b[k].dtype, k
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def test_pngs_use_the_slow_filters(codebook_dir):
    """The fixtures' PNGs hold Average or Paeth rows, the filters that the
    port's reader undoes byte by byte."""
    import struct
    import zlib

    data = open(os.path.join(codebook_dir, "train", "scene", "im_00000.png"), "rb").read()
    pos, idat = 8, b""
    while pos < len(data):
        (n,) = struct.unpack(">I", data[pos: pos + 4])
        if data[pos + 4: pos + 8] == b"IDAT":
            idat += data[pos + 8: pos + 8 + n]
        pos += 12 + n
    raw = np.frombuffer(zlib.decompress(idat), np.uint8).reshape(RES[0], -1)
    assert set(raw[:, 0]) & {3, 4}


@pytest.mark.parametrize("split", ["train", "val"])
def test_codebook_dataset_bit_exact(codebook_dir, split):
    j = j_cb.CodebookDataset(split, codebook_dir, "clevr-infinite", RES)
    t = t_cb.CodebookDataset(split, codebook_dir, "clevr-infinite", RES)
    assert t.paths == j.paths and len(t) == len(j) == (7 if split == "train" else 5)
    for i in range(len(j)):
        _equal_examples(t[i], j[i])
    j_rgb = j_cb.CodebookDataset(split, codebook_dir, "clevr-infinite", RES, use_depth=False)
    _equal_examples(t_cb.CodebookDataset(split, codebook_dir, "clevr-infinite", RES, use_depth=False)[0], j_rgb[0])


def test_numpy_and_concat_datasets(tmp_path):
    rng = np.random.default_rng(5)
    paths = []
    for i, side in enumerate((32, 40)):  # the second needs the LANCZOS resize
        paths.append(str(tmp_path / f"{i}.npy"))
        np.save(paths[-1], rng.integers(0, 256, (1, 3, side, side), dtype=np.uint8))
    j = j_cb.ConcatDatasetWithIndex([j_cb.NumpyImageDataset(paths, RES), j_cb.NumpyImageDataset(paths[:1], RES)])
    t = t_cb.ConcatDatasetWithIndex([t_cb.NumpyImageDataset(paths, RES), t_cb.NumpyImageDataset(paths[:1], RES)])
    assert len(t) == len(j) == 3
    for i in range(3):
        assert t[i]["dataset_index"] == j[i]["dataset_index"]
        np.testing.assert_array_equal(t[i]["image"], j[i]["image"])


def test_pair_dataset_bit_exact(pair_dir):
    """Graphs, train examples from the same Generator seeds, val examples
    (seeded shuffle); the port's graph cache is read back the same."""
    dataset, ddir = pair_dir
    cls_j, cls_t = j_dm.PAIR_DATASETS[dataset], t_dm.PAIR_DATASETS[dataset]
    for split in ("train", "val"):
        j, t = cls_j(split, ddir, 2, RES), cls_t(split, ddir, 2, RES)
        assert len(t) == len(j) > 0
        assert [sorted(g.adj.items()) for g in t.graphs] == [sorted(g.adj.items()) for g in j.graphs]
        for i in range(len(j)):
            if split == "train":
                _equal_examples(t.__getitem__(i, rng=np.random.default_rng(i)),
                                j.__getitem__(i, rng=np.random.default_rng(i)))
            else:
                _equal_examples(t[i], j[i])
        cached = cls_t(split, ddir, 2, RES)
        _equal_examples(cached.__getitem__(1, rng=np.random.default_rng(0)),
                        t.__getitem__(1, rng=np.random.default_rng(0)))
    assert any(n.endswith(".torch.pkl") for n in os.listdir(os.path.join(ddir, "cache")))


@pytest.mark.parametrize("workers,processes", [(1, False), (8, False), (2, True)],
                         ids=["serial", "threads", "processes"])
def test_loader_two_epochs_bit_exact(pair_dir, workers, processes):
    """The shuffled train loader over two epochs at one seed: the same
    batches as JAX's loader, in the same order, decoded in the loader's
    thread, on 8 threads or on 2 spawned worker processes."""
    dataset, ddir = pair_dir
    j_ds, t_ds = j_dm.PAIR_DATASETS[dataset]("train", ddir, 2, RES), t_dm.PAIR_DATASETS[dataset]("train", ddir, 2, RES)
    j_loader = j_dm.Loader(j_ds, 3, shuffle=True, seed=5)
    t_loader = t_dm.Loader(t_ds, 3, shuffle=True, seed=5, workers=workers, processes=processes)
    for _ in range(2):
        j_batches, t_batches = list(j_loader), list(t_loader)
        assert len(t_batches) == len(j_batches) == len(t_ds) // 3
        for a, b in zip(t_batches, j_batches):
            _equal_examples(a, b)


def test_loader_early_exit_and_errors(codebook_dir):
    ds = t_cb.CodebookDataset("train", codebook_dir, "clevr-infinite", RES)
    loader = t_dm.Loader(ds, 2, shuffle=True, seed=1, prefetch=1)
    for _ in loader:
        break  # the producer stops instead of blocking on a full queue
    assert len(list(loader)) == 3

    class Broken:
        def __len__(self):
            return 4

        def __getitem__(self, i):
            raise KeyError(i)

    with pytest.raises(KeyError):
        list(t_dm.Loader(Broken(), 2))


def test_to_device_cpu():
    import torch

    batch = t_dm.to_device({"a": np.arange(6, dtype=np.float32).reshape(2, 3)}, torch.device("cpu"))
    assert torch.equal(batch["a"], torch.arange(6.0).reshape(2, 3))


def test_shards_cross_read(codebook_dir, tmp_path):
    """A shard written by JAX reads the same in the port and the other way
    round; both equal CodebookDataset's examples."""
    ds = t_cb.CodebookDataset("train", codebook_dir, "clevr-infinite", RES)
    from sgam_neurips22_tpu_torch.training.data.io import load_rgb_u8

    rgb = [load_rgb_u8(p, RES) for p in ds.paths]
    disp = [ds[i]["image"][..., 3] for i in range(len(ds))]
    j_path, t_path = str(tmp_path / "j.sgpk"), str(tmp_path / "t.sgpk")
    j_packed.write_shard(j_path, rgb, disp)
    t_packed.write_shard(t_path, rgb, disp)
    assert open(j_path, "rb").read() == open(t_path, "rb").read()
    for writer, reader in ((j_path, t_packed.PackedCodebookDataset), (t_path, j_packed.PackedCodebookDataset)):
        shard = reader(writer)
        idx = [4, 0, 2]
        batch = shard.assemble_batch(idx)["image"]
        for row, i in zip(batch, idx):
            np.testing.assert_array_equal(row, ds[i]["image"])
        shard.close()


def test_frame_store_bit_exact(pair_dir):
    """The port's pack_pair_frames and PackedFrameStore: pair examples
    through the store equal the per-PNG examples, and JAX's reader gathers
    the same frames from the port's store."""
    dataset, ddir = pair_dir
    cls = t_dm.PAIR_DATASETS[dataset]
    png_ds = cls("val", ddir, 2, RES)
    path = t_packed.frame_store_path(ddir, "val", RES)
    t_packed.pack_pair_frames(png_ds, path)
    store = t_packed.PackedFrameStore(path)
    packed_ds = cls("val", ddir, 2, RES, frame_store=store)
    for i in range(len(png_ds)):
        _equal_examples(packed_ds[i], png_ds[i])
    j_store = j_packed.PackedFrameStore(path)
    for a, b in zip(store.gather([3, 1]), j_store.gather([3, 1])):
        np.testing.assert_array_equal(a, b)
    j_store.close()
    with pytest.raises(OSError, match="frame store"):
        t_packed.PackedCodebookDataset(path)
    store.close()


def test_datamodule_num_workers_decodes_in_processes(pair_dir):
    """`num_workers` > 0 decodes the PNG datasets on that many worker
    processes, with batches equal to JAX's DataModule's (which decodes on
    threads); a dataset with a packed frame store stays in this process."""
    dataset, ddir = pair_dir
    kw = dict(batch_size=3, dataset=dataset, phase="conditional_generation", dataset_dir=ddir,
              image_resolution=list(RES), n_src=2)
    dm = t_dm.DataModule(num_workers=2, packed=False, **kw)
    loader = dm.train_loader()
    assert loader.processes and loader.workers == 2
    for a, b in zip(list(loader) + list(dm.val_loader()),
                    list(j_dm.DataModule(num_workers=2, **kw).train_loader()) + list(j_dm.DataModule(**kw).val_loader())):
        _equal_examples(a, b)
    for split, ds in (("train", dm.train_ds), ("val", dm.val_ds)):
        t_packed.pack_pair_frames(ds, t_packed.frame_store_path(ddir, split, RES))
    stored = t_dm.DataModule(num_workers=2, packed=True, **kw)
    loader = stored.train_loader()
    assert not loader.processes and loader.workers == 8
    for ds in (stored.train_ds, stored.val_ds):
        ds.frame_store.close()


def test_datamodule_packed_modes_match_jax(codebook_dir):
    """'auto' without a shard falls back to PNGs, True raises; with a shard
    both modes read it; every mode's batches equal JAX's DataModule's."""
    kw = dict(batch_size=2, dataset="clevr-infinite", phase="codebook", dataset_dir=codebook_dir,
              image_resolution=list(RES))

    def batches(dm):
        return [b for b in dm.train_loader()] + [b for b in dm.val_loader()]

    with pytest.raises(FileNotFoundError, match="packed=True"):
        t_dm.DataModule(packed=True, **kw)
    fallback = t_dm.DataModule(**kw)
    assert isinstance(fallback.train_ds, t_cb.CodebookDataset)
    want = batches(j_dm.DataModule(**kw))
    for a, b in zip(batches(fallback), want):
        _equal_examples(a, b)
    for split in ("train", "val"):
        ds = t_cb.CodebookDataset(split, codebook_dir, "clevr-infinite", RES)
        from sgam_neurips22_tpu_torch.training.data.io import load_rgb_u8

        t_packed.write_shard(t_packed.shard_path(codebook_dir, split, RES), [load_rgb_u8(p, RES) for p in ds.paths],
                             [ds[i]["image"][..., 3] for i in range(len(ds))])
    for mode in ("auto", True):
        dm = t_dm.DataModule(packed=mode, **kw)
        assert isinstance(dm.train_ds, t_packed.PackedCodebookDataset)
        for a, b in zip(batches(dm), want):
            _equal_examples(a, b)


def test_packed_loader_built_alone():
    """The port builds native/packed_loader.cpp alone into its own build
    directory, under a name that carries the source's hash; native/ gains
    no file."""
    from sgam_neurips22_tpu_torch.core import native
    from sgam_neurips22_tpu_torch.ops.cuda_build import BUILD_DIR

    before = sorted(os.listdir(os.path.join(REPO, "native")))
    lib = t_packed.load_lib()
    path = native.lib_path(t_packed.SOURCE, "libsgam_packed")
    assert path.parent == BUILD_DIR and path.exists()
    assert all(hasattr(lib, s) for s in t_packed.SYMBOLS)
    assert not hasattr(lib, "sgam_native_abi_version")
    assert sorted(os.listdir(os.path.join(REPO, "native"))) == before
