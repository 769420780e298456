"""The port's file datasets, packer and threaded loader against the JAX
package's, on the CPU, over a PNG corpus written into ``tmp_path``:

* ``parse_label_file`` and ``ChestXrayDataset``: the same paths, labels,
  class weights and image bytes (PIL's RGB conversion and BILINEAR resize
  on both sides) over grayscale, RGB, non-square, up- and down-sized and
  already-sized files; the same refusals of a bad label file;
* the packs of ``scripts/prepare_dataset.py`` and of the port's
  ``scripts/prepare_dataset_torch.py``: ``images.npy`` and ``labels.npy``
  byte-equal, ``meta.json`` equal; ``PackedChestXrayDataset`` over either
  reads what the PNGs decode to, item by item and by ``batch``;
* pickling a packed dataset leaves its memmap out;
* the threaded ``DataLoader`` at ``num_workers`` 0 and 3 over the PNGs:
  the batches of two epochs equal the JAX ``DataLoader``'s for the same
  seed, shuffled with ``drop_last`` and in order with a ragged tail.
"""

import importlib.util
import json
import pickle
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
from PIL import Image

from gavit_tpu.data import dataset as jds
from gavit_tpu.data.loader import DataLoader as JaxLoader
from gavit_tpu_torch.data import dataset as tds
from gavit_tpu_torch.data.loader import DataLoader, read_batch

ROOT = Path(__file__).resolve().parents[1]
SIZE = 32


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """14 PNGs (grayscale 40 x 40 as NIH's, grayscale 24 x 24, RGB 48 x 36,
    grayscale already at 32 x 32) and a label file in the reference format
    with a blank line; class 13 has no positive."""
    root = tmp_path_factory.mktemp("corpus")
    img_dir = root / "images"
    img_dir.mkdir()
    rng = np.random.default_rng(0)
    labels = (rng.random((14, 14)) < 0.4).astype(np.float32)
    labels[0, :13], labels[1, :13], labels[:, 13] = 1.0, 0.0, 0.0
    shapes = [(40, 40), (24, 24), (36, 48, 3), (SIZE, SIZE)]
    lines = []
    for i in range(14):
        name = f"img_{i:03d}.png"
        Image.fromarray(rng.integers(0, 256, shapes[i % 4], np.uint8)).save(
            img_dir / name)
        lines.append(name + " " + " ".join(f"{v:.0f}" for v in labels[i]))
    label_file = root / "list.txt"
    label_file.write_text("\n".join(lines[:7] + [""] + lines[7:]) + "\n")
    return img_dir, label_file


def _script(name):
    spec = importlib.util.spec_from_file_location(
        name, ROOT / "scripts" / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def test_label_file_and_dataset_match_jax(corpus, tmp_path):
    img_dir, label_file = corpus
    paths, labels = tds.parse_label_file(str(label_file))
    want_paths, want_labels = jds.parse_label_file(str(label_file))
    assert list(paths) == list(want_paths) and len(paths) == 14
    np.testing.assert_array_equal(labels, want_labels)
    assert labels.dtype == np.float32

    ours = tds.ChestXrayDataset(str(img_dir), str(label_file), SIZE)
    theirs = jds.ChestXrayDataset(str(img_dir), str(label_file), SIZE)
    assert len(ours) == len(theirs) == 14
    np.testing.assert_array_equal(ours.class_weights, theirs.class_weights)
    assert ours.class_weights[13] == 1.0  # no positive: weight 1, not inf
    assert ours.disease_names == theirs.disease_names
    assert ours.zero_decode is False
    for i in range(len(ours)):
        image, label = ours[i]
        want_image, want_label = theirs[i]
        assert image.dtype == np.uint8 and image.shape == (SIZE, SIZE, 3)
        np.testing.assert_array_equal(image, want_image)
        np.testing.assert_array_equal(label, want_label)

    bad = tmp_path / "bad.txt"
    for text, match in (("a.png 1 0 1\n", "expected 14"),
                        ("\n\n", "empty label file")):
        bad.write_text(text)
        for parse in (tds.parse_label_file, jds.parse_label_file):
            with pytest.raises(ValueError, match=match):
                parse(str(bad))


def test_both_packers_write_the_same_pack(corpus, tmp_path, monkeypatch):
    """The JAX packer's ``main`` and the port's on the same arguments: the
    same bytes; the port's packed dataset over the JAX pack reads the
    PNGs' decode."""
    img_dir, label_file = corpus
    outs = {}
    for name in ("prepare_dataset", "prepare_dataset_torch"):
        out = tmp_path / name
        argv = ["--image-dir", str(img_dir), "--labels", str(label_file),
                "--out", str(out), "--image-size", str(SIZE), "--workers",
                "3"]
        module = _script(name)
        if name == "prepare_dataset":  # reads sys.argv
            monkeypatch.setattr(sys, "argv", [name, *argv])
            module.main()
        else:
            module.main(argv)
        outs[name] = out
    jax_out, port_out = outs["prepare_dataset"], outs["prepare_dataset_torch"]
    for f in ("images.npy", "labels.npy"):
        assert (jax_out / f).read_bytes() == (port_out / f).read_bytes()
    meta = json.loads((port_out / "meta.json").read_text())
    assert meta == json.loads((jax_out / "meta.json").read_text())
    assert meta["image_size"] == SIZE and len(meta["paths"]) == 14

    raw = tds.ChestXrayDataset(str(img_dir), str(label_file), SIZE)
    assert tds.PackedChestXrayDataset.is_packed(str(jax_out))
    assert not tds.PackedChestXrayDataset.is_packed(str(img_dir))
    packed = tds.PackedChestXrayDataset(str(jax_out))
    theirs = jds.PackedChestXrayDataset(str(port_out))
    assert packed.zero_decode and len(packed) == 14
    assert packed.image_size == SIZE
    assert list(packed.image_paths) == list(theirs.image_paths)
    np.testing.assert_array_equal(packed.class_weights, raw.class_weights)
    for i in range(len(packed)):
        for got, want in zip(packed[i], raw[i]):
            np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(packed[i][0], theirs[i][0])
    idx = np.array([5, 0, 13, 5])
    images, labels = packed.batch(idx)
    assert type(images) is np.ndarray and images.shape == (4, SIZE, SIZE, 3)
    np.testing.assert_array_equal(images, np.stack([raw[i][0] for i in idx]))
    np.testing.assert_array_equal(labels, raw.labels[idx])


def test_packed_dataset_pickles_without_its_memmap(corpus, tmp_path):
    img_dir, label_file = corpus
    _script("prepare_dataset_torch").main([
        "--image-dir", str(img_dir), "--labels", str(label_file), "--out",
        str(tmp_path), "--image-size", str(SIZE), "--workers", "2"])
    packed = tds.PackedChestXrayDataset(str(tmp_path))
    blob = pickle.dumps(packed)
    assert len(blob) < packed.images.nbytes
    clone = pickle.loads(blob)
    assert clone.images is None
    np.testing.assert_array_equal(clone[3][0], packed[3][0])
    clone2 = pickle.loads(blob)
    np.testing.assert_array_equal(clone2.batch([2, 3])[0],
                                  packed.batch([2, 3])[0])


@pytest.mark.parametrize("workers", [0, 3])
@pytest.mark.parametrize("shuffle,drop_last", [(True, True), (False, False)])
def test_threaded_loader_matches_jax(corpus, workers, shuffle, drop_last):
    img_dir, label_file = corpus
    ds = tds.ChestXrayDataset(str(img_dir), str(label_file), SIZE)
    jax_ds = jds.ChestXrayDataset(str(img_dir), str(label_file), SIZE)
    ours = DataLoader(ds, 4, shuffle=shuffle, num_workers=workers,
                      drop_last=drop_last, seed=9)
    theirs = JaxLoader(jax_ds, 4, shuffle=shuffle, num_workers=workers,
                       drop_last=drop_last, seed=9)
    assert len(ours) == len(theirs) == (3 if drop_last else 4)
    for epoch in range(2):
        ours.set_epoch(epoch)
        theirs.set_epoch(epoch)
        got, want = list(ours), list(theirs)
        assert len(got) == len(want) == len(ours)
        for (gi, gl), (wi, wl) in zip(got, want):
            assert gi.dtype == np.uint8
            np.testing.assert_array_equal(gi, wi)
            np.testing.assert_array_equal(gl, wl)
    if not drop_last:
        assert got[-1][0].shape[0] == 2  # the ragged tail
    # read_batch over the items equals the loader's assembly
    np.testing.assert_array_equal(read_batch(ds, [3, 1])[0],
                                  np.stack([ds[3][0], ds[1][0]]))
