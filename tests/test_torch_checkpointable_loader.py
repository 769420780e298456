"""``CheckpointableLoader`` (``gavit_tpu_torch/data/checkpointable.py``)
held to the contract ``tests/test_grain_pipeline.py`` holds the JAX
package's ``GrainLoader`` to, on the CPU: shapes, determinism, epochs that
differ, no batch straddling an epoch, ``drop_last`` dropping tail records,
a mid-epoch ``get_state``/``set_state``, ``set_epoch`` idempotence, decode
threads (the same batches with and without them, and a resume across
them); ``device_iterator``'s state sampled per consumed batch whatever
the prefetch; and through the port's Trainer, with this loader and with
the threaded ``DataLoader`` it is: preempted after a few steps and
resumed from the checkpoint, the two runs train each sample of the epoch
exactly once, and end bit-equal to the uninterrupted run (dropout and the
uint8 augmentation on).
"""

import json

import numpy as np
import pytest
import torch

from gavit_tpu_torch.config import from_dict
from gavit_tpu_torch.data.checkpointable import CheckpointableLoader
from gavit_tpu_torch.data.dataset import SyntheticChestXrayDataset
from gavit_tpu_torch.data.loader import DataLoader, device_iterator
from gavit_tpu_torch.models.vit import build_model, init_params
from gavit_tpu_torch.training.trainer import Trainer
from gavit_tpu_torch.utils import checkpoint as ckpt_lib


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _ds(size=40, image_size=8):
    return SyntheticChestXrayDataset(size=size, image_size=image_size, seed=0)


class _Decode:
    """A dataset read item by item (it has no ``batch``)."""

    def __init__(self, ds):
        self.ds = ds

    def __len__(self):
        return len(self.ds)

    def __getitem__(self, idx):
        return self.ds[idx]


def test_batch_shapes():
    batches = list(CheckpointableLoader(_ds(), 16, drop_last=True))
    assert len(batches) == 2
    images, labels = batches[0]
    assert images.shape == (16, 8, 8, 3) and images.dtype == np.uint8
    assert labels.shape == (16, 14)


def test_shuffle_determinism_and_the_threaded_loaders_order():
    a = list(CheckpointableLoader(_ds(), 8, shuffle=True, seed=3))
    b = list(CheckpointableLoader(_ds(), 8, shuffle=True, seed=3))
    np.testing.assert_array_equal(a[0][1], b[0][1])
    c = list(CheckpointableLoader(_ds(), 8, shuffle=True, seed=4))
    assert not np.array_equal(a[0][1], c[0][1])
    threaded = list(DataLoader(_ds(), 8, shuffle=True, seed=3))
    for (ai, al), (ti, tl) in zip(a, threaded):
        np.testing.assert_array_equal(ai, ti)
        np.testing.assert_array_equal(al, tl)


def test_epochs_differ_when_shuffled():
    loader = CheckpointableLoader(_ds(), 8, shuffle=True, seed=3)
    epoch1 = list(loader)  # advances to the next epoch
    epoch2 = list(loader)
    assert len(epoch1) == len(epoch2) == len(loader) == 5
    assert loader.epoch == 2
    assert not np.array_equal(epoch1[0][1], epoch2[0][1])


def test_batches_never_straddle_epochs_and_drop_last_drops_records():
    ds = _ds(size=20)  # 20 = 2 x 8 + 4
    loader = CheckpointableLoader(ds, 8, shuffle=True, seed=3)
    for _ in range(2):
        epoch = list(loader)
        assert [b[0].shape[0] for b in epoch] == [8, 8, 4]
        rows = np.concatenate([b[0].reshape(len(b[0]), -1) for b in epoch])
        assert len({r.tobytes() for r in rows}) == 20  # each sample once
    dropped = CheckpointableLoader(ds, 8, shuffle=True, seed=3,
                                   drop_last=True)
    assert len(dropped) == 2
    for epoch in range(2):
        got = list(dropped)
        assert [b[0].shape[0] for b in got] == [8, 8]
        assert dropped.epoch == epoch + 1
        order = np.random.default_rng(3 + epoch).permutation(20)
        np.testing.assert_array_equal(np.concatenate([b[1] for b in got]),
                                      ds.labels[order[:16]])


def test_mid_epoch_checkpoint_restore():
    """State after two batches: a fresh loader restored from it continues
    with batch three; the state is JSON with the position."""
    loader = CheckpointableLoader(_ds(), 8, shuffle=True, seed=7)
    it = iter(loader)
    next(it)
    next(it)
    state = loader.get_state()
    expected = next(it)
    assert json.loads(state)["consumed"] == 16
    loader2 = CheckpointableLoader(_ds(), 8, shuffle=True, seed=7)
    loader2.set_state(state)
    rest = list(loader2)
    assert len(rest) == 3
    np.testing.assert_array_equal(rest[0][0], expected[0])
    np.testing.assert_array_equal(rest[0][1], expected[1])
    assert loader2.epoch == 1 and json.loads(loader2.get_state())[
        "consumed"] == 0
    with pytest.raises(ValueError, match="does not fit"):
        CheckpointableLoader(_ds(), 8, seed=8).set_state(state)
    with pytest.raises(ValueError, match="unrecognized"):
        loader2.set_state(b"not a state")


def test_set_epoch_is_idempotent():
    """The current epoch keeps a restored position; another starts its
    epoch from the first record."""
    loader = CheckpointableLoader(_ds(), 8, shuffle=True, seed=7)
    it = iter(loader)
    first = next(it)
    state = loader.get_state()
    loader2 = CheckpointableLoader(_ds(), 8, shuffle=True, seed=7)
    loader2.set_state(state)
    loader2.set_epoch(0)  # the current epoch: the position stays
    assert len(list(loader2)) == 4
    loader2.set_epoch(0)  # from epoch 1: epoch 0 starts afresh
    again = list(loader2)
    assert len(again) == 5
    np.testing.assert_array_equal(again[0][1], first[1])


def test_decode_threads_give_the_same_batches_and_resume():
    ds = _ds(size=24)
    ref = list(CheckpointableLoader(ds, 8, shuffle=True, seed=5))
    pooled = CheckpointableLoader(_Decode(ds), 8, shuffle=True,
                                  num_workers=2, seed=5)
    assert pooled.num_workers == 2
    it = iter(pooled)
    got = [next(it)]
    state = pooled.get_state()
    got += list(it)
    assert len(got) == len(ref) == 3
    for (gi, gl), (ri, rl) in zip(got, ref):
        np.testing.assert_array_equal(gi, ri)
        np.testing.assert_array_equal(gl, rl)
    resumed = CheckpointableLoader(_Decode(ds), 8, shuffle=True,
                                   num_workers=3, seed=5)
    resumed.set_state(state)
    np.testing.assert_array_equal(next(iter(resumed))[0], ref[1][0])


@pytest.mark.parametrize("prefetch", [1, 2, 4])
def test_device_iterator_samples_the_state_per_consumed_batch(prefetch):
    """Each batch's state is the position with that batch consumed, however
    many batches the iterator has pulled ahead."""
    loader = CheckpointableLoader(_ds(), 8, shuffle=True, seed=1)
    seen = []
    for images, labels, state in device_iterator(loader, "cpu", prefetch,
                                                 loader.get_state):
        seen.append(json.loads(state)["consumed"])
        assert torch.is_tensor(images) and images.dtype == torch.uint8
    assert seen == [8, 16, 24, 32, 40]
    nothing = [s for *_, s in device_iterator(DataLoader(_ds(), 8), "cpu")]
    assert nothing == [None] * 5


class _PreemptAfterSteps:
    """Stub preemption handler: fires after n checks (one a train step)."""

    def __init__(self, n):
        self.n = n
        self.count = 0

    @property
    def preempted(self):
        self.count += 1
        return self.count > self.n

    def uninstall(self):
        pass


def _trainer(tmp_path, ds, loader=CheckpointableLoader):
    cfg = from_dict({
        "model": {"name": "custom", "img_size": 16, "patch_size": 8,
                  "embed_dim": 16, "depth": 1, "num_heads": 2,
                  "num_classes": 14, "drop_rate": 0.1},
        "data": {"batch_size": 8, "image_size": 16},
        "training": {"epochs": 1, "warmup_epochs": 1, "precision": "fp32",
                     "log_every": 1000, "seed": 5},
        "paths": {"save_dir": str(tmp_path / "ckpt"),
                  "log_dir": str(tmp_path / "logs")},
    })
    model = init_params(build_model(cfg.model, precision="fp32"),
                        torch.Generator().manual_seed(0))
    tl = loader(ds, 8, shuffle=True, drop_last=True, seed=11)
    vl = loader(ds, 8)
    return cfg, Trainer(cfg, model, ds.class_weights, len(tl), device="cpu",
                        train_loader=tl, val_loader=vl)


def _record(trainer, seen, id_of):
    step = trainer._step

    def recording_step(images, labels):
        seen.extend(id_of[row.tobytes()] for row in images.numpy())
        return step(images, labels)

    trainer._step = recording_step


@pytest.mark.parametrize("loader", [CheckpointableLoader, DataLoader],
                         ids=["checkpointable", "threaded"])
@pytest.mark.parametrize("steps_a", [4, 8], ids=["mid_epoch", "last_step"])
def test_kill_mid_epoch_resume_consumes_exactly_unseen_samples(tmp_path,
                                                               steps_a,
                                                               loader):
    """Preempted after ``steps_a`` of the epoch's 8 steps (after the last
    one too: the resumed epoch then has no batch left), resumed from its
    checkpoint in a fresh Trainer: the union of the batches the two runs
    trained is the epoch's 64 samples, none twice, despite the prefetch;
    the end state (the parameters, the λ, AdamW's moments and the
    generator) is the uninterrupted run's, bit for bit."""
    ds = _ds(size=64, image_size=16)
    id_of = {ds[i][0].tobytes(): i for i in range(len(ds))}
    assert len(id_of) == 64

    cfg, trainer = _trainer(tmp_path, ds, loader)
    seen_a = []
    _record(trainer, seen_a, id_of)
    trainer._preemption = _PreemptAfterSteps(steps_a - 1)
    trainer.train()
    assert len(seen_a) == steps_a * 8 and trainer.step == steps_a

    latest = ckpt_lib.latest_checkpoint(cfg.paths.save_dir)
    _, meta = ckpt_lib.restore(latest)
    assert meta["has_loader_state"] and not meta["epoch_completed"]
    on_disk = json.loads((tmp_path / "ckpt" / latest.split("/")[-1] /
                          "meta.json").read_text())
    assert on_disk["has_loader_state"] is True
    _, resumed = _trainer(tmp_path, ds, loader)
    resumed.restore_checkpoint(latest)
    assert resumed.current_epoch == 0
    seen_b = []
    _record(resumed, seen_b, id_of)
    resumed.train()
    assert len(resumed.train_metrics_history) == 1
    assert len(seen_b) == (8 - steps_a) * 8
    assert set(seen_a).isdisjoint(seen_b)
    assert sorted(seen_a + seen_b) == list(range(64))

    _, straight = _trainer(tmp_path / "straight", ds, loader)
    straight._preemption = _PreemptAfterSteps(100)
    straight.train()
    assert straight.step == resumed.step == 8
    a, b = straight.optimizer, resumed.optimizer
    for pa, pb in zip((p for g in a.param_groups for p in g["params"]),
                      (p for g in b.param_groups for p in g["params"])):
        assert torch.equal(pa, pb)
        for k in ("exp_avg", "exp_avg_sq"):
            assert torch.equal(a.state[pa][k], b.state[pb][k])
    assert torch.equal(straight.generator.get_state(),
                       resumed.generator.get_state())
