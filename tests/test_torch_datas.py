"""PyTorch port vs JAX package: the data pipeline (``rtfs_net_tpu_torch.datas``).

The port keeps its own copies of the numpy-only modules, so the same
manifest must give the same samples and batches, bit for bit:

* ``wavio``: the port writes the bytes the JAX package writes, and reads
  them (whole, ranged, ``info``) as the JAX package and SciPy do.
* transforms: the train pipeline under one ``random`` seed, the val and
  ``device_normalize`` pipelines, and ``normalize_mouths``.
* ``AVSpeechDataset`` in train mode (random crops and flips under one
  seed), test mode, n_src 2 with ``normalize_audio``, and audio-only.
* ``DataLoader``: thread and process workers, shuffled by ``seed + epoch``
  over two epochs, ``drop_last`` both ways and a shard of two.
"""
import json
import random

import numpy as np
import pytest
from scipy.io import wavfile

from rtfs_net_tpu import datas as jdatas
from rtfs_net_tpu_torch import datas

from _torch_port import one_torch_thread  # noqa: F401

SR = 16000


def _write_manifest(root, lengths):
    """One mixture per entry of ``lengths`` (samples), with two sources and
    two 6-frame mouth tracks."""
    rng = np.random.default_rng(len(lengths))
    mix, s1, s2 = [], [], []
    for i, n in enumerate(lengths):
        paths = []
        for name in ("mix", "s1", "s2"):
            p = str(root / f"{name}_{i}.wav")
            jdatas.wavio.write(p, 0.1 * rng.standard_normal(n).astype(np.float32), SR)
            paths.append(p)
        mouths = []
        for name in ("m1", "m2"):
            p = str(root / f"{name}_{i}.npz")
            np.savez_compressed(p, data=rng.integers(0, 256, (6, 96, 96), dtype=np.uint8))
            mouths.append(p)
        mix.append([paths[0], n])
        s1.append([paths[1], mouths[0], n])
        s2.append([paths[2], mouths[1], n])
    for name, data in (("mix", mix), ("s1", s1), ("s2", s2)):
        with open(root / f"{name}.json", "w") as f:
            json.dump(data, f)
    return str(root)


@pytest.fixture(scope="module")
def manifest(tmp_path_factory):
    """5 mixtures of 2.1 s and one of 1.5 s, which train mode drops."""
    return _write_manifest(tmp_path_factory.mktemp("manifest"), [33600] * 2 + [24000]
                           + [33600] * 3)


@pytest.fixture(scope="module")
def even_manifest(tmp_path_factory):
    """5 mixtures of 2.1 s: 10 target-speaker items of one length."""
    return _write_manifest(tmp_path_factory.mktemp("even"), [33600] * 5)


def _assert_samples_equal(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        if isinstance(w, np.ndarray):
            assert g.dtype == w.dtype and g.shape == w.shape
            np.testing.assert_array_equal(g, w)
        else:
            assert g == w


def test_wavio_round_trip(tmp_path):
    x = (0.3 * np.random.default_rng(1).standard_normal(5000)).clip(-1, 1).astype(np.float32)
    ours, theirs = str(tmp_path / "port.wav"), str(tmp_path / "jax.wav")
    datas.wavio.write(ours, x, SR)
    jdatas.wavio.write(theirs, x, SR)
    with open(ours, "rb") as a, open(theirs, "rb") as b:
        assert a.read() == b.read()
    data, sr = datas.wavio.read(ours)
    sr2, golden = wavfile.read(ours)
    assert sr == sr2 == SR
    np.testing.assert_array_equal(data, golden.astype(np.float32) / 32768.0)
    np.testing.assert_array_equal(data, jdatas.wavio.read(ours)[0])
    np.testing.assert_array_equal(datas.wavio.read(ours, start=100, stop=1100)[0], data[100:1100])
    assert datas.wavio.info(ours) == (5000, SR, 1)
    f32 = str(tmp_path / "f32.wav")
    wavfile.write(f32, SR, x)  # IEEE float
    np.testing.assert_array_equal(datas.wavio.read(f32)[0], x)


@pytest.mark.parametrize("device_normalize", [False, True])
def test_transforms(device_normalize):
    frames = np.random.default_rng(2).integers(0, 256, (5, 96, 96), dtype=np.uint8)
    ours = datas.get_preprocessing_pipelines(device_normalize)
    theirs = jdatas.get_preprocessing_pipelines(device_normalize)
    for split in ("train", "val", "test"):
        for seed in range(4):  # crops and flips drawn from `random`
            random.seed(seed)
            got = ours[split](frames)
            random.seed(seed)
            _assert_samples_equal([got], [theirs[split](frames)])
    from rtfs_net_tpu.datas.transform import normalize_mouths as jax_normalize
    from rtfs_net_tpu_torch.datas.transform import normalize_mouths

    want = jax_normalize(frames)
    np.testing.assert_array_equal(normalize_mouths(frames), want)
    floats = want.astype(np.float32)
    assert normalize_mouths(floats) is floats


@pytest.mark.parametrize("kwargs", [
    dict(n_src=1, segment=2.0),
    dict(n_src=1, segment=None),
    dict(n_src=2, segment=2.0, normalize_audio=True),
    dict(n_src=2, segment=None),
    dict(n_src=1, segment=2.0, audio_only=True),
], ids=["train", "test", "n_src2-normalized", "n_src2-test", "audio-only"])
def test_dataset_matches_jax(manifest, kwargs):
    ours = datas.AVSpeechDataset(manifest, sample_rate=SR, **kwargs)
    theirs = jdatas.AVSpeechDataset(manifest, sample_rate=SR, **kwargs)
    items = 6 if kwargs["segment"] is None else 5  # mixtures kept
    assert len(ours) == len(theirs) == items * (2 if kwargs["n_src"] == 1 else 1)
    for i in range(len(ours)):
        random.seed(i)
        got = ours[i]
        random.seed(i)
        _assert_samples_equal(got, theirs[i])


@pytest.mark.parametrize("loader_kwargs", [
    dict(worker_type="thread", batch_size=3, drop_last=True),
    dict(worker_type="process", batch_size=2, drop_last=False, num_workers=2,
         shard_index=1, num_shards=2),
], ids=["thread", "process-shard"])
def test_loader_matches_jax(even_manifest, loader_kwargs):
    """Test mode (center crops) so that batches decoded in worker
    processes do not depend on a worker's ``random`` state."""
    ours = datas.DataLoader(datas.AVSpeechDataset(even_manifest, n_src=1, sample_rate=SR,
                                                  segment=None),
                            shuffle=True, seed=3, **loader_kwargs)
    theirs = jdatas.DataLoader(jdatas.AVSpeechDataset(even_manifest, n_src=1, sample_rate=SR,
                                                      segment=None),
                               shuffle=True, seed=3, **loader_kwargs)
    try:
        assert ours.worker_type == theirs.worker_type == loader_kwargs["worker_type"]
        assert len(ours) == len(theirs)
        epochs = []
        for epoch in (0, 1):
            ours.set_epoch(epoch)
            theirs.set_epoch(epoch)
            got, want = list(ours), list(theirs)
            assert len(got) == len(want) == len(ours)
            for g, w in zip(got, want):
                _assert_samples_equal(g, w)
            epochs.append([k for batch in got for k in batch[-1]])
        assert epochs[0] != epochs[1]  # the epoch reshuffles
    finally:
        ours.close()
        theirs.close()

