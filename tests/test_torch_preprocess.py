"""The port's manifest builder (``rtfs_net_tpu_torch/data_preprocess/
preprocess.py``) writes the manifests of the JAX side's
``data_preprocess/preprocess.py``, byte for byte, for each dataset's
file naming (lrs2, lrs3, vox2 and the audio-only wham), over the three
splits of one synthetic tree; and its CLI does the same."""
import os

import numpy as np
import pytest

from data_preprocess import preprocess as jax_preprocess
from rtfs_net_tpu_torch.data_preprocess import preprocess
from rtfs_net_tpu_torch.datas import wavio

# a mixture's file name per dataset (tests/test_aux_cli.py:65-70 for lrs2 and vox2)
NAMES = {
    "lrs2": ["abc123_00001_-1.5_def456_00002_1.5.wav", "zz9_00017_0.0_yy8_00003_2.5.wav"],
    "lrs3": ["abcdefghijk_00001_-1.5_lmnopqrstuv_00002_1.5.wav",
             "0123456789a_00042_0.5_bcdefghijkl_00007_-0.5.wav"],
    "vox2": ["id00017_abcdefghijk_00001_-2.0_id00042_lmnopqrstuv_00002_2.0.wav",
             "id00001_0123456789a_00003_1.0_id00002_bcdefghijkl_00004_-1.0.wav"],
    "wham": ["utt_a.wav", "utt_b.wav"],
}


def _tree(root, names, rng):
    for split in ("tr", "cv", "tt"):
        for spk in ("mix", "s1", "s2"):
            d = root / split / spk
            d.mkdir(parents=True)
            for i, name in enumerate(names):
                wavio.write(str(d / name), rng.standard_normal(500 + 100 * i)
                            .astype(np.float32) * 0.1, 16000)
            (d / "notes.txt").write_text("not a wav")


def _manifests(out):
    return {os.path.relpath(os.path.join(d, f), out): open(os.path.join(d, f), "rb").read()
            for d, _, files in os.walk(out) for f in files}


@pytest.mark.parametrize("dataset", sorted(NAMES))
def test_manifests_are_the_jax_sides_byte_for_byte(tmp_path, dataset):
    _tree(tmp_path / "audio", NAMES[dataset], np.random.default_rng(0))
    mouth_dir = "" if dataset == "wham" else str(tmp_path / "mouths")
    jax_preprocess.preprocess(dataset, str(tmp_path / "audio"), mouth_dir,
                              str(tmp_path / "jax"))
    preprocess.preprocess(dataset, str(tmp_path / "audio"), mouth_dir, str(tmp_path / "port"))
    want, got = _manifests(tmp_path / "jax"), _manifests(tmp_path / "port")
    assert len(want) == 9 and got == want


def test_cli_writes_the_same_manifests(tmp_path):
    _tree(tmp_path / "audio", NAMES["lrs3"], np.random.default_rng(1))
    args = ["--dataset", "lrs3", "--in_audio_dir", str(tmp_path / "audio"),
            "--in_mouth_dir", str(tmp_path / "mouths")]
    preprocess.main(args + ["--out_dir", str(tmp_path / "port")])
    jax_preprocess.preprocess("lrs3", str(tmp_path / "audio"), str(tmp_path / "mouths"),
                              str(tmp_path / "jax"))
    assert _manifests(tmp_path / "port") == _manifests(tmp_path / "jax")


def test_unmatched_name_raises(tmp_path):
    with pytest.raises(ValueError, match="matching failed"):
        preprocess.MOUTH_MAPPERS["vox2"]("m", "no_ids_here.wav", "s1")
