"""Manifest builders (``data_preprocess/preprocess.py`` of the JAX side;
reference ``data-preprocess/preprocess_{lrs2,lrs3,vox2,wham}.py`` in one
module), over the port's ``datas.wavio``:

    python -m rtfs_net_tpu_torch.data_preprocess.preprocess --dataset lrs2 \\
        --in_audio_dir <audio root with tr/cv/tt> --in_mouth_dir <npz dir> \\
        --out_dir <manifest root>

Walks ``<in_audio_dir>/{tr,cv,tt}/{mix,s1,s2}`` wav dirs, pairs each
speaker wav with its mouth-ROI ``.npz`` (a mapping of file names per
dataset) and writes ``{mix,s1,s2}.json`` manifests of ``[wav_path,
(mouth_path,) n_samples]``, the format ``datas.AVSpeechDataset`` reads,
byte for byte what the JAX side writes.

Mouth IDs per dataset:
  * lrs2: the mixture file name ``<id1>_<utt1>_snr_<id2>_<utt2>_snr...``
    split on '_': s1 takes fields 0_1, s2 fields 3_4;
  * lrs3: the regex ``.{11}_\\d{5}`` matched twice;
  * vox2: the regex ``id\\d{5}_.{11}_\\d{5}`` matched twice;
  * wham: audio only, no mouth paths.

Needs no card and no torch.
"""
from __future__ import annotations

import argparse
import json
import os
import re

from ..datas import wavio


def mouth_path_lrs2(in_mouth_dir, wav_file, out_filename):
    parts = wav_file.split("_")
    idx = {"s1": (0, 1), "s2": (3, 4), "s3": (6, 7)}[out_filename]
    return os.path.join(in_mouth_dir, f"{parts[idx[0]]}_{parts[idx[1]]}.npz")


def mouth_path_regex(pattern):
    compiled = re.compile(pattern)

    def fn(in_mouth_dir, wav_file, out_filename):
        res = compiled.findall(wav_file)
        if len(res) < 2:
            raise ValueError(f"matching failed for case: {wav_file}")
        pick = res[0] if out_filename == "s1" else res[1]
        return os.path.join(in_mouth_dir, f"{pick}.npz")

    return fn


MOUTH_MAPPERS = {
    "lrs2": mouth_path_lrs2,
    "lrs3": mouth_path_regex(r".{11}_\d{5}"),
    "vox2": mouth_path_regex(r"id\d{5}_.{11}_\d{5}"),
    "wham": None,  # audio-only
}


def preprocess_one_dir(in_audio_dir, in_mouth_dir, out_dir, out_filename, mouth_mapper):
    file_infos = []
    in_dir = os.path.abspath(in_audio_dir)
    for wav_file in sorted(os.listdir(in_dir)):
        if not wav_file.endswith(".wav"):
            continue
        wav_path = os.path.join(in_dir, wav_file)
        n_samples, _, _ = wavio.info(wav_path)
        if out_filename == "mix" or mouth_mapper is None:
            file_infos.append((wav_path, n_samples))
        else:
            file_infos.append(
                (wav_path, mouth_mapper(in_mouth_dir, wav_file, out_filename), n_samples))
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, out_filename + ".json"), "w") as f:
        json.dump(file_infos, f, indent=4)
    print(f"wrote {out_dir}/{out_filename}.json ({len(file_infos)} entries)")


def preprocess(dataset, in_audio_dir, in_mouth_dir, out_dir,
               splits=("tr", "cv", "tt"), speakers=("mix", "s1", "s2")):
    mapper = MOUTH_MAPPERS[dataset]
    for split in splits:
        for spk in speakers:
            preprocess_one_dir(os.path.join(in_audio_dir, split, spk), in_mouth_dir,
                               os.path.join(out_dir, split), spk, mapper)


def main(argv=None):
    parser = argparse.ArgumentParser("AVSS manifest preprocessing")
    parser.add_argument("--dataset", choices=sorted(MOUTH_MAPPERS), required=True)
    parser.add_argument("--in_audio_dir", type=str, required=True,
                        help="Audio root containing tr/cv/tt")
    parser.add_argument("--in_mouth_dir", type=str, default="",
                        help="Mouth npz dir (omit for wham)")
    parser.add_argument("--out_dir", type=str, required=True)
    args = parser.parse_args(argv)
    preprocess(args.dataset, args.in_audio_dir, args.in_mouth_dir, args.out_dir)


if __name__ == "__main__":
    main()
