"""Separation entry point (the JAX package's root ``separate.py``; reference:
the ``separate()`` helper, ``src/utils/separator.py:22-68``, as a CLI).

    python -m rtfs_net_tpu_torch.separate --model <exp_dir>/best_model.pth \
        --input mix.wav [--mouth mouth.npz --videonet-conf conf.yaml] \
        [--conf conf.yaml] [--output out_dir/] [--chunk-seconds 2] [--bf16] \
        [--device cuda|cpu]

Loads a model (a ``best_model.pth`` this package wrote, or a reference
file with ``--conf`` for its constructor arguments), separates one wav,
optionally conditioned on a mouth-ROI npz (through the ``val`` frame
pipeline and the video model of the ``videonet`` block of
``--videonet-conf``), rescales the output's energy to the input's and
writes ``<stem>_s{i}.wav``.

``--chunk-seconds`` is the long-form mode: 50%-overlap chunks of that
length (``utils.features.split_feature``) run as one batch and are merged
with the halved overlap-add. With ``--mouth``, the video model embeds the
whole track once and each chunk takes the embedding's frames of its own
span (chunks of an even number of 25 fps frames); the JAX CLI chunks
audio-only models only.

``--model`` also takes a serving artifact (``model.rtfsx`` from ``python -m
rtfs_net_tpu_torch.export_serving``), as the JAX CLI does: no model zoo or
config is read for it. Inputs pad to its exported segment; a longer input
needs ``--chunk-seconds`` equal to that segment. With ``--mouth`` the video
model still runs eagerly and its embedding, zero-padded to the artifact's
frames, is the artifact's second input; a mouth input that its calling
convention does not take, or a longer track, is refused.
"""
import argparse
import os

import numpy as np
import yaml

FPS = 25


def _chunk_embedding(emb, n_chunks: int, block: int, sample_rate: int):
    """(1, C, T_v) lip embedding -> (n_chunks, C, block's frames): chunk j
    covers the frames of audio chunk j, which starts half a block before
    sample j * block / 2; frames outside the track are zero."""
    import torch.nn.functional as F

    frames = block * FPS / sample_rate
    if frames != int(frames) or int(frames) % 2:
        raise SystemExit(f"--chunk-seconds with --mouth needs chunks of an even number of "
                         f"{FPS} fps frames; {block / sample_rate:g} s is {frames:g}")
    frames = int(frames)
    hop = frames // 2
    need = (n_chunks - 1) * hop + frames
    emb = F.pad(emb, (hop, max(0, need - hop - emb.shape[-1])))
    return emb[0].unfold(-1, frames, hop)[:, :n_chunks].permute(1, 0, 2)


def _artifact_model(artifact):
    """The artifact as ``separate()``'s model: (mix, embedding) tensors in,
    its float32 output as a tensor on the mixture's device."""
    import torch

    def forward(mix, emb=None):
        return torch.from_numpy(artifact(mix, emb)).to(mix.device)

    return forward


def main(args):
    import torch

    from .datas import wavio
    from .datas.transform import get_preprocessing_pipelines
    from .models import resolve_device
    from .models.serialization import load_model
    from .train import build_video_model
    from .utils.features import merge_feature, split_feature
    from .utils.separator import separate

    device = resolve_device(args.device)
    artifact = None
    if args.model.endswith(".rtfsx"):
        # a serving artifact: pinned shapes, weights inside; inputs pad to its segment
        from .export import load_artifact

        artifact = load_artifact(args.model, device=device)
        model = _artifact_model(artifact)
        dtype = torch.float32  # the artifact casts to its own compute dtype
    else:
        conf = None
        if args.conf:
            with open(args.conf) as f:
                conf = yaml.safe_load(f)
        model, _ = load_model(args.model, device=device, conf=conf)
        dtype = torch.bfloat16 if args.bf16 else torch.float32
    wav, sr = wavio.read(args.input)
    L = wav.shape[-1]
    chunk = args.chunk_seconds or 0
    if artifact is not None:
        bucket = int(artifact.header["segment_samples"])
        if L > bucket and not chunk:
            raise SystemExit(
                f"input ({L} samples) exceeds the artifact's exported "
                f"segment ({bucket}); use --chunk-seconds for long-form")
    else:
        bucket = max(1, args.bucket_size)

    video = frames = None
    if args.mouth:
        videonet = {}
        if args.videonet_conf:
            with open(args.videonet_conf) as f:
                videonet = (yaml.safe_load(f) or {}).get("videonet") or {}
        if not videonet.get("model_name"):
            raise SystemExit("--mouth given but no videonet config; pass "
                             "--videonet-conf with a videonet: block")
        video = build_video_model({"videonet": videonet, "main_args": {}}, device)
        frames = get_preprocessing_pipelines()["val"](np.load(args.mouth)["data"])
        frames = frames.astype(np.float32)[None, None]  # (1, 1, T_v, 88, 88)

    emb = None
    if artifact is not None:
        mouth_shape = artifact.header.get("mouth_shape")
        if (video is None) != (mouth_shape is None):
            raise SystemExit(
                "artifact calling convention is "
                f"{artifact.header['calling_convention']!r} but "
                f"{'no ' if video is None else ''}mouth input was given")
        if video is not None:
            # the video model runs eagerly; its embedding is the artifact's input
            with torch.inference_mode():
                emb = video(torch.from_numpy(frames).to(device)).float()
            tv, cur = int(mouth_shape[-1]), emb.shape[-1]
            if cur > tv:
                raise SystemExit(f"mouth track ({cur} frames) exceeds the "
                                 f"artifact's exported {tv}")
            video = None

    if chunk > 0:
        block = int(chunk * sr)
        if artifact is not None and block != bucket:
            raise SystemExit(
                f"--chunk-seconds must match the artifact's exported "
                f"segment: {bucket / sr:g} s ({bucket} samples)")
        blocks, rest = split_feature(torch.from_numpy(wav)[None, None], block)
        batch = blocks[0, 0].t().contiguous()  # (n_chunks, block)
        third = None
        if video is not None:
            with torch.inference_mode():
                emb = video(torch.from_numpy(frames).to(device, dtype)).float()
        if emb is not None:
            third = _chunk_embedding(emb, batch.shape[0], block, sr)
        est = separate(model, batch, third, device=device, dtype=dtype)
        est = merge_feature(est.permute(1, 2, 0)[None], rest) * 0.5
        est = est[0, :, :L].cpu().numpy()
    else:
        mix = np.pad(wav, (0, -(-L // bucket) * bucket - L))[None]
        if emb is not None:  # pad the track to the artifact's frames
            emb = torch.nn.functional.pad(emb, (0, int(mouth_shape[-1]) - emb.shape[-1]))
        est = separate(model, mix, frames if video is not None else emb, video_model=video,
                       device=device, dtype=dtype)[0][:, :L]

    out_dir = args.output or os.path.dirname(os.path.abspath(args.input))
    os.makedirs(out_dir, exist_ok=True)
    stem = os.path.splitext(os.path.basename(args.input))[0]
    paths = []
    for i in range(est.shape[0]):
        paths.append(os.path.join(out_dir, f"{stem}_s{i + 1}.wav"))
        wavio.write(paths[-1], est[i], sr)
        print(f"wrote {paths[-1]}")
    return paths


def parse_args(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--model", required=True,
                   help="best_model.pth path, or a .rtfsx serving artifact")
    p.add_argument("--conf", default=None,
                   help="config YAML whose audionet section holds the constructor "
                        "arguments, for a reference best_model.pth or Lightning "
                        "checkpoint (a blob this package wrote holds them)")
    p.add_argument("--input", required=True, help="mixture wav")
    p.add_argument("--mouth", default=None, help="mouth-ROI npz of the target speaker")
    p.add_argument("--videonet-conf", default=None,
                   help="YAML with a videonet: block (e.g. the experiment conf.yaml)")
    p.add_argument("--output", default=None, help="output dir")
    p.add_argument("--bucket-size", type=int, default=4000)
    p.add_argument("--chunk-seconds", type=float, default=0,
                   help="long-form mode: separate 50%%-overlap chunks of this length "
                        "as one batch and overlap-add")
    p.add_argument("--bf16", action="store_true",
                   help="serving precision (an artifact carries its own)")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    return p.parse_args(argv)


if __name__ == "__main__":
    main(parse_args())
