"""Evaluation entry point (the JAX package's root ``test.py``; reference:
``test.py``).

    python -m rtfs_net_tpu_torch.test --conf-dir <exp_dir>/conf.yaml \
        --test-dir <manifest_dir> [--device cuda|cpu]

Loads ``<exp_dir>/best_model.pth`` (a blob this package wrote, a reference
``best_model.pth`` or a Lightning checkpoint: ``models/serialization.py:
load_model``, with the conf's ``audionet`` as constructor arguments where
the file lacks them) and the video model of ``conf["videonet"]`` (its
``pretrain`` backbone loaded when that file exists), evaluates the test
set in length buckets and batches (``evaluation.run_batched_eval``),
streams per-utterance SI-SNR(i)/SDR(i)/PESQ/STOI to
``results_new/metrics.csv``, writes wav examples and a summary
``results_new/results.csv``: Model, Params (M), MACs (G, 2s), Videomodel
MACs (G, 2s), each metric's mean ± std, then the audionet conf, in the
JAX package's order. The MACs are ``utils.flops.conv_dot_macs`` over a 2 s
input (the JAX CLI reports XLA's cost analysis there, which also counts
elementwise work).

Bucketing: utterances are zero-padded to a multiple of ``--bucket-size``
samples (default 4000) and batched by padded length, ``--eval-batch-size``
at a time (default: the training batch x 2); metrics are computed on the
unpadded samples. Zero padding shifts the gLN statistics slightly, so
smaller buckets are more faithful.

Under ``torchrun --nproc_per_node=N -m rtfs_net_tpu_torch.test ...`` every
batch is sharded over the ranks (``evaluation.run_batched_eval``) and rank
0 scores and writes the results.

This module imports no torch at the top, as ``train.py``: a script that
drives ``main`` may start the port's spawned loader workers, which import
the main module again.
"""
import argparse
import csv
import os

import yaml

from .utils import parse_args_as_dict, prepare_parser_from_dict, str2bool_arg

METRIC_ORDER = ["si-snr_i", "sdr_i", "pesq", "stoi", "si-snr", "sdr"]


def summary_rows(conf, n_params, macs, video_macs, mean, std):
    """``results.csv``'s rows (root ``test.py:120-150``); ``video_macs`` is
    None without a video model."""
    rows = [("Model", conf["log"]["exp_name"]), ("Params (M)", n_params / 1e6),
            ("MACs (G, 2s)", round(macs / 1e9, 2))]
    if video_macs is not None:
        rows.append(("Videomodel MACs (G, 2s)", round(video_macs / 1e9, 2)))
    for k in sorted(mean, key=lambda k: METRIC_ORDER.index(k) if k in METRIC_ORDER else 100):
        rows.append((k, f"{round(mean[k], 4)} ± {round(std[k], 3)}"))
    for k, v in conf["audionet"].items():
        if isinstance(v, dict):
            rows.extend((f"{k}_{kk}", vv) for kk, vv in v.items())
        else:
            rows.append((k, v))
    return rows


def main(conf):
    """Evaluate as ``conf`` says; returns ``{"results": rows of results.csv,
    "eval": run_batched_eval's timings, "save_dir": ...}``."""
    import torch.distributed as dist

    from .parallel import initialize, local_device, process_info, shutdown

    main_args = conf["main_args"]
    device = main_args.get("device", "cuda")
    owns_group = not dist.is_initialized() and initialize(device)
    try:
        return _evaluate(conf, local_device(device), process_info()[0] == 0)
    finally:
        if owns_group:
            shutdown()


def _evaluate(conf, device, rank0):
    import torch

    from .datas import AVSpeechDataset
    from .evaluation import normalize_mouths, run_batched_eval
    from .losses import PITLossWrapper, pairwise_neg_sisdr
    from .metrics import ALLMetricsTracker
    from .models.serialization import load_model
    from .train import build_video_model
    from .utils.flops import conv_dot_macs, count_params

    main_args = conf["main_args"]
    exp_dir = main_args.get("exp_dir") or os.path.dirname(main_args["conf_dir"])
    model, _ = load_model(os.path.join(exp_dir, "best_model.pth"), device=device, conf=conf)
    video = build_video_model(conf, device)
    video_apply = None if video is None else (lambda m: video(normalize_mouths(m)))

    test_set = AVSpeechDataset(
        main_args["test_dir"],
        n_src=conf["data"]["nondefault_nsrc"],
        sample_rate=conf["data"]["sample_rate"],
        segment=None,
        normalize_audio=conf["data"]["normalize_audio"],
        audio_only=video is None,
        device_normalize_video=bool(main_args.get("device_normalize_video", False)),
    )
    save_dir = os.path.join(exp_dir, "results_new")
    metrics = None
    if rank0:
        os.makedirs(os.path.join(save_dir, "examples"), exist_ok=True)
        metrics = ALLMetricsTracker(save_file=os.path.join(save_dir, "metrics.csv"))
    sr = conf["data"]["sample_rate"]
    stats = run_batched_eval(
        model=model, test_set=test_set, metrics=metrics,
        loss_func=PITLossWrapper(pairwise_neg_sisdr, pit_from="pw_mtx"),
        video_apply=video_apply,
        bucket=int(main_args.get("bucket_size") or 4000),
        eval_batch_size=int(main_args.get("eval_batch_size")
                            or conf["training"]["batch_size"] * 2),
        sample_rate=sr, n_save_ex=int(main_args.get("n_save_ex", 10)),
        examples_dir=os.path.join(save_dir, "examples"),
    )
    if not rank0:
        return {"results": None, "eval": stats, "save_dir": save_dir}
    metrics.final()
    mean, std = metrics.get_mean(), metrics.get_std()
    for k in sorted(mean, key=lambda k: METRIC_ORDER.index(k) if k in METRIC_ORDER else 100):
        print(f"{k}\tmean: {round(mean[k], 4)}  std: {round(std[k], 3)}")

    # MACs over a 2 s input, as the reference's thop accounting in
    # results.csv (reference test.py:91-98, base_av_model.py:61-118)
    emb2s = None
    if video is not None:
        emb2s = torch.zeros((1, conf["audionet"].get("pretrained_vout_chan", 512), 2 * 25))
    macs = conv_dot_macs(model, torch.zeros((1, 2 * sr)), emb2s)
    video_macs = (None if video is None
                  else conv_dot_macs(video, torch.zeros((1, 1, 2 * 25, 88, 88))))
    rows = summary_rows(conf, count_params(model), macs, video_macs, mean, std)
    with open(os.path.join(save_dir, "results.csv"), "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(["Key", "Value"])
        w.writerows(rows)
    return {"results": rows, "eval": stats, "save_dir": save_dir}


def parse_conf(argv=None):
    """The experiment's conf.yaml named by ``--conf-dir``, with every flag of
    ``argv`` applied; the flags outside the YAML go to ``main_args``."""
    parser = argparse.ArgumentParser()
    parser.add_argument("--conf-dir", required=True, help="Path to the experiment conf.yaml")
    parser.add_argument("--test-dir", required=True,
                        help="Manifest dir with {mix,s1,s2}.json")
    parser.add_argument("--exp-dir", default=None)
    parser.add_argument("--n-save-ex", dest="n_save_ex", default=10, type=int)
    parser.add_argument("--bucket-size", dest="bucket_size", default=4000, type=int)
    parser.add_argument("--eval-batch-size", dest="eval_batch_size", default=None,
                        type=int, help="utterances per batch (default: training "
                                       "batch_size x 2)")
    parser.add_argument("--device-normalize-video", dest="device_normalize_video",
                        default=False, type=str2bool_arg,
                        help="ship mouth frames to the device as raw uint8 (1 byte "
                             "per pixel) and normalize them there")
    parser.add_argument("--device", default="cuda",
                        help="Device to evaluate on: cuda (default) or cpu")
    args, _ = parser.parse_known_args(argv)
    with open(args.conf_dir) as f:
        def_conf = yaml.safe_load(f)
    def_conf.pop("main_args", None)  # the training run's flags, which train.py saved
    parser = prepare_parser_from_dict(def_conf, parser=parser)
    conf = parse_args_as_dict(parser, args=argv)
    conf["main_args"]["conf_dir"] = args.conf_dir
    return conf


if __name__ == "__main__":
    main(parse_conf())
