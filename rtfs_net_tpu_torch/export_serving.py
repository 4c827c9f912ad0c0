"""Export a trained model to a serving artifact (the JAX package's
``scripts/export_serving.py``).

    python -m rtfs_net_tpu_torch.export_serving --ckpt <exp_dir>/best_model.pth \
        --out model.rtfsx [--batch-size 128 | --batch-sizes 1,8,32,128] \
        [--segment 2.0] [--dtype bfloat16|float32] [--device cuda|cpu]

The artifact is a ``torch.export`` program per batch size with the weights
inside (``rtfs_net_tpu_torch/export.py``); ``export.load_artifact`` serves
it with no model zoo, config or registry, and ``python -m
rtfs_net_tpu_torch.separate --model model.rtfsx`` separates wavs with it.
Export on the device the artifact will serve on (default ``cuda``): a
program traced on the CPU runs the depthwise convs through PyTorch's own
convolution instead of the stencil kernel, and the loader refuses to serve
it on another device type.
"""
import argparse
import os
import time


def main(argv=None):
    """Returns the artifact's path and the seconds each bucket's export took."""
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--ckpt", required=True, help="best_model.pth (models/serialization.py)")
    p.add_argument("--conf", default=None,
                   help="config YAML whose audionet section holds the constructor arguments, "
                        "for a reference file that does not hold them")
    p.add_argument("--out", default=None, help="output path (default: <ckpt dir>/model.rtfsx)")
    p.add_argument("--batch-size", type=int, default=128, help="serving batch")
    p.add_argument("--batch-sizes", default=None,
                   help="comma list (e.g. 1,8,32,128) -> bucketed artifact serving any "
                        "request batch by pad/chunk dispatch (export.load_artifact)")
    p.add_argument("--segment", type=float, default=2.0, help="utterance seconds")
    p.add_argument("--sample-rate", type=int, default=16000)
    p.add_argument("--fps", type=int, default=25, help="video fps for the mouth track")
    p.add_argument("--audio-only", action="store_true",
                   help="export the f(mix) convention (no mouth input)")
    p.add_argument("--mouth-shape", default=None,
                   help="override per-utterance mouth-embedding shape, e.g. 512,50")
    p.add_argument("--dtype", default="bfloat16", choices=["bfloat16", "float32"])
    p.add_argument("--device", default="cuda",
                   help="the device the artifact serves on: cuda (default) or cpu")
    p.add_argument("--mesh-devices", type=int, default=1,
                   help="a multi-device artifact; above 1 it raises (data parallel is "
                        "not ported yet)")
    args = p.parse_args(argv)

    import yaml

    from .export import export_serving, save_serving, save_serving_multi
    from .models import resolve_device
    from .models.serialization import load_model

    device = resolve_device(args.device)
    conf = None
    if args.conf:
        with open(args.conf) as f:
            conf = yaml.safe_load(f)
    model, package = load_model(args.ckpt, device=device, conf=conf)
    segment_samples = int(args.segment * args.sample_rate)

    mouth_shape = None
    if not args.audio_only:
        if args.mouth_shape:
            mouth_shape = tuple(int(v) for v in args.mouth_shape.split(","))
        else:
            vout = package["model_args"].get("pretrained_vout_chan", -1)
            if vout and vout > 0:
                mouth_shape = (vout, int(args.segment * args.fps))

    extra = {"model_name": package["model_name"], "sample_rate": args.sample_rate}
    out = args.out or os.path.join(os.path.dirname(os.path.abspath(args.ckpt)),
                                   "model.rtfsx")
    sizes = (sorted({int(v) for v in args.batch_sizes.split(",")}) if args.batch_sizes
             else [args.batch_size])
    programs, seconds = {}, {}
    for b in sizes:
        t0 = time.perf_counter()
        programs[b] = export_serving(model, b, segment_samples, mouth_shape=mouth_shape,
                                     compute_dtype=args.dtype, device=device,
                                     mesh_devices=args.mesh_devices)
        seconds[b] = time.perf_counter() - t0
    if args.batch_sizes:
        save_serving_multi(out, programs, segment_samples, mouth_shape=mouth_shape,
                           compute_dtype=args.dtype, extra=extra)
    else:
        save_serving(out, programs[sizes[0]], sizes[0], segment_samples,
                     mouth_shape=mouth_shape, compute_dtype=args.dtype, extra=extra)
    size = os.path.getsize(out)
    print(f"exported {out} ({size/1e6:.1f} MB, platforms={[device.type]}, "
          f"B={sizes}, L={segment_samples}, mouth={mouth_shape}, {args.dtype})")
    return out, seconds


if __name__ == "__main__":
    main()
