"""Ingest a published reference checkpoint into an experiment directory
(the JAX package's ``scripts/import_checkpoint.py``).

    python -m rtfs_net_tpu_torch.import_checkpoint --pth best_model.pth \
        --conf rtfs_net_tpu_torch/configs/lrs2_RTFSNet_4_layer.yaml \
        --exp-dir exp/imported_lrs2_rtfs4

Reads the reference's ``best_model.pth`` (``{model_name, state_dict,
model_args, infos}``, reference ``base_av_model.py:36-51``), a Lightning
checkpoint whose keys carry the ``audio_model.`` prefix, or a bare state
dict (``models/serialization.py:load_model``: the constructor arguments
come from the conf's ``audionet`` unless the file holds them; the weights
load strictly), and writes

    <exp-dir>/best_model.pth   this package's blob (constructor model_args)
    <exp-dir>/conf.yaml        the conf, its audionet the arguments used

so the evaluation entry point runs on it directly:

    python -m rtfs_net_tpu_torch.test --conf-dir <exp-dir>/conf.yaml --test-dir <manifests>

The video backbone is not converted here: the evaluation rebuilds it from
``conf["videonet"]`` and loads its ``pretrain`` file.
"""
import argparse
import os

import yaml


def import_checkpoint(pth_path: str, conf: dict, exp_dir: str) -> str:
    """Write ``<exp_dir>/best_model.pth`` and ``conf.yaml`` from ``pth_path``;
    returns the model's path."""
    from .models.serialization import load_model, save_model

    model, package = load_model(pth_path, device="cpu", conf=conf)
    path = os.path.join(exp_dir, "best_model.pth")
    save_model(path, "AVNet", package["model_args"], model.state_dict())
    out_conf = {**conf, "audionet": package["model_args"],
                "imported_from": {"pth": os.path.abspath(pth_path)}}
    with open(os.path.join(exp_dir, "conf.yaml"), "w") as f:
        yaml.safe_dump(out_conf, f)
    return path


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--pth", required=True,
                   help="reference best_model.pth (or Lightning checkpoint)")
    p.add_argument("--conf", required=True,
                   help="config YAML with the data/training/log sections; its audionet "
                        "section gives the constructor arguments (a published blob "
                        "holds the reflective get_config() dict instead)")
    p.add_argument("--exp-dir", required=True, help="output experiment directory")
    args = p.parse_args(argv)
    with open(args.conf) as f:
        conf = yaml.safe_load(f)
    path = import_checkpoint(args.pth, conf, args.exp_dir)
    print(f"wrote {path}")
    print("evaluate with: python -m rtfs_net_tpu_torch.test --conf-dir "
          f"{os.path.join(args.exp_dir, 'conf.yaml')} --test-dir <manifests>")
    return path


if __name__ == "__main__":
    main()
