"""JAX-package variables -> the port's ``state_dict``.

The inverse of ``rtfs_net_tpu/utils/avnet_convert.py:convert_avnet`` for
the modules the port has: it reads the JAX model's variables, given as
nested dicts of numpy arrays (``params`` and ``batch_stats``), and writes
them under the reference torch names the port uses. Besides renaming:

* SRU weight columns go from the JAX [k][dir][h] order back to the
  reference's [dir][k][h];
* MHSA2D's fused qkv conv, stacked PReLU slopes and LN4D affines are
  unpacked into the per-head ``Queries/Keys/Values.{h}`` modules;
* BatchNorm statistics become ``running_mean``/``running_var``.

Each mapper takes (reader, out, src, path): ``src`` is the torch key
prefix written, ``path`` the JAX variable path read.

``video_state_dict_from_jax`` does the same for the video models: the
FRCNN video model with either trunk (the inverse of
``rtfs_net_tpu/utils/torch_convert.py:_video_key_map`` and
``_shufflenet_key_map``) and ``AEVideoModel``; ``ae_state_dict_from_jax``
for the whole lip autoencoder. ``load_video_backbone`` loads a reference
state dict of the FRCNN model, or the encoder state dict that
``train_autoencoder`` writes, into the port's.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from ..models.videomodels import AEVideoModel

Path = Tuple[str, ...]


class Reader:
    """Path lookups into JAX variables ({"params": ..., "batch_stats": ...})."""

    def __init__(self, variables):
        self.trees = {"params": variables.get("params", {}),
                      "batch_stats": variables.get("batch_stats", {})}

    def node(self, path: Path, collection: str = "params") -> Optional[Any]:
        node = self.trees[collection]
        for p in path:
            if not hasattr(node, "keys") or p not in node:
                return None
            node = node[p]
        return node

    def get(self, path: Path, collection: str = "params") -> np.ndarray:
        value = self.node(path, collection)
        if value is None:
            raise KeyError(f"JAX variable {collection}/{'/'.join(path)} is missing")
        return np.array(value)


def _k(src: str, name: str) -> str:
    return f"{src}.{name}" if src else name


def _leaf(r: Reader, out, src: str, path: Path):
    """A conv/linear: ``weight`` and, when present, ``bias``."""
    node = r.node(path)
    out[_k(src, "weight")] = r.get(path + ("weight",))
    if "bias" in node:
        out[_k(src, "bias")] = r.get(path + ("bias",))


def norm(r: Reader, out, src: str, path: Path):
    """gLN, LN4D or BatchNorm at ``path``, told apart by its variables;
    an Identity has none and writes nothing."""
    node = r.node(path)
    if node is None:
        return
    scale, bias = r.get(path + ("scale",)), r.get(path + ("bias",))
    if r.node(path + ("mean",), "batch_stats") is not None:
        out[_k(src, "weight")], out[_k(src, "bias")] = scale, bias
        out[_k(src, "running_mean")] = r.get(path + ("mean",), "batch_stats")
        out[_k(src, "running_var")] = r.get(path + ("var",), "batch_stats")
        out[_k(src, "num_batches_tracked")] = np.array(0, np.int64)
    elif scale.ndim == 4:
        out[_k(src, "gamma")], out[_k(src, "beta")] = scale, bias
    else:
        out[_k(src, "norm.weight")], out[_k(src, "norm.bias")] = scale, bias


def _alpha(r: Reader, out, key: str, path: Path):
    if r.node(path) is not None:
        out[key] = r.get(path + ("alpha",))


def conv_norm_act(r: Reader, out, src: str, path: Path):
    base = _k(src, "full_layer")
    norm(r, out, f"{base}.0", path + ("pre_norm",))
    _alpha(r, out, f"{base}.1.weight", path + ("pre_act",))
    if r.node(path + ("conv",)) is not None:
        _leaf(r, out, f"{base}.2", path + ("conv",))
    norm(r, out, f"{base}.3", path + ("norm",))
    _alpha(r, out, f"{base}.4.weight", path + ("act",))


def conv_act_norm(r: Reader, out, src: str, path: Path):
    if r.node(path + ("conv",)) is not None:
        _leaf(r, out, _k(src, "conv"), path + ("conv",))
    _alpha(r, out, _k(src, "act.weight"), path + ("act",))
    norm(r, out, _k(src, "norm"), path + ("norm",))


def injection_multi_sum(r: Reader, out, src: str, path: Path):
    for name in ("local_embedding", "global_embedding", "global_gate"):
        conv_norm_act(r, out, _k(src, name), path + (name,))


def sru(r: Reader, out, src: str, path: Path, hid_chan: int, bidirectional: bool):
    """SRU layers: weight columns [k][dir][h] -> the reference's [dir][k][h]."""
    ndir = 2 if bidirectional else 1
    l = 0
    while r.node(path + (f"weight_l{l}",)) is not None:
        w = r.get(path + (f"weight_l{l}",))
        d_in, cols = w.shape
        k = cols // (ndir * hid_chan)
        pre = _k(src, f"rnn_lst.{l}")
        out[f"{pre}.weight"] = (w.reshape(d_in, k, ndir, hid_chan)
                                .transpose(0, 2, 1, 3).reshape(d_in, cols))
        out[f"{pre}.weight_c"] = r.get(path + (f"weight_c_l{l}",))
        out[f"{pre}.bias"] = r.get(path + (f"bias_l{l}",))
        l += 1


def dual_path_rnn(r: Reader, out, src: str, path: Path, hid_chan: int,
                  bidirectional: bool = True):
    norm(r, out, _k(src, "norm"), path + ("norm",))
    sru(r, out, _k(src, "rnn"), path + ("rnn",), hid_chan, bidirectional)
    _leaf(r, out, _k(src, "linear"), path + ("linear",))


def mhsa(r: Reader, out, src: str, path: Path):
    for name in ("norm1", "norm2"):
        out[_k(src, f"{name}.weight")] = r.get(path + (name, "scale"))
        out[_k(src, f"{name}.bias")] = r.get(path + (name, "bias"))
    att = path + ("attention",)
    out[_k(src, "attention.in_proj_weight")] = r.get(att + ("in_proj_weight",))
    out[_k(src, "attention.in_proj_bias")] = r.get(att + ("in_proj_bias",))
    _leaf(r, out, _k(src, "attention.out_proj"), att + ("out_proj",))


def mhsa2d(r: Reader, out, src: str, path: Path):
    """Unpack the fused qkv conv ([all Q heads][all K][all V] along its
    out-channels) and the (H, ...) stacked slopes and LN4D affines."""
    n_head = r.get(path + ("q_alpha",)).shape[0]
    w = r.get(path + ("qkv_conv", "weight"))
    b = r.get(path + ("qkv_conv", "bias"))
    offset = 0
    for group, name in (("Queries", "q"), ("Keys", "k"), ("Values", "v")):
        scale = r.get(path + (f"{name}_scale",))  # (H, chan, 1, F)
        alpha = r.get(path + (f"{name}_alpha",))
        beta = r.get(path + (f"{name}_bias",))
        chan = scale.shape[1]
        for h in range(n_head):
            pre = _k(src, f"{group}.{h}")
            out[f"{pre}.conv.weight"] = w[offset:offset + chan]
            out[f"{pre}.conv.bias"] = b[offset:offset + chan]
            out[f"{pre}.act.weight"] = alpha[h:h + 1]
            out[f"{pre}.norm.gamma"] = scale[h][None]
            out[f"{pre}.norm.beta"] = beta[h][None]
            offset += chan
    conv_act_norm(r, out, _k(src, "attn_concat_proj"), path + ("attn_concat_proj",))


def ffn(r: Reader, out, src: str, path: Path):
    for i, name in enumerate(("encoder", "refiner", "decoder")):
        conv_norm_act(r, out, _k(src, name), path + (f"ConvNormAct_{i}",))


def global_attention(r: Reader, out, src: str, path: Path):
    mhsa(r, out, _k(src, "MHSA"), path + ("MHSA",))
    ffn(r, out, _k(src, "FFN"), path + ("FFN",))


def attn_fusion_cell(r: Reader, out, src: str, path: Path):
    for name in ("key_embed", "value_embed", "attention_embed", "resize"):
        conv_norm_act(r, out, _k(src, name), path + (name,))


def _global_layer(r: Reader, out, src: str, path: Path, conf: dict):
    lt = conf["layer_type"]
    if lt == "DualPathRNN":
        dual_path_rnn(r, out, src, path, conf["hid_chan"], conf.get("bidirectional", True))
    elif lt == "MultiHeadSelfAttention2D":
        mhsa2d(r, out, src, path)
    elif lt == "GlobalAttention":
        global_attention(r, out, src, path)
    else:
        raise NotImplementedError(f"layer_type {lt!r} is not ported yet")


def tdanet_block(r: Reader, out, src: str, path: Path, conf: dict):
    depth = conf.get("upsampling_depth", 4)
    conv_norm_act(r, out, _k(src, "gateway"), path + ("gateway",))
    conv_norm_act(r, out, _k(src, "projection"), path + ("projection",))
    for i in range(depth):
        conv_norm_act(r, out, _k(src, f"downsample_layers.{i}"), path + (f"down{i}",))
        injection_multi_sum(r, out, _k(src, f"fusion_layers.{i}"), path + (f"fuse{i}",))
    for i in range(depth - 1):
        injection_multi_sum(r, out, _k(src, f"concat_layers.{i}"), path + (f"concat{i}",))
    for j, lconf in enumerate((conf.get("layers") or {}).values()):
        _global_layer(r, out, _k(src, f"globalatt.{j}"), path + (f"globalatt{j}",), lconf)
    conv_norm_act(r, out, _k(src, "residual_conv"), path + ("residual_conv",))


def frcnn_block(r: Reader, out, src: str, path: Path, conf: dict):
    depth = conf.get("upsampling_depth", 4)
    conv_norm_act(r, out, _k(src, "gateway"), path + ("gateway",))
    conv_norm_act(r, out, _k(src, "projection"), path + ("projection",))
    for i in range(depth):
        conv_norm_act(r, out, _k(src, f"downsample_layers.{i}"), path + (f"down{i}",))
        if i >= 1:
            conv_norm_act(r, out, _k(src, f"fusion_layers.{i}.0"), path + (f"lateral{i}",))
        conv_norm_act(r, out, _k(src, f"concat_layers.{i}"), path + (f"concat{i}",))
    for i in range(2):
        conv_norm_act(r, out, _k(src, f"residual_conv.{i}"), path + (f"residual_conv{i}",))


_BLOCKS = {"TDANet": tdanet_block, "FRCNN": frcnn_block}


def separator(r: Reader, out, src: str, path: Path, params: dict, which: str):
    net = params.get(f"{which}_net")
    if not net:
        return
    if net not in _BLOCKS:
        raise NotImplementedError(f"{which}_net {net!r} is not ported yet")
    if params.get("hid_chan", -1) <= 0:
        return  # no blocks: every repeat is the identity
    block = _BLOCKS[net]
    if params.get("shared", False):
        block(r, out, _k(src, "blocks"), path + ("blocks",), params)
    else:
        for i in range(params.get("repeats", 1)):
            block(r, out, _k(src, f"blocks.{i}"), path + (f"blocks_{i}",), params)


def gated_fusion_cell(r: Reader, out, src: str, path: Path):
    """ConvLSTMFusionCell or ConvGRUFusionCell."""
    for name in ("conv_a", "conv_b"):
        conv_norm_act(r, out, _k(src, name), path + (name,))


# fusion type -> its modules as (torch name, JAX name, mapper): those every
# block has, and those only blocks with video fusion (not the last repeat)
# have. The reference names every cell fusion's cells audio_lstm/video_lstm;
# SumFusion's audio_conv maps audio to video.
_FUSION_MODULES = {
    "ATTNFusion": ([("audio_lstm", "audio_attn", attn_fusion_cell)],
                   [("video_lstm", "video_attn", attn_fusion_cell)]),
    "ConcatFusion": ([("audio_conv", "audio_conv", conv_norm_act)],
                     [("video_conv", "video_conv", conv_norm_act)]),
    "SumFusion": ([("video_conv", "video_conv", conv_norm_act)],
                  [("audio_conv", "audio_conv", conv_norm_act)]),
    "InjectionFusion": ([("video_conv", "video_conv", conv_norm_act),
                         ("audio_inj", "audio_inj", injection_multi_sum)],
                        [("audio_conv", "audio_conv", conv_norm_act),
                         ("video_inj", "video_inj", injection_multi_sum)]),
    "LSTMFusion": ([("audio_lstm", "audio_lstm", gated_fusion_cell)],
                   [("video_lstm", "video_lstm", gated_fusion_cell)]),
    "GRUFusion": ([("audio_lstm", "audio_gru", gated_fusion_cell)],
                  [("video_lstm", "video_gru", gated_fusion_cell)]),
}


def fusion_block(r: Reader, out, src: str, path: Path, ftype: str):
    """One fusion block of type ``ftype``."""
    always, video_side = _FUSION_MODULES[ftype]
    present = [m for m in video_side if r.node(path + (m[1],)) is not None]
    for ours, theirs, mapper in always + present:
        mapper(r, out, _k(src, ours), path + (theirs,))


def fusion(r: Reader, out, src: str, path: Path, fusion_params: dict, repeats: int):
    """MultiModalFusion's blocks, shared or one per repeat."""
    if repeats <= 0:
        return
    ftype = fusion_params.get("fusion_type", "ConcatFusion")
    if fusion_params.get("fusion_shared", False):
        fusion_block(r, out, _k(src, "fusion_module"), path + ("fusion_module",), ftype)
    else:
        for i in range(repeats):
            fusion_block(r, out, _k(src, f"fusion_module.{i}"),
                         path + (f"fusion_module_{i}",), ftype)


def mask_generator(r: Reader, out, src: str, path: Path, mg_type: Optional[str] = None):
    """MaskGenerator (no weights with ``direct``) or, with ``mg_type``
    "MaskGenerator2Chan", that one: the ``mask_generator`` Sequential's
    PReLU and conv, and the output gate's ``output`` and ``gate``."""
    if r.node(path + ("prelu",)) is None:
        return
    out[_k(src, "mask_generator.0.weight")] = r.get(path + ("prelu", "alpha"))
    if mg_type == "MaskGenerator2Chan":
        _leaf(r, out, _k(src, "mask_generator.1"), path + ("deconv",))
    else:
        conv_norm_act(r, out, _k(src, "mask_generator.1"), path + ("mask_conv",))
    for name in ("output", "gate"):
        if r.node(path + (name,)) is not None:
            conv_norm_act(r, out, _k(src, name), path + (name,))


def conv_encoder(r: Reader, out, src: str, path: Path, layers: int = 1):
    """ConvolutionalEncoder: JAX ``branch{i}`` -> ``encoder.{i}``."""
    for i in range(layers):
        conv_norm_act(r, out, _k(src, f"encoder.{i}"), path + (f"branch{i}",))


def state_dict_from_jax(variables, audionet_conf: dict) -> Dict[str, torch.Tensor]:
    """JAX AVNet variables + its config (the YAML file or its ``audionet``
    section) -> the port AVNet's ``state_dict``."""
    conf = audionet_conf.get("audionet", audionet_conf)
    r, out = Reader(variables), {}
    enc = conf["enc_dec_params"]
    if enc["encoder_type"] == "STFTEncoder":
        conv_norm_act(r, out, "encoder.conv", ("encoder", "conv"))
    else:
        conv_encoder(r, out, "encoder", ("encoder",), enc.get("layers", 1))
    conv_norm_act(r, out, "audio_bottleneck", ("audio_bottleneck",))
    conv_norm_act(r, out, "video_bottleneck", ("video_bottleneck",))
    ap, vp = conf["audio_params"], conf.get("video_params") or {}
    rm = ("refinement_module",)
    separator(r, out, "refinement_module.audio_net", rm + ("audio_net",), ap, "audio")
    separator(r, out, "refinement_module.video_net", rm + ("video_net",), vp, "video")
    fusion(r, out, "refinement_module.crossmodal_fusion", rm + ("crossmodal_fusion",),
           conf.get("fusion_params") or {}, vp.get("repeats", 0))
    mask_generator(r, out, "mask_generator", ("mask_generator",),
                   (conf.get("mask_generation_params") or {}).get("mask_generator_type"))
    if r.node(("decoder", "decoder")) is not None:
        _leaf(r, out, "decoder.decoder", ("decoder", "decoder"))
    return to_tensors(out)


def _conv_bn(r: Reader, out, conv_key: str, bn_key: str, path: Path):
    out[f"{conv_key}.weight"] = r.get(path + ("conv", "weight"))
    norm(r, out, bn_key, path + ("bn",))


# ShuffleNet block sub-module -> (branch, Sequential index of its conv, of
# its BatchNorm) (``_shufflenet_key_map``)
_SHUFFLE_BRANCHES = {"b1_dw": ("banch1", 0, 1), "b1_pwl": ("banch1", 2, 3),
                     "b2_pw": ("banch2", 0, 1), "b2_dw": ("banch2", 3, 4),
                     "b2_pwl": ("banch2", 5, 6)}


def _resnet_trunk(r: Reader, out):
    for name in sorted(r.node(("trunk",))):  # layer{1-4}_{block}
        layer, block = name[len("layer"):].split("_")
        pre, path = f"trunk.layer{layer}.{block}", ("trunk", name)
        _conv_bn(r, out, f"{pre}.conv1", f"{pre}.bn1", path + ("cbn1",))
        _conv_bn(r, out, f"{pre}.conv2", f"{pre}.bn2", path + ("cbn2",))
        _alpha(r, out, f"{pre}.relu1.weight", path + ("relu1",))
        _alpha(r, out, f"{pre}.relu2.weight", path + ("relu2",))
        if r.node(path + ("downsample",)) is not None:
            _conv_bn(r, out, f"{pre}.downsample.0", f"{pre}.downsample.1",
                     path + ("downsample",))


def _shufflenet_trunk(r: Reader, out):
    for name in r.node(("trunk",)):  # features{idx}, conv_last
        path = ("trunk", name)
        if name == "conv_last":
            _conv_bn(r, out, "trunk.1.0", "trunk.1.1", path)
            continue
        pre = f"trunk.0.{name[len('features'):]}"
        for sub in r.node(path):
            branch, conv, bn = _SHUFFLE_BRANCHES[sub]
            _conv_bn(r, out, f"{pre}.{branch}.{conv}", f"{pre}.{branch}.{bn}", path + (sub,))


def ae_blocks(r: Reader, out, src: str, path: Path):
    """EncoderAE or DecoderAE: ``layer{i}.conv`` and ``layer{i}.norm`` (JAX
    ``scale`` -> ``weight``)."""
    for name in r.node(path):
        pre = _k(src, name)
        _leaf(r, out, f"{pre}.conv", path + (name, "conv"))
        out[f"{pre}.norm.weight"] = r.get(path + (name, "norm", "scale"))
        out[f"{pre}.norm.bias"] = r.get(path + (name, "norm", "bias"))


def video_state_dict_from_jax(variables) -> Dict[str, torch.Tensor]:
    """JAX ``FRCNNVideoModel`` variables (resnet or shufflenet trunk) or
    ``AEVideoModel`` variables -> the port model's ``state_dict``, under
    the reference's names."""
    r, out = Reader(variables), {}
    if r.node(("encoder",)) is not None:
        ae_blocks(r, out, "encoder", ("encoder",))
        return to_tensors(out)
    out["frontend3D.0.weight"] = r.get(("frontend_conv", "weight"))
    norm(r, out, "frontend3D.1", ("frontend_bn",))
    _alpha(r, out, "frontend3D.2.weight", ("frontend_prelu",))
    if r.node(("trunk", "conv_last")) is not None:
        _shufflenet_trunk(r, out)
    else:
        _resnet_trunk(r, out)
    return to_tensors(out)


def ae_state_dict_from_jax(variables) -> Dict[str, torch.Tensor]:
    """JAX ``AE`` variables -> the port ``AE``'s ``state_dict``."""
    r, out = Reader(variables), {}
    for half in ("encoder", "decoder"):
        ae_blocks(r, out, half, (half,))
    return to_tensors(out)


def load_video_backbone(model: torch.nn.Module, state_dict) -> torch.nn.Module:
    """Load a reference ``FRCNNVideoModel`` state dict (the mapping itself,
    or a checkpoint that holds it under ``model_state_dict``), with either
    trunk, into the port's model; or, into an ``AEVideoModel``, the
    encoder's own state dict (``layer{i}.*``, as ``train_autoencoder``
    writes it) or the whole model's. The lip-reading head's ``tcn*`` keys and
    the ``num_batches_tracked`` counters are skipped, as the reference loader
    and ``torch_convert.convert_video_backbone`` skip them; any other key the
    model lacks, a shape that differs, or a model tensor left without a
    value raises."""
    state_dict = state_dict.get("model_state_dict", state_dict)
    if isinstance(model, AEVideoModel) and not any(k.startswith("encoder.")
                                                   for k in state_dict):
        state_dict = {f"encoder.{k}": v for k, v in state_dict.items()}
    own = model.state_dict()
    picked = {}
    for key, value in state_dict.items():
        if key.startswith("tcn") or key.endswith("num_batches_tracked"):
            continue
        if key not in own:
            raise KeyError(f"{key}: the video model has no such tensor")
        value = torch.as_tensor(value)
        if tuple(value.shape) != tuple(own[key].shape):
            raise ValueError(f"{key}: shape {tuple(value.shape)} != the model's "
                             f"{tuple(own[key].shape)}")
        picked[key] = value
    missing = [k for k in own if k not in picked and not k.endswith("num_batches_tracked")]
    if missing:
        raise KeyError(f"the state dict lacks {missing}")
    model.load_state_dict(picked, strict=False)
    return model


_BUFFERS = ("running_mean", "running_var", "num_batches_tracked")


def grads_from_jax(grads, audionet_conf: dict, batch_stats=None) -> Dict[str, torch.Tensor]:
    """The gradients of a JAX step (a ``params`` pytree of numpy arrays)
    under the port's parameter names. Every mapping is a renaming, a
    permutation or a slice, so it carries gradients as it carries
    parameters; ``batch_stats`` (the model's) only tells BatchNorms apart."""
    sd = state_dict_from_jax({"params": grads, "batch_stats": batch_stats or {}},
                             audionet_conf)
    return {k: t for k, t in sd.items() if k.rsplit(".", 1)[-1] not in _BUFFERS}


def to_tensors(arrays: Dict[str, np.ndarray]) -> Dict[str, torch.Tensor]:
    return {k: torch.from_numpy(np.array(v)) for k, v in arrays.items()}


def module_state_dict(mapper, variables, *args) -> Dict[str, torch.Tensor]:
    """One module's state_dict: ``mapper`` (a function above) applied at the
    root of that module's own JAX variables."""
    out = {}
    mapper(Reader(variables), out, "", (), *args)
    return to_tensors(out)
