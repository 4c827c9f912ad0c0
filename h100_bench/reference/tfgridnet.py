"""Plain PyTorch reference of TF-GridNet (arXiv:2211.12433) in AVNet: the
STFT encoder and decoder, six grid blocks (an intra-frame BLSTM over F on
unfolded windows, a sub-band BLSTM over T, full-band self-attention over T)
and RTFS-Net-4's audio-visual part (the FRCNN video model, the video TDANet,
CAF fusion after the first block), as the configuration's YAML gives them.

``model.py`` holds the blocks this shares with RTFS-Net (norms, the
attention, the video side, the codec); this module adds the bidirectional
LSTM, written out from its equations rather than called from PyTorch, the
grid block and the AVNet around them (``model.separator`` knows no
TF-GridNet). Parameter names follow the port's state dict: the LSTM's are
``nn.LSTM``'s (``rnn.weight_ih_l0``, ``rnn.weight_hh_l0_reverse``, ...).
"""
from __future__ import annotations

import torch
from torch import nn

from . import model
from .model import matmul


class LSTM(nn.Module):
    """One bidirectional (or forward) LSTM layer with ``nn.LSTM``'s
    parameters: gate rows i, f, g, o, both biases. x (L, rows, d_in) ->
    (L, rows, ndir·H): every step's input projection in one matmul, then
    the recurrence step by step from h = c = 0, the reverse direction from
    the last step."""

    def __init__(self, d_in, H, bidirectional):
        super().__init__()
        self.H = H
        self.suffixes = ("_l0", "_l0_reverse") if bidirectional else ("_l0",)
        for sfx in self.suffixes:
            for name, shape in (("weight_ih", (4 * H, d_in)), ("weight_hh", (4 * H, H)),
                                ("bias_ih", (4 * H,)), ("bias_hh", (4 * H,))):
                self.register_parameter(name + sfx, nn.Parameter(torch.empty(shape)))

    def forward(self, x):
        L, rows, _ = x.shape
        outs = []
        for sfx in self.suffixes:
            w_hh = getattr(self, "weight_hh" + sfx).t()
            gates_x = (matmul(x, getattr(self, "weight_ih" + sfx).t())
                       + getattr(self, "bias_ih" + sfx) + getattr(self, "bias_hh" + sfx))
            h = c = torch.zeros((rows, self.H), dtype=x.dtype, device=x.device)
            hs = [None] * L
            for t in (range(L) if sfx == "_l0" else range(L - 1, -1, -1)):
                i, f, g, o = (gates_x[t] + matmul(h, w_hh)).chunk(4, dim=-1)
                c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
                h = torch.sigmoid(o) * torch.tanh(c)
                hs[t] = h
            outs.append(torch.stack(hs))
        return torch.cat(outs, dim=-1)


class DualPathLSTM(model.DualPathRNN):
    """``model.DualPathRNN`` with the LSTM in the SRU's place: LayerNorm over
    C, k-wide windows along one axis (dim 4: F, dim 3: T) at stride s, the
    BLSTM over the windows with the other axis in the batch, a
    ConvTranspose1d overlap-add back to C channels, the residual."""

    def __init__(self, in_chan, hid_chan, dim, kernel_size=8, stride=1, num_layers=1,
                 norm_type="LayerNormalization4D", bidirectional=True, **_):
        nn.Module.__init__(self)
        assert num_layers == 1, "the reference holds one LSTM layer"
        self.dim, self.k, self.s = dim, kernel_size, stride
        self.norm = model.make_norm(norm_type, in_chan, 1)
        self.rnn = LSTM(in_chan * kernel_size, hid_chan, bidirectional)
        self.linear = model.ConvTranspose(hid_chan * (2 if bidirectional else 1), in_chan,
                                          kernel_size, 1, stride)


def layer(in_chan, conf):
    kw = {k: v for k, v in conf.items() if k != "layer_type"}
    if conf["layer_type"] == "DualPathRNN" and conf.get("rnn_type") == "LSTM":
        return DualPathLSTM(in_chan=in_chan, **kw)
    return model.LAYERS[conf["layer_type"]](in_chan=in_chan, **kw)


class TFGridNetBlock(nn.Module):
    """The configuration's layers in order, each with its own residual; no
    conv around them."""

    def __init__(self, in_chan, layers):
        super().__init__()
        self.layers = nn.Sequential(*(layer(in_chan, c) for c in layers.values()))

    def forward(self, x):
        return self.layers(x)


class RefinementModule(model.RefinementModule):
    """``model.RefinementModule``'s loop over TF-GridNet blocks: block i > 0
    adds the module's input, the video block and fusion follow the first."""

    def __init__(self, audio_params, video_params, ca, cv, fusion_params):
        nn.Module.__init__(self)
        assert audio_params["audio_net"] == "TFGridNet"
        self.fusion_repeats = video_params["repeats"]
        self.repeats = audio_params["repeats"]
        self.audio_net = model.Repeated(lambda: TFGridNetBlock(ca, audio_params["layers"]),
                                        self.repeats, audio_params.get("shared", False))
        self.video_net = model.separator(video_params, cv)
        fkw = {k: fusion_params[k] for k in ("kernel_size", "fusion_type", "fusion_shared",
                                             "is2d") if k in fusion_params}
        self.crossmodal_fusion = model.MultiModalFusion(ca, cv,
                                                        fusion_repeats=self.fusion_repeats, **fkw)


class DirectMask(nn.Module):
    """``MaskGenerator(direct=true)``: the refined features themselves go to
    the decoder; no weights."""

    def forward(self, refined, emb):
        return refined


class AVNet(model.AVNet):
    """``model.AVNet``'s forward: STFT encoder, bottlenecks, the refinement,
    the mask generator, STFT decoder."""

    def __init__(self, n_src, enc_dec_params, audio_bn_params, audio_params,
                 mask_generation_params, pretrained_vout_chan, video_bn_params, video_params,
                 fusion_params, **_):
        nn.Module.__init__(self)
        assert n_src == 1, "the reference separates one target"
        e = dict(enc_dec_params)
        assert (e["encoder_type"], e["decoder_type"]) == ("STFTEncoder", "STFTDecoder")
        self.encoder = model.STFTEncoder(**e)
        n = e["out_chan"]
        ca = audio_bn_params.get("out_chan", n)
        cv = video_bn_params.get("out_chan", pretrained_vout_chan)
        self.audio_bottleneck = model.ConvNormAct(**{**audio_bn_params, "in_chan": n,
                                                     "out_chan": ca})
        self.video_bottleneck = model.ConvNormAct(**{**video_bn_params,
                                                     "in_chan": pretrained_vout_chan})
        self.refinement_module = RefinementModule(audio_params, video_params, ca, cv,
                                                  fusion_params)
        self.mask_generator = (DirectMask() if mask_generation_params.get("direct") else
                               model.MaskGenerator(n_src, n, ca, **mask_generation_params))
        self.decoder = model.STFTDecoder(in_chan=n, **e)


# model.py's rules; the LSTM's tensors take weights.py's defaults: weight_ih
# U(±1/√(C·k)), weight_hh U(±1/√H) (a matrix's fan-in), both biases ±0.1
# (vectors beside no module weight)
INIT = model.INIT


def build(conf):
    """(AVNet, video model) of a TF-GridNet YAML config, parameters uninitialised."""
    return AVNet(**conf["audionet"]), model.FRCNNVideoModel(**conf["videonet"])
