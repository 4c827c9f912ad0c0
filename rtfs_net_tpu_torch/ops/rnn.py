"""Multi-layer (bi)directional SRU, sru==2.6.0 v2 cell semantics
(reference ``src/models/layers/rnn_layers.py:99``):

    f_t = σ(U¹_t + v_f⊙c_{t−1} + b_f),  r_t = σ(U²_t + v_r⊙c_{t−1} + b_r)
    c_t = f_t⊙c_{t−1} + (1−f_t)⊙U⁰_t,   h_t = r_t⊙c_t + (1−r_t)⊙skip_t

with a 4-chunk projection (the 4th chunk is the highway input) when
d_in != out, else 3 chunks and the raw input as highway.

Two routes, named as in the JAX package (``SRU(backend=...)``, default
``DEFAULT_SRU_BACKEND``):

* ``"scan"``: every layer runs in the (L, channels, rows) orientation the
  layer kernels take (``ops/kernels/sru.py`` for inference,
  ``sru_train.py`` when autograd records): the projections emit
  (L, k·O, rows) directly and each layer's (L, O, rows) output feeds the
  next projection as is. ``SRU.forward_windows`` is its inference entry
  for an input already in that orientation, (S, C, rows), which the SRU
  DualPathRNN gives it.
* ``"pallas"``: the per-direction route on the (L, rows, H) layout. Each
  layer's projection is a matmul into (L, rows, k, O), each direction one
  call of ``ops/kernels/sru_direction.py`` on slices of it, the outputs
  concatenated. Inference only: under autograd it raises.

Parameters keep the reference's layout, ``rnn_lst.{l}.weight``
(d_in, ndir·k·H) with columns [dir][k][h]; they are reordered to the
kernels' chunk-major [k][dir][h] once per call.

``LSTM`` and ``GRU`` have ``nn.LSTM``/``nn.GRU`` semantics and parameter
names and run PyTorch's own recurrence: cuDNN on the card, in float32 and
in bfloat16 alike (a bfloat16 call on an H100 under PyTorch 2.11 and CUDA
12.8 launches cuDNN's ``elemWiseRNNcell<__nv_bfloat16, ...>`` and cuBLAS
GEMMs under ``aten::lstm``). cuDNN takes its input contiguous, so a
strided input is copied first (the DualPathRNN's window-layout route hands
it contiguous windows; its general route's permuted windows are copied),
and the weights, cast per call, are not one flat buffer, so cuDNN packs
them anew at every call. The JAX package runs
them as ``lax.scan`` in XLA, not as a Pallas kernel. ``sru_v1_layer`` is
the SRU-v1 direction the JAX package exposes for experiments; no model
calls it.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
from torch import _VF, nn
import torch.nn.functional as F

from .conv import unfold_1d
from .kernels.sru import sru_stack_layer
from .kernels.sru_direction import sru_direction
from .kernels.sru_train import sru_layer_train

def windowed_projection(x, w, kernel_size: int, stride: int):
    """``unfold_1d(x, k, s)`` -> (L, B, C·k) -> ``@ w`` as one k-wide
    strided conv on the pre-unfold tensor: x (B, C, T), w (C·k, D) with
    rows ``c*k + tap`` (the ``unfold_1d`` order) -> u (L, B, D)."""
    C = x.shape[1]
    rhs = w.t().reshape(-1, C, kernel_size).to(x.dtype)  # (D, C, k)
    return F.conv1d(x, rhs, stride=stride).permute(2, 0, 1)


def sru_v1_layer(u0, f_pre, r_pre, x_skip):
    """One SRU-v1 direction, gates independent of c, on (L, ...) inputs:
    c_t = f_t c_{t-1} + (1 - f_t) u0_t with f = sigmoid(f_pre) and c_{-1} = 0,
    h_t = r_t c_t + (1 - r_t) x_skip_t with r = sigmoid(r_pre)."""
    f = torch.sigmoid(f_pre)
    b = (1.0 - f) * u0
    c, prev = [], torch.zeros_like(u0[0])
    for t in range(u0.shape[0]):
        prev = f[t] * prev + b[t]
        c.append(prev)
    r = torch.sigmoid(r_pre)
    return r * torch.stack(c) + (1.0 - r) * x_skip


# the route of an SRU built without ``backend``; read at each call
DEFAULT_SRU_BACKEND = "scan"
_BACKENDS = ("scan", "pallas")


class SRUCell(nn.Module):
    """One layer's parameters under the reference names."""

    def __init__(self, input_size: int, hidden_size: int, bidirectional: bool):
        super().__init__()
        self.ndir = 2 if bidirectional else 1
        self.hidden_size = hidden_size
        out = hidden_size * self.ndir
        self.k = 4 if input_size != out else 3
        self.weight = nn.Parameter(torch.empty(input_size, self.ndir * self.k * hidden_size))
        self.weight_c = nn.Parameter(torch.zeros(2 * out))
        self.bias = nn.Parameter(torch.zeros(2 * out))
        self.reset_parameters()

    def reset_parameters(self, generator=None):
        # sru init: U(±sqrt(3/d_in)); gate vectors zero
        bound = math.sqrt(3.0 / self.weight.shape[0])
        with torch.no_grad():
            self.weight.uniform_(-bound, bound, generator=generator)
            self.weight_c.zero_()
            self.bias.zero_()

    def projection(self, dtype, taps: int = 1) -> torch.Tensor:
        """(k·O, d_in) with rows ``c*O + d*H + h`` (the kernel's u order).
        With ``taps`` > 1 the input is C·taps unfolded channels, whose weight
        rows are ``c*taps + tap`` (the ``unfold_1d`` order), and the columns
        come out tap-major, ``tap*C + c``."""
        d_in = self.weight.shape[0]
        w = self.weight.view(d_in // taps, taps, self.ndir, self.k, self.hidden_size)
        return w.permute(3, 2, 4, 1, 0).reshape(-1, d_in).to(dtype)

    def recur(self, u, skip):
        """The layer's recurrence: the training kernel K2 when autograd
        records, else the inference kernel K1."""
        args = (u, skip, self.weight_c, self.bias)
        kernel = (sru_layer_train
                  if torch.is_grad_enabled() and any(t is not None and t.requires_grad
                                                     for t in args)
                  else sru_stack_layer)
        return kernel(*args, H=self.hidden_size, k=self.k, ndir=self.ndir)

    def recur_directions(self, u, h_seq):
        """The per-direction recurrence: u (L, rows, k·O) with columns
        ``c*O + d*H + h``, h_seq (L, rows, O) the highway input when
        k == 3; one ``sru_direction`` call per direction on slices of u."""
        L, rows, _ = u.shape
        H, O = self.hidden_size, self.hidden_size * self.ndir
        u = u.view(L, rows, self.k, O)
        outs = []
        for d in range(self.ndir):
            sl = slice(d * H, (d + 1) * H)
            gate = slice(O + d * H, O + (d + 1) * H)
            skip = u[:, :, 3, sl] if self.k == 4 else h_seq[:, :, sl]
            outs.append(sru_direction(
                u[:, :, 0, sl], u[:, :, 1, sl], u[:, :, 2, sl], skip,
                self.weight_c[sl], self.weight_c[gate], self.bias[sl], self.bias[gate],
                reverse=(d == 1)))
        return torch.cat(outs, dim=-1) if self.ndir > 1 else outs[0]


class SRU(nn.Module):
    def __init__(self, input_size: int, hidden_size: int, num_layers: int = 2,
                 bidirectional: bool = False, backend: Optional[str] = None):
        super().__init__()
        if backend is not None and backend not in _BACKENDS:
            raise ValueError(f"unknown SRU backend {backend!r}: one of {_BACKENDS}")
        self.backend = backend
        out = hidden_size * (2 if bidirectional else 1)
        self.rnn_lst = nn.ModuleList(
            SRUCell(input_size if l == 0 else out, hidden_size, bidirectional)
            for l in range(num_layers))

    def route(self) -> str:
        """The backend this call takes: its own, else ``DEFAULT_SRU_BACKEND``."""
        backend = self.backend or DEFAULT_SRU_BACKEND
        if backend not in _BACKENDS:
            raise ValueError(f"unknown SRU backend {backend!r}: one of {_BACKENDS}")
        return backend

    def forward(self, x, window=None):
        """x: (L, rows, input_size) -> (L, rows, O).

        With ``window=(k, s)``, x is the pre-unfold (rows, C, T) tensor with
        C·k == input_size: layer 0's projection over the unfolded windows is
        one k-wide stride-s conv, so the k× larger unfolded tensor is built
        only when layer 0 needs it as its highway input (k == 3)."""
        if self.route() == "pallas":
            return self._forward_directions(x, window)
        cell = self.rnn_lst[0]
        w = cell.projection(x.dtype)
        if window is not None:
            k_w, s_w = window
            rows, C, _ = x.shape
            u = F.conv1d(x, w.view(w.shape[0], C, k_w), stride=s_w)  # (rows, kO, L)
            u = u.permute(2, 1, 0).contiguous()
            skip = (unfold_1d(x, k_w, s_w).permute(2, 1, 0).contiguous()
                    if cell.k == 3 else None)
        else:
            xc = x.permute(0, 2, 1)  # (L, d_in, rows)
            u = torch.matmul(w, xc)
            skip = xc.contiguous() if cell.k == 3 else None
        h = cell.recur(u, skip)
        for cell in self.rnn_lst[1:]:
            u = torch.matmul(cell.projection(h.dtype), h)
            h = cell.recur(u, h if cell.k == 3 else None)
        return h.permute(0, 2, 1)

    def forward_windows(self, y, kernel_size: int, pad: int = 0):
        """The ``"scan"`` route's inference on K1's layout from the start:
        y (S, C, rows) is the sequence whose stride-1 windows of
        ``kernel_size`` steps (C·kernel_size == input_size) are layer 0's
        input. Returns (L + 2·pad, O, rows), L = S - kernel_size + 1, with
        ``pad`` zero steps at each end (the last layer's K1 writes into the
        middle). A window at l is y[l:l + kernel_size], one contiguous
        (kernel_size·C, rows) matrix at offset l·C·rows, so layer 0's
        projection is one batched matmul over overlapping views of y with the
        weight's columns tap-major: u comes out (L, k·O, rows) with no copy
        of y. Autograd must not be recording (K1 has no backward)."""
        S, C, rows = y.shape
        L = S - kernel_size + 1
        cell = self.rnn_lst[0]
        windows = y.as_strided((L, kernel_size * C, rows), (C * rows, rows, 1))
        u = torch.matmul(cell.projection(y.dtype, kernel_size), windows)
        skip = None
        if cell.k == 3:  # the unfolded windows themselves, rows c*k + tap
            skip = y.as_strided((L, C, kernel_size, rows), (C * rows, rows, C * rows, 1))
            skip = skip.reshape(L, C * kernel_size, rows)
        last = len(self.rnn_lst) - 1
        for i, cell in enumerate(self.rnn_lst):
            if i:
                u = torch.matmul(cell.projection(h.dtype), h)
                skip = h if cell.k == 3 else None
            h = sru_stack_layer(u, skip, cell.weight_c, cell.bias, H=cell.hidden_size,
                                k=cell.k, ndir=cell.ndir, pad=pad if i == last else 0)
        return h

    def _forward_directions(self, x, window):
        """The ``"pallas"`` route: (L, rows, ·) throughout."""
        cell = self.rnn_lst[0]
        w = cell.projection(x.dtype)
        if window is not None:
            k_w, s_w = window
            u = windowed_projection(x, w.t(), k_w, s_w).contiguous()  # (L, rows, kO)
            h = unfold_1d(x, k_w, s_w).permute(2, 0, 1) if cell.k == 3 else None
        else:
            u = torch.matmul(x, w.t())
            h = x
        h = cell.recur_directions(u, h)
        for cell in self.rnn_lst[1:]:
            h = cell.recur_directions(torch.matmul(h, cell.projection(h.dtype).t()), h)
        return h


class _LibraryRNN(nn.Module):
    """Parameters under ``nn.LSTM``/``nn.GRU``'s names
    (``weight_ih_l{n}[_reverse]``, ``weight_hh_...``, ``bias_ih_...``,
    ``bias_hh_...``; ``gates`` row blocks each) and one call of PyTorch's
    recurrence with them cast to the input's dtype. The call asks for the
    training form whenever autograd records, whatever the module's mode:
    cuDNN keeps what its backward needs only then, and with no dropout the
    two forms compute the same values."""

    gates = 0
    recurrence = None

    def __init__(self, input_size: int, hidden_size: int, num_layers: int = 1,
                 bidirectional: bool = False, batch_first: bool = False):
        super().__init__()
        self.hidden_size, self.num_layers = hidden_size, num_layers
        self.bidirectional, self.batch_first = bidirectional, batch_first
        ndir = 2 if bidirectional else 1
        self.names = []
        for layer in range(num_layers):
            d_in = input_size if layer == 0 else hidden_size * ndir
            for d in range(ndir):
                sfx = f"_l{layer}" + ("_reverse" if d == 1 else "")
                for name, shape in ((f"weight_ih{sfx}", (d_in,)),
                                    (f"weight_hh{sfx}", (hidden_size,)),
                                    (f"bias_ih{sfx}", ()), (f"bias_hh{sfx}", ())):
                    self.register_parameter(name, nn.Parameter(
                        torch.empty((self.gates * hidden_size,) + shape)))
                    self.names.append(name)
        self.reset_parameters()

    def reset_parameters(self, generator=None):
        bound = 1.0 / math.sqrt(self.hidden_size)
        with torch.no_grad():
            for name in self.names:
                getattr(self, name).uniform_(-bound, bound, generator=generator)

    def forward(self, x):
        """x: (L, B, input_size), or (B, L, input_size) when ``batch_first``
        -> (L, B, ndir·H) or (B, L, ndir·H)."""
        batch_first = self.batch_first
        weights = [getattr(self, name).to(x.dtype) for name in self.names]
        ndir = 2 if self.bidirectional else 1
        h0 = x.new_zeros((self.num_layers * ndir, x.shape[0 if batch_first else 1],
                          self.hidden_size))
        hx = h0 if self.gates == 3 else (h0, h0)
        return self.recurrence(x, hx, weights, True, self.num_layers, 0.0,
                               torch.is_grad_enabled(), self.bidirectional, batch_first)[0]


class LSTM(_LibraryRNN):
    """``nn.LSTM`` (gate order i, f, g, o; both biases)."""

    gates = 4
    recurrence = staticmethod(_VF.lstm)


class GRU(_LibraryRNN):
    """``nn.GRU`` (gate order r, z, n; the reset gate scales W_hn h + b_hn)."""

    gates = 3
    recurrence = staticmethod(_VF.gru)


def get_rnn(rnn_type: str):
    return {"SRU": SRU, "LSTM": LSTM, "GRU": GRU}[rnn_type]
