"""The hand-written kernels K1-K4 on an NVIDIA card against their plain
versions, and every op of ``ops.kernels.KERNELS`` under
``torch.library.opcheck`` on CUDA inputs.

Marked ``card``; each test skips without a card. No JAX is imported::

    python3 -m pytest --noconftest -p no:cacheprovider -m card tests/test_torch_card_kernels.py

The shapes are those the paths give each kernel, and the edge lists:

* K1 (``sru_stack_layer``) at the serving forward's two passes (L, rows
  per utterance) = (57, 125) and (118, 64), k = 4 and 3, for B = 1, 4, 16
  in both dtypes and B = 128 in bfloat16; with the DualPathRNN's 7 zero
  end steps (``pad``) at the B = 128 bfloat16 block's passes, the DPTNet
  AVNet's (122, 251·B) and the proofs' float32 B = 4; at ``SRU_EDGE`` (L =
  1 and 2, rows 125, 63 and 500, k = 3 and 4, one and two directions, a
  slice at an odd offset). The main-path and edge shapes run both the ring
  and the narrow kernel. float32 within 1e-5, bfloat16 within 1e-5 +
  2^-7·|ref|.
* K2 (``sru_train_forward``, ``sru_train_backward``) at the B = 4 and 16
  train steps' passes, the DPTNet's at B = 4 and the proofs' (float32 B =
  4, bfloat16 B = 2): h, c, du, dskip within 1e-5 + 1e-5·|ref| (bfloat16
  as K1), the gate sums dv, db within 1e-4·max|ref| (bfloat16 1e-3); at
  ``SRU_EDGE``, every operand a slice at the offset, the gradients within
  2e-4·max(1, max|ref|) (bfloat16 du and dskip as K1).
* K3 (``dw_conv2d_same``) forward at the main path's (B, 64, 251, 129) and
  (B, 64, 125, 64) for B = 16 and 128 with the 4x4 kernel and pads (1, 2),
  and small shapes with 3x3, 2x3 and 7x2 kernels; its backward at one
  shape against autograd through the plain version; forward and dx (the
  autograd Function, two launches) at ``DW_EDGE`` (odd F, T not a
  multiple of the band, B·C = 1, slices at odd offsets, uneven pads, other
  kernels), at ShuffleNet's planes, at the DPTNet's 5x5 on 128 channels and
  at the proofs' planes; float32 1e-5 + 1e-5·|ref|, bfloat16 as K1.
* K4 (``sru_direction``) at the serving passes of B = 1, 4, 16, both
  directions, on slices of one (L, rows, 4, 64) projection, and at
  ``SRU_DIR_EDGE`` (odd H, slices at odd offsets); both the ring and the
  narrow kernel run; K2's forward tolerances.

Every call is held to its own launches: the CUDA kernel ran, not the
plain version. The DualPathRNN's layout kernels are checked in
``tests/test_torch_card_dual_path.py``; their ``opcheck`` is here.
"""
import itertools

import pytest
import torch

from rtfs_net_tpu_torch.ops import kernels
from rtfs_net_tpu_torch.ops.kernels import dual_path, dw_conv, sru, sru_direction, sru_train

from _torch_card import (DTYPE_IDS, DTYPES, assert_close, assert_launches, card,  # noqa: F401
                         edge_operand, generator, randn)

pytestmark = pytest.mark.card

f32, bf16 = torch.float32, torch.bfloat16
H = 32
O = 2 * H
SRU_PASSES = [(57, 125), (118, 64)]  # (L, rows per utterance): the F pass, the T pass
SERVE_BATCHES, BIG_BATCH = (1, 4, 16), 128
PAD = 7  # the DualPathRNN's k - 1 zero end steps, k = 8
# the (L, rows per utterance) of the SRU DualPathRNN's F and T passes over
# RTFS-Net-4's (126, 65) block from 2 s frames, and of the DPTNet AVNet's
# SRU DualPathRNN along F at the full (251, 129) plane
BLOCK_PASSES, DPT_PASS = [(65 - 8 + 1, 126), (126 - 8 + 1, 65)], (122, 251)
TRAIN_BATCHES = (4, 16)
PROOF_SERVE, PROOF_TRAIN = [(4, f32)], [(4, f32), (2, bf16)]

# K1: (L, rows, k, dtype, pads), each pad also run against the plain version
K1_CASES = (
    [(L, per_utt * B, k, dtype, (0,)) for B in SERVE_BATCHES + (BIG_BATCH,)
     for (L, per_utt), k in itertools.product(SRU_PASSES, (4, 3))
     for dtype in ((bf16,) if B == BIG_BATCH else DTYPES)]
    + [(L, per_utt * B, k, dtype, (0, PAD)) for (L, per_utt), (B, dtype), k in itertools.chain(
        itertools.product(BLOCK_PASSES, [(BIG_BATCH, bf16)], (4, 3)),
        itertools.product([DPT_PASS], itertools.product(SERVE_BATCHES, DTYPES), (4, 3)),
        itertools.product(SRU_PASSES, PROOF_SERVE, (4, 3)))])
# K1 and K2 edge cases: (L, rows, k, ndir, offset); odd rows and a slice at
# an odd offset take the narrow kernel in bfloat16
SRU_EDGE = [(L, rows, k, ndir, 0) for L in (1, 2) for rows in (125, 63, 500)
            for k in (3, 4) for ndir in (1, 2)] + [(57, 500, 3, 2, 1), (57, 125, 4, 2, 0)]
# K2: (L, rows, k, dtype) of the train steps, the DPTNet's and the proofs'
K2_CASES = [(L, per_utt * B, k, dtype) for (L, per_utt), (B, dtype), k in itertools.chain(
    itertools.product(SRU_PASSES, itertools.product(TRAIN_BATCHES, DTYPES), (4, 3)),
    itertools.product([DPT_PASS], [(TRAIN_BATCHES[0], dtype) for dtype in DTYPES], (4, 3)),
    itertools.product(SRU_PASSES, PROOF_TRAIN, (4, 3)))]
# K3's main path: the TDANet block's depthwise convs at (B, 64, T, F)
CHANNELS, DW_PLANES, DW_KERNEL, DW_PADS = 64, [(251, 129), (125, 64)], (4, 4), ((1, 2), (1, 2))
# small K3 cases: (shape, kernel, pads); the last takes the generic kernel
DW_SMALL = [((2, 5, 33, 17), (3, 3), ((1, 1), (1, 1))),
            ((3, 4, 19, 40), (2, 3), ((0, 1), (1, 1))),
            ((2, 3, 21, 9), (7, 2), ((3, 3), (0, 1)))]
# K3 edge cases, forward and dx: (shape, kernel, pads, offset): odd F (129,
# 7), T not a multiple of the band's rows, B*C = 1, x a contiguous slice at
# an odd element offset, uneven pads, other kernels (7x2: the generic one)
DW_EDGE = [((2, 3, 45, 129), (4, 4), ((1, 2), (1, 2)), 0),
           ((2, 3, 45, 7), (4, 4), ((2, 1), (2, 1)), 1),
           ((1, 1, 50, 129), (4, 4), ((0, 3), (0, 3)), 3),
           ((1, 1, 251, 129), (4, 4), ((1, 2), (1, 2)), 1),
           ((3, 2, 37, 64), (3, 3), ((1, 1), (1, 1)), 0),
           ((2, 5, 21, 9), (2, 3), ((0, 1), (1, 1)), 1),
           ((2, 3, 21, 9), (7, 2), ((3, 3), (0, 1)), 0)]


def _centred(kernel):
    return tuple(((kk - 1) // 2, kk - 1 - (kk - 1) // 2) for kk in kernel)


# K3 forward and dx, (shape, kernel, pads, offset, dtype): the edges in both
# dtypes; ShuffleNetV2's stride-1 planes at width 1.0 (50·4 frames: 11, 6 and
# 3 through its three stages), 3x3; the DPTNet's 5x5 group-FFN refiner on 128
# channels at B = 16 and 4; the proofs' planes at float32 B = 4, bfloat16 B = 2
DW_DX_CASES = (
    [(shape, kernel, pads, offset, dtype) for shape, kernel, pads, offset in DW_EDGE
     for dtype in DTYPES]
    + [((200, C, p, p), (3, 3), ((1, 1), (1, 1)), 0, dtype)
       for p, C in ((11, 58), (6, 116), (3, 232)) for dtype in DTYPES]
    + [((B, 128, 251, 129), (5, 5), _centred((5, 5)), 0, dtype)
       for B in (16, 4) for dtype in DTYPES]
    + [((B, CHANNELS, *plane), DW_KERNEL, _centred(DW_KERNEL), 0, dtype)
       for plane in DW_PLANES for B, dtype in PROOF_TRAIN])
# K4 edge cases: (L, rows, H, offset) of slices of one (L, rows, 4, 2H)
# projection; odd H and an odd offset take the narrow kernel in bfloat16
SRU_DIR_EDGE = [(L, rows, H, 0) for L in (1, 2) for rows in (125, 63, 500)] + [
    (57, 125, 33, 0), (57, 63, 7, 0), (57, 500, 32, 1), (118, 64, 32, 3)]
K4_CASES = [(L, per_utt * B, H, 0) for B in SERVE_BATCHES for L, per_utt in SRU_PASSES]


def _ids(cases):
    return ["-".join(str(getattr(v, "__name__", v)).replace("torch.", "").replace(" ", "")
                     for v in case) for case in cases]


def _sru_operands(gen, L, rows, k, ndir, dtype, offset=0):
    O_ = H * ndir
    u = edge_operand((L, k * O_, rows), dtype, offset, gen)
    skip = edge_operand((L, O_, rows), dtype, offset, gen) if k == 3 else None
    v, b = 0.5 * randn(gen, 2 * O_), 0.5 * randn(gen, 2 * O_)
    return u, skip, v, b


@pytest.mark.parametrize("L,rows,k,dtype,pads", K1_CASES, ids=_ids(K1_CASES))
def test_k1_against_its_plain_version(card, L, rows, k, dtype, pads):
    gen = generator(L, rows, k, str(dtype))
    u, skip, v, b = _sru_operands(gen, L, rows, k, 2, dtype)
    want = sru.sru_stack_layer_ref(u, skip, v, b, H=H, k=k, ndir=2)
    for pad in pads:
        with torch.no_grad():
            got = assert_launches(
                lambda: sru.sru_stack_layer(u, skip, v, b, H=H, k=k, ndir=2, pad=pad), {"K1": 1})
        assert got.shape == (L + 2 * pad, O, rows)
        assert not (got[:pad].any() or got[L + pad:].any())  # the zero end steps
        assert_close(got[pad:L + pad], want, dtype, rtol32=0)


@pytest.mark.parametrize("dtype", DTYPES, ids=DTYPE_IDS)
@pytest.mark.parametrize("L,rows,k,ndir,offset", SRU_EDGE, ids=_ids(SRU_EDGE))
def test_k1_at_edge_shapes(card, L, rows, k, ndir, offset, dtype):
    gen = generator(L, rows, k, ndir, offset)
    u, skip, v, b = _sru_operands(gen, L, rows, k, ndir, dtype, offset)
    with torch.no_grad():
        got = assert_launches(lambda: sru.sru_stack_layer(u, skip, v, b, H=H, k=k, ndir=ndir),
                              {"K1": 1})
    assert_close(got, sru.sru_stack_layer_ref(u, skip, v, b, H=H, k=k, ndir=ndir), dtype,
                 rtol32=0)


def test_k1_shapes_run_the_ring_and_the_narrow_kernel(card):
    """The launch plans of the main-path and edge shapes above hold both a
    ring depth and 0, the narrow kernel."""
    depths = {sru.launch_plan(rows, O, torch.tensor([], dtype=dtype).element_size())
              for L, rows, k, dtype, _ in K1_CASES}
    gen = generator("plans")
    for (L, rows, k, ndir, offset), dtype in itertools.product(SRU_EDGE, DTYPES):
        u, skip, _, _ = _sru_operands(gen, L, rows, k, ndir, dtype, offset)
        depths.add(sru.launch_plan(rows, H * ndir, u.element_size(), sru._aligned(u, skip)))
    assert 0 in depths and depths - {0}, sorted(depths)


def _k2_errors(u, skip, v, b, dh, c_at, dtype, kw):
    """K2's forward and backward (one launch each) and their plain
    versions' outputs, by part; ``c_at(c)`` is the c the backward reads."""
    def run():
        h, c = sru_train.sru_train_forward(u, skip, v, b, **kw)
        c = c_at(c)
        return h, c, sru_train.sru_train_backward(u, skip, c, v, b, dh, **kw)

    h, c, grads = assert_launches(run, {"K2_forward": 1, "K2_backward": 1})
    want_h, want_c = sru_train.sru_train_forward_ref(u, skip, v, b, **kw)
    want = sru_train.sru_train_backward_ref(u, skip, c, v, b, dh, **kw)
    return {"h": (h, want_h), "c": (c, want_c),
            **{p: (g, w) for p, g, w in zip(("du", "dskip", "dv", "db"), grads, want)
               if w is not None}}


@pytest.mark.parametrize("L,rows,k,dtype", K2_CASES, ids=_ids(K2_CASES))
def test_k2_against_its_plain_version(card, L, rows, k, dtype):
    gen = generator("k2", L, rows, k, str(dtype))
    u, skip, v, b = _sru_operands(gen, L, rows, k, 2, dtype)
    dh = randn(gen, L, O, rows, dtype=dtype)
    parts = _k2_errors(u, skip, v, b, dh, lambda c: c, dtype, dict(H=H, k=k, ndir=2))
    gate_rtol = 1e-4 if dtype == f32 else 1e-3
    for part, (g, w) in parts.items():
        if part in ("dv", "db"):
            err = float((g - w).abs().max())
            assert err <= gate_rtol * float(w.abs().max()), (part, err)
        else:
            assert_close(g, w, dtype)


@pytest.mark.parametrize("dtype", DTYPES, ids=DTYPE_IDS)
@pytest.mark.parametrize("L,rows,k,ndir,offset", SRU_EDGE, ids=_ids(SRU_EDGE))
def test_k2_at_edge_shapes(card, L, rows, k, ndir, offset, dtype):
    """The gradients within 2e-4·max(1, max|ref|), except bfloat16 du and
    dskip, which are rounded to bfloat16 (one ulp is 2^-8 of the value) and
    take the bfloat16 tolerance; every operand, the backward's c too, a
    slice at ``offset``."""
    gen = generator("k2 edge", L, rows, k, ndir, offset)
    u, skip, v, b = _sru_operands(gen, L, rows, k, ndir, dtype, offset)
    dh = edge_operand((L, H * ndir, rows), dtype, offset, gen)

    def c_at(c):
        return edge_operand(c.shape, dtype, offset, gen).copy_(c) if offset else c

    parts = _k2_errors(u, skip, v, b, dh, c_at, dtype, dict(H=H, k=k, ndir=ndir))
    for part, (g, w) in parts.items():
        if part in ("h", "c") or (dtype == bf16 and part in ("du", "dskip")):
            assert_close(g, w, dtype)
        else:
            err = float((g.float() - w.float()).abs().max())
            assert err <= 2e-4 * max(1.0, float(w.float().abs().max())), (part, err)


K3_CASES = [((B, CHANNELS, T, Fq), DW_KERNEL, DW_PADS) for B in (16, BIG_BATCH)
            for T, Fq in DW_PLANES] + DW_SMALL


@pytest.mark.parametrize("dtype", DTYPES, ids=DTYPE_IDS)
@pytest.mark.parametrize("shape,kernel,pads", K3_CASES, ids=_ids(K3_CASES))
def test_k3_against_its_plain_version(card, shape, kernel, pads, dtype):
    gen = generator("k3", shape, kernel)
    x = randn(gen, *shape, dtype=dtype)
    w = randn(gen, shape[1], 1, *kernel)
    with torch.no_grad():
        got = assert_launches(lambda: dw_conv.dw_conv2d_same(x, w, pads), {"K3": 1})
    assert_close(got, dw_conv.dw_conv2d_same_ref(x, w, pads), dtype)


def test_k3_backward_against_autograd(card):
    """dx through the kernel, dw through PyTorch's convolution backward,
    against autograd through the plain version: dx within 1e-5 +
    1e-5·|ref|, dw within 1e-4·max|ref|."""
    gen = generator("k3 backward")
    shape = (4, CHANNELS, 125, 64)
    x, w, g = randn(gen, *shape), randn(gen, CHANNELS, 1, *DW_KERNEL), randn(gen, *shape)
    grads = []
    for fn, want in ((dw_conv.dw_conv2d_same, {"K3": 2}), (dw_conv.dw_conv2d_same_ref, {})):
        xi, wi = x.clone().requires_grad_(), w.clone().requires_grad_()
        assert_launches(lambda: fn(xi, wi, DW_PADS).backward(g), want)
        grads.append((xi.grad, wi.grad))
    (dx, dw), (dx_ref, dw_ref) = grads
    assert_close(dx, dx_ref, f32)
    assert float((dw - dw_ref).abs().max()) <= 1e-4 * float(dw_ref.abs().max())


@pytest.mark.parametrize("shape,kernel,pads,offset,dtype", DW_DX_CASES, ids=_ids(DW_DX_CASES))
def test_k3_forward_and_dx(card, shape, kernel, pads, offset, dtype):
    """The forward and dx (the autograd Function's backward runs the kernel
    on dy with the flipped kernel) against the plain version; x a
    contiguous slice of a larger tensor at ``offset`` elements."""
    gen = generator("k3 dx", shape, kernel, offset)
    (lo_t, hi_t), (lo_f, hi_f) = pads
    dx_pads = ((kernel[0] - 1 - lo_t, kernel[0] - 1 - hi_t),
               (kernel[1] - 1 - lo_f, kernel[1] - 1 - hi_f))
    x = edge_operand(shape, dtype, offset, gen).requires_grad_()
    dy = randn(gen, *shape, dtype=dtype)
    w = randn(gen, shape[1], 1, *kernel)

    def run():
        y = dw_conv.dw_conv2d_same(x, w, pads)
        y.backward(dy)
        return y

    y = assert_launches(run, {"K3": 2})
    with torch.no_grad():
        assert_close(y, dw_conv.dw_conv2d_same_ref(x, w, pads), dtype)
        assert_close(x.grad, dw_conv.dw_conv2d_same_ref(dy, w.flip(2, 3), dx_pads), dtype)


def _k4_operands(gen, L, rows, Hd, offset, dtype, reverse):
    u = edge_operand((L, rows, 4, 2 * Hd), dtype, offset, gen)
    sl = slice(Hd, 2 * Hd) if reverse else slice(0, Hd)
    return [u[:, :, c, sl] for c in range(4)], [0.5 * randn(gen, Hd) for _ in range(4)]


@pytest.mark.parametrize("reverse", [False, True], ids=["forward", "reverse"])
@pytest.mark.parametrize("dtype", DTYPES, ids=DTYPE_IDS)
@pytest.mark.parametrize("L,rows,Hd,offset", K4_CASES + SRU_DIR_EDGE,
                         ids=_ids(K4_CASES + SRU_DIR_EDGE))
def test_k4_against_its_plain_version(card, L, rows, Hd, offset, dtype, reverse):
    """The serving passes of B = 1, 4, 16 and the edge shapes, on the
    slices of one (L, rows, 4, 2H) projection the route gives the kernel."""
    ops, gates = _k4_operands(generator("k4", L, rows, Hd, offset), L, rows, Hd, offset, dtype,
                              reverse)
    got = assert_launches(lambda: sru_direction.sru_direction(*ops, *gates, reverse=reverse),
                          {"K4": 1})
    assert_close(got, sru_direction.sru_direction_ref(*ops, *gates, reverse=reverse), dtype)


def test_k4_shapes_run_the_ring_and_the_narrow_kernel(card):
    depths = {sru_direction.launch_plan(rows, Hd, torch.tensor([], dtype=dtype).element_size())
              for (L, rows, Hd, _), dtype in itertools.product(K4_CASES, DTYPES)}
    gen = generator("k4 plans")
    for (L, rows, Hd, offset), dtype in itertools.product(SRU_DIR_EDGE, DTYPES):
        ops, _ = _k4_operands(gen, L, rows, Hd, offset, dtype, False)
        depths.add(sru_direction.launch_plan(rows, Hd, ops[0].element_size(), all(
            sru_direction._words_aligned(t) for t in ops)))
    assert 0 in depths and depths - {0}, sorted(depths)


def _sru_op_cases(gen):
    """The SRU layer ops' arguments at small edge shapes: k = 3 with skip,
    k = 4 without, one direction, bfloat16 operands at an odd offset (the
    narrow kernel)."""
    cases = []
    for L, rows, k, ndir, offset, dtype in ((2, 63, 3, 2, 0, f32), (1, 125, 4, 1, 0, f32),
                                            (2, 125, 3, 2, 1, bf16)):
        cases.append((*_sru_operands(gen, L, rows, k, ndir, dtype, offset), H, k, ndir))
    return cases


def _sru_train_backward_cases(gen):
    cases = []
    for u, skip, v, b, Hd, k, ndir in _sru_op_cases(gen):
        _, c = sru_train.sru_train_forward(u, skip, v, b, H=Hd, k=k, ndir=ndir)
        cases.append((u, skip, c, v, b, randn(gen, *c.shape, dtype=c.dtype), Hd, k, ndir))
    return cases


def _dw_conv_cases(gen):
    return [(edge_operand(shape, dtype, offset, gen), randn(gen, shape[1], 1, *kernel),
             [p for lo_hi in pads for p in lo_hi])
            for (shape, kernel, pads, offset), dtype in zip(DW_EDGE[:3], (f32, bf16, f32))]


def _sru_direction_cases(gen):
    """Slices of one projection, float32 forward and bfloat16 reversed at an
    odd element offset (the narrow kernel)."""
    cases = []
    for L, rows, Hd, offset, dtype, reverse in ((2, 63, 7, 0, f32, False),
                                                (2, 125, 32, 1, bf16, True)):
        u = edge_operand((L, rows, 4, 2 * Hd), dtype, offset, gen)
        gates = [0.5 * randn(gen, Hd) for _ in range(4)]
        cases.append((*(u[:, :, c, :Hd] for c in range(4)), *gates, reverse))
    return cases


def _dual_path_inputs(gen, shape, dtype, seq_dim, permuted=False):
    """x (scaled and shifted, as a block's features are not centred; laid
    out (B, T, C, F) if ``permuted``), gamma, beta; and the overlap-add's z
    in K1's layout, its bias and the residual."""
    B, C, T, F = shape
    x = randn(gen, B, T, C, F).permute(0, 2, 1, 3) if permuted else randn(gen, *shape)
    S, rows = dual_path.seq_shape(shape, seq_dim)
    return ((3 * x + 1).to(dtype), 1 + 0.1 * randn(gen, C), 0.1 * randn(gen, C),
            randn(gen, S, C, rows, dtype=dtype), randn(gen, C), randn(gen, *shape, dtype=dtype))


def _norm_in_cases(gen):
    return [(*_dual_path_inputs(gen, (2, 5, 9, 7), dtype, seq_dim)[:3], seq_dim, 1e-5)
            for seq_dim, dtype in ((2, f32), (3, bf16))]


def _out_cases(gen):
    return [(*_dual_path_inputs(gen, (2, 5, 9, 7), dtype, seq_dim)[3:], seq_dim)
            for seq_dim, dtype in ((2, f32), (3, bf16))]


def _windows_in_cases(gen):
    return [(*_dual_path_inputs(gen, (2, 5, 9, 7), dtype, seq_dim, permuted)[:3], seq_dim, k,
             1e-5) for dtype, seq_dim, k, permuted in ((f32, 2, 4, False), (bf16, 3, 3, False),
                                                        (bf16, 2, 4, True))]


# op -> its opcheck cases on the card
OPCHECK_CASES = {"sru_stack_layer": _sru_op_cases, "sru_train_forward": _sru_op_cases,
                 "sru_train_backward": _sru_train_backward_cases,
                 "dw_conv2d_same": _dw_conv_cases, "sru_direction": _sru_direction_cases,
                 "dual_path_norm_in": _norm_in_cases, "dual_path_out": _out_cases,
                 "dual_path_windows_in": _windows_in_cases}


@pytest.mark.parametrize("op", kernels.OPS)
def test_opcheck(card, op):
    """``torch.library.opcheck`` of ``rtfs::<op>`` on CUDA arguments: its
    schema, its fake implementation against the kernel's outputs, its
    autograd registration and tracing through AOT dispatch."""
    assert op in OPCHECK_CASES, f"no card cases for rtfs::{op}"
    overload = getattr(torch.ops.rtfs, op).default
    for args in OPCHECK_CASES[op](generator("opcheck", op)):
        result = torch.library.opcheck(overload, args)
        assert set(result.values()) == {"SUCCESS"}, result
