"""The serving artifact (``rtfs_net_tpu/export.py``'s counterpart): a model
exported once with ``torch.export``, its weights inside, its shapes pinned
and its precision policy in the graph.

``export_serving`` traces the serving function (float32 in, a cast to the
compute dtype, the model, a cast back to float32) at fixed shapes into an
``ExportedProgram``. The SRU recurrence and the depthwise stencil are
registered operators (``ops/kernels``), so the graph holds one
``rtfs::sru_stack_layer`` node per SRU layer and, on the card, one
``rtfs::dw_conv2d_same`` node per eligible depthwise conv; the trace runs
under ``torch.no_grad()``, which sends every SRU layer to the inference
kernel. The trace runs on the device the artifact will serve on:
``ops/conv.py`` sends depthwise convs to the stencil kernel only for CUDA
tensors, so a program traced on the CPU has none. The header's
``platforms`` records that device type, and the loader refuses another.

File format, the JAX package's framing with magics of its own: an 8-byte
magic (``RTFSXTC1``: one bucket; ``RTFSXTC2``: several), a little-endian
u64 header length, a JSON header, then one body per bucket, each the bytes
of ``torch.export.save``. The loader refuses the JAX package's files
(``RTFSXPT1``/``RTFSXPT2``), and the JAX loader refuses these.

``ServingArtifact`` serves any request batch: the smallest bucket at least
as large as the request, zero-padded and sliced back, and requests larger
than the largest bucket in chunks. Padding is exact: nothing in the model
mixes the batch axis.

A multi-device artifact (``mesh_devices`` = N, JAX ``export.py:99-116``)
holds each bucket's program traced at the bucket's batch over N, the
weights inside it (replicated); the header records ``nr_devices``. The
loader moves a copy of each program to each of N devices
(``torch.export.passes.move_to_device_pass``, which also rewrites the
devices the graph names) and serves a bucket call as N equal shards, one
per device, launched before any is read back, then concatenated.

Loading needs torch, numpy and the kernels' op registrations
(``rtfs_net_tpu_torch.ops.kernels``): no model zoo, no config, no
registry.
"""
from __future__ import annotations

import collections
import copy
import io
import json
import os
import struct
from typing import Any, Dict, Optional, Sequence, Tuple

import torch
from torch import nn

from .ops import kernels  # noqa: F401  (registers the rtfs:: ops the programs call)

MAGIC = b"RTFSXTC1"
MAGIC_MULTI = b"RTFSXTC2"
JAX_MAGICS = (b"RTFSXPT1", b"RTFSXPT2")

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


class _Serving(nn.Module):
    """float32 in, the model in ``dtype``, float32 out (JAX ``export.py:83-97``)."""

    def __init__(self, model: nn.Module, dtype: torch.dtype):
        super().__init__()
        self.model = model
        self.dtype = dtype

    def forward(self, mix, mouth=None):
        mouth = None if mouth is None else mouth.to(self.dtype)
        return self.model(mix.to(self.dtype), mouth).float()


def export_serving(model: nn.Module, batch_size: int, segment_samples: int,
                   mouth_shape: Optional[Sequence[int]] = None,
                   compute_dtype: Any = torch.bfloat16, device="cuda",
                   mesh_devices: int = 1) -> torch.export.ExportedProgram:
    """Trace ``model`` at fixed serving shapes: (batch_size, segment_samples)
    mixtures and, unless ``mouth_shape`` is None (the audio-only
    convention), (batch_size, *mouth_shape) lip embeddings, both float32;
    compute in ``compute_dtype``. A copy of the model is traced, in eval
    mode without gradients, on ``device``; ``model`` itself is untouched.
    With ``mesh_devices`` = N the program serves one of N equal shards of
    the batch (traced at batch_size / N rows), which must divide."""
    if batch_size % mesh_devices:
        raise ValueError(f"batch_size {batch_size} must shard evenly over "
                         f"{mesh_devices} devices")
    rows = batch_size // mesh_devices
    dtype = DTYPES[compute_dtype] if isinstance(compute_dtype, str) else compute_dtype
    device = torch.device(device)
    serving = _Serving(copy.deepcopy(model), dtype).to(device).eval().requires_grad_(False)
    args = (torch.zeros((rows, segment_samples), device=device),)
    if mouth_shape is not None:
        args += (torch.zeros((rows, *mouth_shape), device=device),)
    with torch.no_grad():
        return torch.export.export(serving, args, strict=False)


def op_counts(program: torch.export.ExportedProgram) -> Dict[str, int]:
    """Nodes of each ``rtfs::`` op in ``program``'s graph, by op name."""
    counts = collections.Counter()
    for node in program.graph.nodes:
        name = getattr(node.target, "name", None)
        if node.op == "call_function" and callable(name) and name().startswith("rtfs::"):
            counts[name().split("::", 1)[1]] += 1
    return dict(counts)


def _base_header(program, batch_size, segment_samples, mouth_shape, compute_dtype, extra):
    # the device of the request inputs (a lifted constant may sit on the CPU)
    inputs = set(program.graph_signature.user_inputs)
    vals = [n.meta["val"] for n in program.graph.nodes
            if n.op == "placeholder" and n.name in inputs]
    devices = {v.device.type for v in vals}
    header = {
        "calling_convention": (
            "separated = f(mix_f32[B, L])" if mouth_shape is None
            else "separated = f(mix_f32[B, L], mouth_f32[B, *mouth])"),
        "segment_samples": int(segment_samples),
        "mouth_shape": list(mouth_shape) if mouth_shape is not None else None,
        "compute_dtype": compute_dtype,
        "platforms": sorted(devices),
        # the program serves one shard: the bucket's batch over its rows
        "nr_devices": int(batch_size) // int(vals[0].shape[0]),
        "torch_version": str(torch.__version__),
    }
    header.update(extra or {})
    return header


def _program_bytes(program) -> bytes:
    """``torch.export.save`` bytes of ``program`` without its example inputs
    (zeros of the pinned shapes: 30 MB at B=128)."""
    example_inputs = program.example_inputs
    program.example_inputs = None
    try:
        buf = io.BytesIO()
        torch.export.save(program, buf)
    finally:
        program.example_inputs = example_inputs
    return buf.getvalue()


def _write_frame(path: str, magic: bytes, header: Dict[str, Any], blobs) -> None:
    hdr = json.dumps(header).encode()
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "wb") as f:
        f.write(magic + struct.pack("<Q", len(hdr)) + hdr)
        for blob in blobs:
            f.write(blob)


def save_serving(path: str, program, batch_size: int, segment_samples: int,
                 mouth_shape: Optional[Sequence[int]] = None,
                 compute_dtype: str = "bfloat16",
                 extra: Optional[Dict[str, Any]] = None) -> None:
    """Write a one-bucket ``RTFSXTC1`` artifact."""
    header = {"batch_size": int(batch_size),
              **_base_header(program, batch_size, segment_samples, mouth_shape,
                             compute_dtype, extra)}
    _write_frame(path, MAGIC, header, [_program_bytes(program)])


def save_serving_multi(path: str, programs_by_batch: Dict[int, Any], segment_samples: int,
                       mouth_shape: Optional[Sequence[int]] = None,
                       compute_dtype: str = "bfloat16",
                       extra: Optional[Dict[str, Any]] = None) -> None:
    """Write a bucketed ``RTFSXTC2`` artifact (one program per batch size)."""
    sizes = sorted(programs_by_batch)
    blobs = [_program_bytes(programs_by_batch[b]) for b in sizes]
    header = {"buckets": [{"batch_size": int(b), "length": len(blob)}
                          for b, blob in zip(sizes, blobs)],
              **_base_header(programs_by_batch[sizes[0]], sizes[0], segment_samples,
                             mouth_shape, compute_dtype, extra)}
    _write_frame(path, MAGIC_MULTI, header, blobs)


def _read_frame(path: str) -> Tuple[bytes, Dict[str, Any], bytes]:
    """(magic, header, body bytes) of an artifact file."""
    with open(path, "rb") as f:
        blob = f.read()
    magic = blob[:8]
    if magic in JAX_MAGICS:
        raise ValueError(f"{path}: a JAX artifact ({magic.decode()}); load it with "
                         "rtfs_net_tpu.export")
    if magic not in (MAGIC, MAGIC_MULTI):
        raise ValueError(f"{path}: not an rtfs_net_tpu_torch export")
    (hlen,) = struct.unpack("<Q", blob[8:16])
    header = json.loads(blob[16:16 + hlen].decode())
    return magic, header, blob[16 + hlen:]


def _load_program(body: bytes):
    return torch.export.load(io.BytesIO(body))


def load_serving(path: str) -> Tuple[torch.export.ExportedProgram, Dict[str, Any]]:
    """-> (program, header) of a one-bucket ``RTFSXTC1`` file; run it with
    ``program.module()(mix[, mouth])`` on the header's platform. Use
    ``load_artifact`` for either format."""
    magic, header, body = _read_frame(path)
    if magic != MAGIC:
        raise ValueError(f"{path}: bucketed artifact; use load_artifact")
    return _load_program(body), header


class ServingArtifact:
    """A loaded artifact that serves any request batch on its devices.

    ``device``: a device (default: the platform it was exported on), or for
    a multi-device artifact a list of at least ``nr_devices`` devices; a
    bare ``cuda`` stands for ``cuda:0`` .. ``cuda:N-1`` and ``cpu`` for the
    CPU N times. Fewer devices, or another device type, are refused.
    ``artifact(mix[, mouth])`` takes numpy arrays or tensors and returns
    numpy: the smallest bucket that fits, zero-padded and sliced back, and
    requests larger than the largest bucket in chunks. Each bucket's
    program is deserialized at its first use (seconds per bucket and
    device)."""

    def __init__(self, bodies_by_batch: Dict[int, bytes], header: Dict[str, Any], device=None):
        if not bodies_by_batch:
            raise ValueError("artifact has no buckets")
        n = int(header.get("nr_devices", 1))
        self.devices = _serving_devices(header["platforms"][0] if device is None else device, n)
        if len(self.devices) < n:
            raise ValueError(f"the artifact serves on {n} devices and was given "
                             f"{len(self.devices)} ({[str(d) for d in self.devices]}): "
                             f"load it where {n} are visible")
        self.devices = self.devices[:n]
        for d in self.devices:
            if d.type not in header["platforms"]:
                raise ValueError(f"the artifact was exported for {header['platforms']} and "
                                 f"cannot serve on {d.type}: export it again with --device "
                                 f"{d.type}")
        self.device = self.devices[0]
        self.bodies = dict(sorted(bodies_by_batch.items()))
        self.header = header
        self.batch_sizes = list(self.bodies)
        self._programs: Dict[int, torch.export.ExportedProgram] = {}
        self._modules: Dict[Tuple[int, int], nn.Module] = {}

    def program(self, b: int) -> torch.export.ExportedProgram:
        """The program of the bucket of batch ``b``."""
        if b not in self._programs:
            self._programs[b] = _load_program(self.bodies[b])
        return self._programs[b]

    def module(self, b: int, k: int = 0) -> nn.Module:
        """The callable of the bucket of batch ``b`` on device ``k``."""
        if (b, k) not in self._modules:
            from torch.export.passes import move_to_device_pass

            # device 0 takes the cached program, each other device a copy of its own
            program = self.program(b) if k == 0 else _load_program(self.bodies[b])
            device = self.devices[k]
            self._modules[b, k] = move_to_device_pass(program, device).module().to(device)
        return self._modules[b, k]

    def __call__(self, mix, mouth=None):
        mix = torch.as_tensor(mix, dtype=torch.float32)
        if mouth is not None:
            mouth = torch.as_tensor(mouth, dtype=torch.float32)
            if mouth.shape[0] != mix.shape[0]:
                raise ValueError(f"mix/mouth batch mismatch: {mix.shape[0]} != "
                                 f"{mouth.shape[0]}")
        total = mix.shape[0]
        if total == 0:
            raise ValueError("empty request batch (mix.shape[0] == 0)")
        n = len(self.devices)
        outs = []
        i = 0
        with torch.inference_mode():
            while i < total:
                rem = total - i
                b = next((s for s in self.batch_sizes if s >= rem), self.batch_sizes[-1])
                take = min(rem, b)

                def prep(a):
                    chunk = a[i:i + take]
                    if b > take:
                        chunk = torch.cat([chunk, chunk.new_zeros((b - take,) + a.shape[1:])])
                    return chunk

                args = (prep(mix),) if mouth is None else (prep(mix), prep(mouth))
                rows = b // n
                shards = [self.module(b, k)(*(a[k * rows:(k + 1) * rows].to(d)
                                               for a in args))
                          for k, d in enumerate(self.devices)]
                outs.append(torch.cat([y.cpu() for y in shards])[:take])
                i += take
        return (torch.cat(outs) if len(outs) > 1 else outs[0]).numpy()


def _serving_devices(device, n: int):
    """The devices a ``device`` argument names for an artifact of ``n``
    devices."""
    if isinstance(device, (list, tuple)):
        return [torch.device(d) for d in device]
    device = torch.device(device)
    if device.type == "cpu":
        return [device] * n
    if device.type == "cuda" and device.index is None and n > 1:
        return [torch.device("cuda", i) for i in range(min(n, torch.cuda.device_count()))]
    return [device]


def load_artifact(path: str, device=None) -> ServingArtifact:
    """Load either format into a batch-flexible server on ``device`` (a
    device or a list of them, ``ServingArtifact``)."""
    magic, header, body = _read_frame(path)
    if magic == MAGIC:
        return ServingArtifact({int(header["batch_size"]): body}, header, device)
    bodies, off = {}, 0
    for bucket in header["buckets"]:
        n = int(bucket["length"])
        bodies[int(bucket["batch_size"])] = body[off:off + n]
        off += n
    if off != len(body):
        raise ValueError(f"{path}: trailing bytes in artifact body")
    return ServingArtifact(bodies, header, device)
