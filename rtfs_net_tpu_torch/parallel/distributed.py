"""Process-group initialization (``rtfs_net_tpu/parallel/distributed.py``'s
counterpart; reference: the ``--nodes`` argument and Lightning's NCCL
launch, ``train.py:145,167``).

One process drives one device. ``torchrun --nproc_per_node=N`` (or any
launcher that sets ``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``,
``MASTER_ADDR`` and ``MASTER_PORT``) starts them, and ``initialize()``
joins them into the default process group: NCCL on the cards, gloo only
when the caller asks for the CPU. Without that environment it does
nothing, as ``jax.distributed`` does nothing without
``JAX_COORDINATOR_ADDRESS``. ``launch`` starts such a group itself, in
spawned processes that rendezvous through a file.
"""
from __future__ import annotations

import multiprocessing as mp
import os
import queue
import tempfile
import time
import traceback
from typing import Callable, List, Optional, Sequence

import torch
import torch.distributed as dist


def local_device(device="cuda") -> torch.device:
    """The device this process drives: on the cards the one ``initialize``
    made current (``cuda:<LOCAL_RANK>``; ``cuda:0`` without a process
    group), the CPU when the caller asks for it."""
    device = torch.device(device)
    if device.type != "cuda":
        return device
    if not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available; pass device='cpu' to run on the CPU")
    return torch.device("cuda", torch.cuda.current_device() if device.index is None
                        else device.index)


def initialize(device="cuda", init_method: Optional[str] = None,
               world_size: Optional[int] = None, rank: Optional[int] = None) -> bool:
    """Join the default process group from the arguments or the ``torchrun``
    environment (``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR``/``MASTER_PORT``);
    the backend is NCCL for ``device`` on a card (this process then drives
    ``cuda:<LOCAL_RANK>``) and gloo for the CPU. Returns whether a process
    group exists; False, doing nothing, without the environment or
    ``init_method``."""
    if dist.is_initialized():
        return True
    if init_method is None:
        if "WORLD_SIZE" not in os.environ or "RANK" not in os.environ:
            return False
        init_method = "env://"
    world_size = int(os.environ["WORLD_SIZE"]) if world_size is None else world_size
    rank = int(os.environ["RANK"]) if rank is None else rank
    device = torch.device(device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("CUDA is not available; pass device='cpu' to run on the CPU")
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK",
                                                 rank % torch.cuda.device_count())))
    dist.init_process_group("nccl" if device.type == "cuda" else "gloo",
                            init_method=init_method, world_size=world_size, rank=rank)
    return True


def shutdown():
    """Leave the default process group, if this process is in one."""
    if dist.is_initialized():
        dist.destroy_process_group()


def process_info():
    """(rank, world size, local device count): the counterpart of JAX's
    (process index, process count, local device count)."""
    if dist.is_initialized():
        rank, world = dist.get_rank(), dist.get_world_size()
    else:
        rank, world = 0, 1
    return rank, world, torch.cuda.device_count()


def wait_for_devices(min_devices: int = 1, timeout_s: float = 300.0) -> List[torch.device]:
    """Block until at least ``min_devices`` cards are visible (the
    reference's free-GPU wait, ``train.py:62-68``); returns them."""
    t0 = time.time()
    while True:
        n = torch.cuda.device_count()
        if n >= min_devices:
            return [torch.device("cuda", i) for i in range(n)]
        if time.time() - t0 > timeout_s:
            raise TimeoutError(f"fewer than {min_devices} devices after {timeout_s}s")
        time.sleep(5.0)


FAILURE_GRACE_S = 5.0


def _rank_main(fn, rank, world_size, init_method, device, args, results):
    try:
        os.environ["LOCAL_RANK"] = str(rank)  # this spawned process's own environment
        initialize(device, init_method=init_method, world_size=world_size, rank=rank)
        try:
            results.put((rank, True, fn(*args)))
        finally:
            shutdown()
    except BaseException:  # reported to the parent, which raises
        results.put((rank, False, traceback.format_exc()))


def launch(fn: Callable, world_size: int, args: Sequence = (), device="cuda",
           timeout_s: float = 900.0) -> list:
    """Run ``fn(*args)`` in ``world_size`` spawned processes, rank r driving
    ``cuda:r`` over NCCL (or the CPU over gloo), joined into one process
    group through a file in a temporary directory. ``fn`` must be
    importable by name, and its result picklable. Returns the results by
    rank; raises, after stopping every rank, if one fails or the run
    outlasts ``timeout_s``."""
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    with tempfile.TemporaryDirectory() as tmp:
        init_method = "file://" + os.path.join(tmp, "rendezvous")
        procs = [ctx.Process(target=_rank_main, args=(fn, r, world_size, init_method,
                                                      str(device), tuple(args), results))
                 for r in range(world_size)]
        for p in procs:
            p.start()
        out, failed, deadline = {}, {}, time.monotonic() + timeout_s
        try:
            while len(out) + len(failed) < world_size:
                try:
                    rank, ok, value = results.get(timeout=max(deadline - time.monotonic(), 0))
                except queue.Empty:
                    if failed:
                        break
                    raise TimeoutError(f"launch: {world_size - len(out)} of {world_size} "
                                       f"ranks unfinished after {timeout_s} s") from None
                if ok:
                    out[rank] = value
                else:
                    failed[rank] = value
                    # the other ranks' reports (often failures caused by this
                    # one) get a few seconds to arrive
                    deadline = min(deadline, time.monotonic() + FAILURE_GRACE_S)
            if failed:
                raise RuntimeError("launch: " + "\n".join(
                    f"rank {rank} failed:\n{value}" for rank, value in sorted(failed.items())))
        finally:
            for p in procs:
                p.join(timeout=30 if len(out) == world_size else 0)
                if p.is_alive():
                    p.kill()
                    p.join()
    return [out[r] for r in range(world_size)]
