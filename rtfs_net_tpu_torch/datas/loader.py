"""Host-side data loader: prefetching batches of numpy arrays
(``rtfs_net_tpu/datas/loader.py``, copied).

Replaces torch ``DataLoader(num_workers=8, pin_memory, drop_last)``
(reference ``train.py:35-56``); the trainer pins and uploads the numpy
batches itself. Two worker backends:

  * ``thread`` — a thread pool. Right for audio-only loading (ranged WAV
    reads are IO-bound and release the GIL) and for single-core hosts,
    where a thread still overlaps decode with device dispatch while
    processes would add IPC for zero parallelism.
  * ``process`` — persistent spawn-based worker processes for the AV
    path (npz mouth-track inflate + video transforms), which is CPU-bound
    python/numpy and scales with cores only across processes. Workers
    decode AND collate whole batches, so IPC is one pickled batch per
    step.

``worker_type="auto"`` (default) picks ``process`` for AV datasets on
multi-core hosts, ``thread`` otherwise.

Workers import only ``rtfs_net_tpu_torch.datas`` (numpy-level code; the
package's ``__init__`` imports no torch), so spawn never loads torch or
creates a CUDA context per worker. The pool persists across epochs —
spawn+import costs are paid once, not per ``__iter__``.

For data parallelism across processes, pass ``shard_index/num_shards`` to
partition the sample space per process.
"""
from __future__ import annotations

import multiprocessing as mp
import pickle
import queue
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Iterator, Optional, Sequence

import numpy as np


def default_collate(samples: Sequence):
    """Stack tuple elements; non-array fields (utt ids) become lists."""
    first = samples[0]
    out = []
    for i in range(len(first)):
        vals = [s[i] for s in samples]
        if isinstance(first[i], np.ndarray):
            out.append(np.stack(vals))
        else:
            out.append(vals)
    return tuple(out)


# ---- process-worker plumbing (module-level so spawn can pickle it) ----
_WORKER_DS = None
_WORKER_COLLATE = None


def _worker_init(ds_bytes: bytes, collate_bytes: bytes) -> None:
    # Workers are slaves whose lifecycle the parent manages (close()
    # terminates the pool). Preemption signals are delivered to the whole
    # process GROUP on SLURM/k8s; if a worker died on SIGTERM its in-flight
    # task would never resolve and the trainer would hang in q.get()
    # instead of reaching the step boundary that writes the preempt
    # checkpoint — so workers ignore the signals the parent handles.
    import signal

    for sig in (signal.SIGINT, signal.SIGTERM, signal.SIGUSR1):
        try:
            signal.signal(sig, signal.SIG_IGN)
        except (ValueError, OSError):  # non-main thread / exotic platform
            pass
    # The parent blocked these signals around the spawn (mask is inherited)
    # so a group-delivered SIGTERM can't kill the worker during interpreter
    # bootstrap, before the SIG_IGN above exists. Unblock now that the
    # disposition is IGN — any signal queued while blocked is discarded.
    try:
        signal.pthread_sigmask(
            signal.SIG_UNBLOCK,
            {signal.SIGINT, signal.SIGTERM, signal.SIGUSR1})
    except (AttributeError, ValueError, OSError):
        pass
    global _WORKER_DS, _WORKER_COLLATE
    _WORKER_DS = pickle.loads(ds_bytes)
    _WORKER_COLLATE = pickle.loads(collate_bytes)


def _worker_batch(idxs):
    return _WORKER_COLLATE([_WORKER_DS[int(i)] for i in idxs])


class DataLoader:
    def __init__(
        self,
        dataset,
        batch_size: int,
        shuffle: bool = False,
        num_workers: int = 4,
        drop_last: bool = True,
        collate_fn: Callable = default_collate,
        seed: int = 0,
        shard_index: int = 0,
        num_shards: int = 1,
        prefetch: int = 2,
        worker_type: str = "auto",
    ):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.num_workers = max(1, num_workers)
        self.drop_last = drop_last
        self.collate_fn = collate_fn
        self.seed = seed
        self.epoch = 0
        self.shard_index = shard_index
        self.num_shards = num_shards
        self.prefetch = prefetch
        if worker_type == "auto":
            import os

            # AV decode is CPU-bound python/numpy -> process workers, but
            # only where cores exist: on a single-core host processes add
            # IPC for zero parallelism (threads still overlap decode with
            # device dispatch). Audio-only decode is IO-bound -> threads.
            multicore = (os.cpu_count() or 1) > 2
            worker_type = ("process"
                           if multicore and not getattr(dataset, "audio_only", True)
                           else "thread")
        if worker_type not in ("thread", "process"):
            raise ValueError(f"worker_type {worker_type!r}")
        self.worker_type = worker_type
        self._pool: Optional[mp.pool.Pool] = None

    def __len__(self):
        n = len(self.dataset) // self.num_shards
        if self.drop_last:
            return n // self.batch_size
        return -(-n // self.batch_size)

    def set_epoch(self, epoch: int):
        self.epoch = epoch

    def close(self):
        if self._pool is None:
            return
        pool, self._pool = self._pool, None
        # Workers SIG_IGN SIGTERM by design (group-delivered preemption
        # signals must not kill them mid-epoch — see _worker_init), which
        # removes Pool.terminate()'s backstop: normally workers exit via
        # the task handler's per-worker None sentinels, but a worker
        # that is mid-task at terminate time (or whose sentinel got eaten
        # by CPython's _help_stuff_finish inqueue drain) survives the
        # ignored SIGTERM and terminate()'s internal join waits on it
        # forever (observed as a full-suite deadlock: parent in do_wait,
        # worker in futex_wait for 1h+). So: run terminate() in a daemon
        # thread, and SIGKILL surviving workers only if it hasn't
        # finished within the grace window. SIGKILL must NOT come first:
        # a worker killed while blocked in inqueue.get() dies HOLDING the
        # queue's reader lock (a shared POSIX semaphore), and
        # _help_stuff_finish then deadlocks acquiring it — the sentinel
        # path releases locks cleanly, so it gets the first chance.
        # Workers are stateless slaves (decoded batches live in the
        # parent), so killing survivors loses nothing.
        procs = list(getattr(pool, "_pool", []))
        done = threading.Event()

        def _shutdown():
            try:
                pool.terminate()
            finally:
                done.set()

        t = threading.Thread(target=_shutdown, daemon=True)
        t.start()
        if not done.wait(5.0):
            for p in procs:
                try:
                    if p.is_alive():
                        p.kill()
                except Exception:
                    pass
            # post-kill the joins return promptly; if something is still
            # wedged we abandon the daemon shutdown thread rather than
            # hang the caller
            done.wait(10.0)

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass

    def _indices(self) -> np.ndarray:
        idx = np.arange(len(self.dataset))
        if self.shuffle:
            rng = np.random.default_rng(self.seed + self.epoch)
            rng.shuffle(idx)
        return idx[self.shard_index::self.num_shards]

    def _get_pool(self) -> mp.pool.Pool:
        if self._pool is None:
            import signal

            ctx = mp.get_context("spawn")
            # Block the preemption signals while spawning: children inherit
            # the mask, so a group-delivered SIGTERM landing during worker
            # bootstrap (before _worker_init installs SIG_IGN) stays pending
            # instead of killing the worker — whose lost in-flight task
            # would hang the fit loop past the preemption grace window.
            sigs = {signal.SIGINT, signal.SIGTERM, signal.SIGUSR1}
            try:
                old_mask = signal.pthread_sigmask(signal.SIG_BLOCK, sigs)
            except (AttributeError, ValueError, OSError):
                old_mask = None
            try:
                self._pool = ctx.Pool(
                    self.num_workers,
                    initializer=_worker_init,
                    initargs=(pickle.dumps(self.dataset),
                              pickle.dumps(self.collate_fn)),
                )
            finally:
                if old_mask is not None:
                    signal.pthread_sigmask(signal.SIG_SETMASK, old_mask)
        return self._pool

    def __iter__(self) -> Iterator:
        idx = self._indices()
        n_batches = len(self)
        batches = [
            idx[b * self.batch_size:(b + 1) * self.batch_size]
            for b in range(n_batches)
        ]
        q: "queue.Queue" = queue.Queue(maxsize=self.prefetch)
        stop = threading.Event()

        def put_or_stop(item) -> bool:
            # stop-aware bounded put: a consumer that abandons iteration
            # mid-epoch (preemption, test teardown) sets `stop`, and the
            # producer must not stay blocked forever in q.put() holding
            # decoded batches
            while True:
                try:
                    q.put(item, timeout=0.2)
                    return True
                except queue.Full:
                    if stop.is_set():
                        return False

        if self.worker_type == "process":
            pool = self._get_pool()

            def produce():
                # bounded in-flight window = backpressure: the pool never
                # runs more than prefetch+workers batches ahead of the
                # consumer, so decoded batches can't pile up in memory
                window = self.prefetch + self.num_workers
                inflight: "queue.Queue" = queue.Queue()
                it = iter(batches)
                for _ in range(window):
                    b = next(it, None)
                    if b is None:
                        break
                    inflight.put(pool.apply_async(_worker_batch, (b,)))
                while not inflight.empty():
                    if stop.is_set():
                        return
                    res = inflight.get()
                    while True:  # poll so a dead worker can't hang us
                        try:
                            val = res.get(1.0)
                            break
                        except mp.TimeoutError:
                            if stop.is_set():
                                return
                    if not put_or_stop(val):
                        return
                    b = next(it, None)
                    if b is not None:
                        inflight.put(pool.apply_async(_worker_batch, (b,)))
        else:
            def produce():
                with ThreadPoolExecutor(self.num_workers) as tpool:
                    for batch_idx in batches:
                        if stop.is_set():
                            return
                        samples = list(
                            tpool.map(self.dataset.__getitem__, batch_idx))
                        if not put_or_stop(self.collate_fn(samples)):
                            return

        def producer():
            try:
                produce()
                put_or_stop(None)
            except Exception as e:  # surface worker failures to the consumer
                put_or_stop(e)

        thread = threading.Thread(target=producer, daemon=True)
        thread.start()
        try:
            while True:
                item = q.get()
                if item is None:
                    break
                if isinstance(item, Exception):
                    raise item
                yield item
        finally:
            stop.set()
