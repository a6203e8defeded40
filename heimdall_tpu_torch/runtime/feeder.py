"""Host→device frame feeding: ring buffers, native camera producers, a
pinned-buffer uploader and a double-buffered device feeder (port of
heimdall_tpu/runtime/feeder.py).

This is where the reference's RT/acquisition machinery meets the card
(SURVEY.md §2.3): pinned C++ producer threads fill a lock-free ring
(rust/heimdall-rt/src/sync.rs, heimdall-gige frame channel), the Python
side drains batches, and the DeviceFeeder overlaps the host→device upload
of batch N+1 with the card's work on batch N.  JAX gets that overlap from
its asynchronous ``device_put``; here a PinnedUploader copies each batch
into a page-locked slot and uploads it on a copy stream that the compute
stream waits on, and results come back through a ``HostFetcher`` after
an event recorded when their batch was submitted, so fetching batch N never
waits for batch N+1's work.

FrameRing and NativeCameraFeeder are copies of the JAX package's (the
native ring and producer through native_bridge, the Python producer on
the port's SimulationImageSource and ``ops/color.bgr_to_gray`` on the
CPU).
"""

import ctypes
import logging
import threading
import time
from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np
import torch

from heimdall_tpu_torch import native_bridge

logger = logging.getLogger("heimdall.feeder")


class FrameRing:
    """Lock-free SPSC frame ring (native-backed, Python deque fallback)."""

    def __init__(self, capacity: int, frame_shape: Tuple[int, ...]):
        self.frame_shape = tuple(frame_shape)
        self.frame_bytes = int(np.prod(frame_shape))
        self.capacity = capacity
        self._lib = native_bridge._load()
        if self._lib is not None:
            self._ring = self._lib.hn_ring_create(capacity, self.frame_bytes)
            self._fallback = None
        else:
            import collections
            self._ring = None
            self._fallback = collections.deque(maxlen=capacity)
            self._drops = 0
            self._pushes = 0
            self._pops = 0

    def push(self, frame: np.ndarray, frame_id: int = 0) -> bool:
        frame = np.ascontiguousarray(frame, np.uint8)
        if self._ring is not None:
            return self._lib.hn_ring_push(
                self._ring,
                frame.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
                frame_id) == 0
        self._pushes += 1
        if len(self._fallback) == self.capacity:
            self._drops += 1
            return False
        self._fallback.append((frame.copy(), frame_id, time.time()))
        return True

    def pop(self) -> Optional[Tuple[np.ndarray, int, float]]:
        """Returns (frame, frame_id, latency_us) or None if empty."""
        if self._ring is not None:
            out = np.empty(self.frame_bytes, np.uint8)
            fid = ctypes.c_uint64()
            lat = ctypes.c_double()
            rc = self._lib.hn_ring_pop(
                self._ring,
                out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
                ctypes.byref(fid), ctypes.byref(lat))
            if rc != 0:
                return None
            return out.reshape(self.frame_shape), fid.value, lat.value
        try:
            frame, fid, ts = self._fallback.popleft()
            self._pops += 1
            return frame.reshape(self.frame_shape), fid, \
                (time.time() - ts) * 1e6
        except IndexError:
            return None

    def pop_batch(self, n: int, timeout_s: float = 1.0) -> np.ndarray:
        """Block until n frames are available (or timeout); returns
        [m, *frame_shape] with m <= n."""
        frames = []
        deadline = time.time() + timeout_s
        while len(frames) < n and time.time() < deadline:
            item = self.pop()
            if item is None:
                time.sleep(0.0005)
                continue
            frames.append(item[0])
        if not frames:
            return np.empty((0,) + self.frame_shape, np.uint8)
        return np.stack(frames)

    def size(self) -> int:
        if self._ring is not None:
            return self._lib.hn_ring_size(self._ring)
        return len(self._fallback)

    def stats(self) -> Dict[str, float]:
        if self._ring is not None:
            out = (ctypes.c_double * 6)()
            self._lib.hn_ring_stats(self._ring, out)
            return {"pushes": out[0], "pops": out[1], "drops": out[2],
                    "latency_mean_us": out[3], "latency_std_us": out[4],
                    "latency_max_us": out[5]}
        return {"pushes": float(self._pushes), "pops": float(self._pops),
                "drops": float(self._drops), "latency_mean_us": 0.0,
                "latency_std_us": 0.0, "latency_max_us": 0.0}

    def close(self) -> None:
        if self._ring is not None:
            self._lib.hn_ring_destroy(self._ring)
            self._ring = None

    def __del__(self):  # pragma: no cover
        try:
            self.close()
        except Exception:
            pass


class NativeCameraFeeder:
    """A native producer thread synthesizing paced camera frames into a ring
    (the simulated-GigE equivalent; real cameras plug in at this seam)."""

    def __init__(self, width: int = 640, height: int = 480, fps: float = 30,
                 defect_probability: float = 0.1, capacity: int = 32,
                 cpu: int = -1, rt_priority: int = 0, seed: int = 0):
        self.width, self.height = width, height
        self.ring = FrameRing(capacity, (height, width))
        self._lib = native_bridge._load()
        self._cam = None
        self._py_thread = None
        self._py_stop = threading.Event()
        self.fps = fps
        self.defect_probability = defect_probability
        self.cpu = cpu
        self.rt_priority = rt_priority
        self.seed = seed

    def start(self) -> None:
        if self._lib is not None and self.ring._ring is not None:
            self._cam = self._lib.hn_camera_start(
                self.ring._ring, self.width, self.height,
                ctypes.c_double(self.fps),
                ctypes.c_double(self.defect_probability),
                self.cpu, self.rt_priority, self.seed or 12345)
            return
        # Python fallback producer
        from heimdall_tpu_torch.core.acquisition import SimulationImageSource
        src = SimulationImageSource("native_fallback", {
            "width": self.width, "height": self.height,
            "defect_probability": self.defect_probability,
            "seed": self.seed or None})
        src.open()

        def loop():
            period = 1.0 / self.fps
            fid = 0
            while not self._py_stop.is_set():
                _, frame = src.read()
                from heimdall_tpu_torch.ops.color import bgr_to_gray
                gray = bgr_to_gray(torch.from_numpy(frame)).numpy()
                self.ring.push(gray, fid)
                fid += 1
                time.sleep(period)

        self._py_thread = threading.Thread(target=loop, daemon=True)
        self._py_thread.start()

    def stop(self) -> None:
        if self._cam is not None:
            self._lib.hn_camera_stop(self._cam)
            self._cam = None
        if self._py_thread is not None:
            self._py_stop.set()
            self._py_thread.join(timeout=2)
            self._py_thread = None

    def stats(self) -> Dict[str, float]:
        out = dict(self.ring.stats())
        if self._cam is not None:
            arr = (ctypes.c_double * 3)()
            self._lib.hn_camera_stats(self._cam, arr)
            out.update({"frames_produced": arr[0],
                        "pacing_jitter_mean_us": arr[1],
                        "pacing_jitter_max_us": arr[2]})
        return out

    def __enter__(self):
        self.start()
        return self

    def __exit__(self, *exc):
        self.stop()


def _map_tensors(tree, fn):
    """tree with fn applied to every tensor in its tuples, lists and dicts
    (named tuples keep their type); other values pass through."""
    if isinstance(tree, torch.Tensor):
        return fn(tree)
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_map_tensors(v, fn) for v in tree))
    if isinstance(tree, (tuple, list)):
        return type(tree)(_map_tensors(v, fn) for v in tree)
    if isinstance(tree, dict):
        return {k: _map_tensors(v, fn) for k, v in tree.items()}
    return tree


def _tensors(tree):
    """The tensors in a result tree's tuples, lists and dicts."""
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, (tuple, list)):
        for v in tree:
            yield from _tensors(v)
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _tensors(v)


def _cuda_tensor(tree) -> Optional[torch.Tensor]:
    """The first CUDA tensor of a result tree, or None."""
    return next((t for t in _tensors(tree) if t.is_cuda), None)


def record_done(tree) -> Optional["torch.cuda.Event"]:
    """An event recorded on the current stream of the device that holds
    the tree's CUDA tensors (None when it holds none): it completes when
    the work queued so far, the tree's included, has finished."""
    t = _cuda_tensor(tree)
    if t is None:
        return None
    done = torch.cuda.Event()
    done.record(torch.cuda.current_stream(t.device))
    return done


class HostFetcher:
    """Host copies of device results without waiting for later work.

    ``fetch(tree, done)`` waits for ``done`` (an event recorded when the
    tree's batch was submitted), then copies every tensor of the tree to
    numpy on a stream of its own: the compute stream may already hold the
    next batches' work, and a copy queued behind it would wait for them.
    A tree without CUDA tensors is copied as is (the CPU path)."""

    def __init__(self):
        self._streams = {}

    def fetch(self, tree, done=None):
        """One host copy (numpy) of every tensor in the tree's tuples,
        lists and dicts (named tuples keep their type); values that are
        not tensors pass through.  With ``done`` (``record_done`` at
        submit) only that batch's work is waited for; without it, the
        current stream's."""
        t = _cuda_tensor(tree)
        if t is None:
            return _map_tensors(tree, lambda x: x.numpy().copy())
        if done is not None:
            done.synchronize()
        else:
            torch.cuda.current_stream(t.device).synchronize()
        stream = self._streams.get(t.device)
        if stream is None:
            stream = self._streams[t.device] = torch.cuda.Stream(t.device)
        with torch.cuda.stream(stream):
            return _map_tensors(tree, lambda x: x.cpu().numpy())


class PinnedUploader:
    """Uploads numpy batches through ``slots`` page-locked host slots.

    ``upload(batch)`` copies the batch into the next free slot (or uses the
    slot itself, when ``batch`` is the array that ``host_slot`` handed
    out), issues the copy to the device with ``non_blocking=True`` on a
    copy stream, makes the caller's current (compute) stream wait for it,
    and returns the device tensor at once: the upload overlaps whatever the
    card and the host do meanwhile.  The caller may overwrite its own
    array as soon as ``upload`` returns.

    A slot is written again only after the event recorded behind its last
    copy has completed (a ``non_blocking`` copy from page-locked memory
    returns before the DMA does), and each device tensor is
    ``record_stream``-ed on the compute stream, so the caching allocator
    does not hand its memory out again while the compute stream still
    reads it.  Keep ``slots`` at the feeder's ``max_in_flight + 1``: a
    slot then comes round again only after its batch's copy has long
    finished, and ``host_slot`` does not wait.

    ``device`` is CUDA unless "cpu" is named (raises where there is no
    card); on the CPU ``upload`` returns a copy of the batch."""

    def __init__(self, slots: int = 3, device=None):
        from heimdall_tpu_torch.detectors.contamination_detector import (
            resolve_device)
        if slots < 1:
            raise ValueError(f"slots must be >= 1, got {slots}")
        self.device = resolve_device(device)
        self.slots = slots
        self._host = [None] * slots          # flat uint8 tensors
        self._done = [None] * slots          # event behind each slot's copy
        self._next = 0
        self._handed = None                  # (slot, numpy view)
        self._copy_stream = None

    def host_slot(self, shape, dtype=np.uint8) -> np.ndarray:
        """The next slot as a numpy array of shape and dtype, once its last
        copy has completed; ``upload`` of this array copies nothing on the
        host."""
        slot = self._next
        self._next = (slot + 1) % self.slots
        if self._done[slot] is not None:
            self._done[slot].synchronize()
            self._done[slot] = None
        dtype = np.dtype(dtype)
        nbytes = int(np.prod(shape)) * dtype.itemsize
        buf = self._host[slot]
        if buf is None or buf.numel() < nbytes:
            buf = torch.empty(nbytes, dtype=torch.uint8,
                              pin_memory=self.device.type == "cuda")
            self._host[slot] = buf
        view = buf[:nbytes].numpy().view(dtype).reshape(shape)
        self._handed = (slot, view)
        return view

    def upload(self, batch: np.ndarray) -> torch.Tensor:
        """The batch on the device (see the class)."""
        if self._handed is not None and batch is self._handed[1]:
            slot, view = self._handed
        else:
            batch = np.asarray(batch)
            view = self.host_slot(batch.shape, batch.dtype)
            slot = self._handed[0]
            np.copyto(view, batch)
        self._handed = None
        host = torch.from_numpy(view)
        if self.device.type != "cuda":
            return host.clone()
        compute = torch.cuda.current_stream(self.device)
        if self._copy_stream is None:
            self._copy_stream = torch.cuda.Stream(self.device)
        copy = self._copy_stream
        with torch.cuda.stream(copy):
            out = host.to(self.device, non_blocking=True)
            done = torch.cuda.Event()
            done.record(copy)
        compute.wait_event(done)
        out.record_stream(compute)
        self._done[slot] = done
        return out


class DeviceFeeder:
    """Double-buffered host→device pipeline.

    Submits batch N+1's upload and device work while batch N's results are
    still in flight; CUDA's asynchronous launches queue device work so the
    card never waits on the host (the reference's semaphore-limited
    parallel acquisition, heimdall-gige/src/lib.rs:113-134, maps to this
    queue depth).  ``step_fn(batch)`` returns device results (a tensor or
    a tuple, list or dict of them); a ``PinnedUploader`` with
    ``max_in_flight + 1`` slots gives it asynchronous uploads.  Each result
    is copied to the host (numpy) after an event recorded when it was
    submitted, on a stream of its own, so fetching batch N does not wait
    for batch N+1.

    Two completion modes:

    - default (pull): ``submit`` returns the completed (result, meta) of an
      older batch once the pipeline is over-full, None while filling.
      Simple, but a paced producer (e.g. a 25 fps stream) only learns a
      verdict ``max_in_flight`` frame periods after submitting it — queue
      waiting, not device time, dominates the observed latency.
    - ``on_done`` (push): a collector thread fetches each result as soon as
      the device finishes it (FIFO — device execution is in submission
      order) and calls ``on_done(result, meta)`` from that thread.  The
      read→verdict latency a caller measures in ``on_done`` is the true
      transfer+compute+readback critical path, while ``submit`` stays
      non-blocking until ``max_in_flight`` results are pending (then it
      applies backpressure).
    """

    def __init__(self, step_fn: Callable[[np.ndarray], Any],
                 max_in_flight: int = 2,
                 on_done: Optional[Callable[[Any, Any], None]] = None):
        self.step_fn = step_fn
        self.max_in_flight = max_in_flight
        self._in_flight = []
        self._on_done = on_done
        self._queue = None
        self._collector = None
        self._fetcher = HostFetcher()
        if on_done is not None:
            import queue as _queue
            self._queue = _queue.Queue(maxsize=max_in_flight)
            self._collector = threading.Thread(target=self._collect_loop,
                                               daemon=True)
            self._collector.start()

    def _collect_loop(self):
        while True:
            item = self._queue.get()
            if item is None:
                self._queue.task_done()
                return
            out, done, meta = item
            try:
                self._on_done(self._fetcher.fetch(out, done), meta)
            except Exception:  # pragma: no cover - surfaced via logger
                logger.exception("DeviceFeeder on_done failed")
            finally:
                self._queue.task_done()

    def submit(self, batch: np.ndarray, meta: Any = None):
        """Submit a batch.

        Pull mode: returns the completed (result, meta) of an older batch
        once the pipeline is full (None while filling).  Push mode
        (``on_done`` given): always returns None; blocks only when
        ``max_in_flight`` results are already pending collection.  ``meta``
        rides along untouched — callers use it for frame ids / deadline
        timestamps."""
        out = self.step_fn(batch)
        done = record_done(out)
        if self._queue is not None:
            self._queue.put((out, done, meta))
            return None
        self._in_flight.append((out, done, meta))
        if len(self._in_flight) > self.max_in_flight:
            ready, rdone, rmeta = self._in_flight.pop(0)
            got = self._fetcher.fetch(ready, rdone)
            return (got, rmeta) if rmeta is not None else got
        return None

    def drain(self):
        """Pull mode: fetch and return all in-flight (result, meta) pairs.
        Push mode: block until the collector has delivered every pending
        result via ``on_done``; returns []."""
        if self._queue is not None:
            self._queue.join()
            return []
        results = [(self._fetcher.fetch(r, d), m) if m is not None
                   else self._fetcher.fetch(r, d)
                   for r, d, m in self._in_flight]
        self._in_flight.clear()
        return results

    def close(self):
        """Stop the collector thread (push mode); drains first."""
        if self._queue is not None:
            self._queue.join()
            self._queue.put(None)
            self._collector.join(timeout=5)
            self._queue = None
            self._collector = None
