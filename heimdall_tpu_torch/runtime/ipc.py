"""Inter-process frame transport and pub/sub messaging.

Completes the reference's stub IPC crate (rust/heimdall-ipc — manifest only:
shared_memory + zmq + bincode were declared, docs/architecture_design.md:
552-624 specifies a MessageBroker/IpcChannel design).  Two pieces:

* ``SharedMemoryFrameChannel`` — zero-copy frame transport between an
  acquisition process and the device-feeding process via
  multiprocessing.shared_memory, with a tiny seqlock-style header per slot
  (the shared_memory/memmap2 equivalent).
* ``MessageBroker`` — in-process topic pub/sub with queue-backed
  subscribers (the zmq pub/sub equivalent for single-host deployments;
  multi-host lines use collectives across hosts instead — SURVEY.md §2.3).

A copy of heimdall_tpu/runtime/ipc.py: the port imports nothing of the JAX
package.
"""

import logging
import queue
import struct
import threading
import time
from multiprocessing import shared_memory
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

logger = logging.getLogger("heimdall.ipc")

# per-slot header: sequence (u64), frame_id (u64), timestamp (f64)
_HEADER = struct.Struct("<QQd")


class SharedMemoryFrameChannel:
    """Fixed-slot SPSC frame channel over POSIX shared memory.

    The writer bumps the slot's sequence to odd while writing and even
    when done (seqlock); the reader retries on torn reads.  Create with
    ``create=True`` in the producer process and attach by name elsewhere.
    """

    def __init__(self, name: str, frame_shape: Tuple[int, ...] = (480, 640),
                 dtype=np.uint8, slots: int = 8, create: bool = False):
        self.frame_shape = tuple(frame_shape)
        self.dtype = np.dtype(dtype)
        self.slots = slots
        self.frame_bytes = int(np.prod(frame_shape)) * self.dtype.itemsize
        self.slot_bytes = _HEADER.size + self.frame_bytes
        total = self.slot_bytes * slots + 8   # + write cursor
        if create:
            try:
                old = shared_memory.SharedMemory(name=name)
                old.close()
                old.unlink()
            except FileNotFoundError:
                pass
            self.shm = shared_memory.SharedMemory(name=name, create=True,
                                                  size=total)
            self.shm.buf[:total] = b"\x00" * total
        else:
            self.shm = shared_memory.SharedMemory(name=name)
        self._owner = create
        self._write_idx = 0

    # -- producer ----------------------------------------------------------
    def write(self, frame: np.ndarray, frame_id: int) -> None:
        frame = np.ascontiguousarray(frame, self.dtype)
        slot = self._write_idx % self.slots
        off = 8 + slot * self.slot_bytes
        seq_off = off
        buf = self.shm.buf
        seq, _, _ = _HEADER.unpack_from(buf, seq_off)
        _HEADER.pack_into(buf, seq_off, seq + 1, frame_id, time.time())
        buf[off + _HEADER.size: off + _HEADER.size + self.frame_bytes] = \
            frame.tobytes()
        _HEADER.pack_into(buf, seq_off, seq + 2, frame_id, time.time())
        self._write_idx += 1
        struct.pack_into("<Q", buf, 0, self._write_idx)

    # -- consumer ----------------------------------------------------------
    def latest(self) -> Optional[Tuple[np.ndarray, int, float]]:
        """Read the most recent complete frame (None if nothing yet)."""
        buf = self.shm.buf
        write_idx = struct.unpack_from("<Q", buf, 0)[0]
        if write_idx == 0:
            return None
        for back in range(min(self.slots, write_idx)):
            slot = (write_idx - 1 - back) % self.slots
            off = 8 + slot * self.slot_bytes
            for _ in range(4):  # seqlock retries
                seq1, frame_id, ts = _HEADER.unpack_from(buf, off)
                if seq1 % 2:            # being written
                    continue
                data = bytes(buf[off + _HEADER.size:
                                 off + _HEADER.size + self.frame_bytes])
                seq2, _, _ = _HEADER.unpack_from(buf, off)
                if seq1 == seq2:
                    arr = np.frombuffer(data, self.dtype) \
                        .reshape(self.frame_shape)
                    return arr, frame_id, ts
        return None

    def close(self) -> None:
        self.shm.close()
        if self._owner:
            try:
                self.shm.unlink()
            except FileNotFoundError:
                pass

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


class Subscription:
    def __init__(self, topic: str, maxsize: int = 100):
        self.topic = topic
        self.queue: "queue.Queue" = queue.Queue(maxsize=maxsize)

    def get(self, timeout: Optional[float] = None) -> Any:
        return self.queue.get(timeout=timeout)

    def try_get(self) -> Optional[Any]:
        try:
            return self.queue.get_nowait()
        except queue.Empty:
            return None


class MessageBroker:
    """Topic pub/sub (architecture_design.md:552-624 MessageBroker)."""

    def __init__(self):
        self._subs: Dict[str, List[Subscription]] = {}
        self._lock = threading.Lock()
        self.published = 0
        self.dropped = 0

    def subscribe(self, topic: str, maxsize: int = 100) -> Subscription:
        sub = Subscription(topic, maxsize)
        with self._lock:
            self._subs.setdefault(topic, []).append(sub)
        return sub

    def unsubscribe(self, sub: Subscription) -> None:
        with self._lock:
            subs = self._subs.get(sub.topic, [])
            if sub in subs:
                subs.remove(sub)

    def publish(self, topic: str, message: Any) -> int:
        """Deliver to all subscribers; full queues drop (bounded latency).
        Returns number of deliveries."""
        with self._lock:
            subs = list(self._subs.get(topic, []))
        delivered = 0
        for sub in subs:
            try:
                sub.queue.put_nowait(message)
                delivered += 1
            except queue.Full:
                self.dropped += 1
        self.published += 1
        return delivered

    def stats(self) -> Dict[str, int]:
        with self._lock:
            return {"topics": len(self._subs),
                    "subscribers": sum(len(v) for v in self._subs.values()),
                    "published": self.published,
                    "dropped": self.dropped}
