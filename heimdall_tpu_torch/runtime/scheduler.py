"""Periodic/aperiodic task scheduling with deadline and jitter tracking.

Rebuilds rust/heimdall-rt's task layer (scheduler.rs:10-363, lib.rs:
104-229): RtTask kinds (periodic/aperiodic/sporadic) driven by a command
channel (execute/pause/resume/stop), per-task execution statistics
(min/max/avg execution time, deadline misses, period jitter), and an
RtScheduler collection.  Host threads stand in for tokio tasks; the C++
layer (native/heimdall_native.cpp hn_init_rt) provides CPU pinning and
SCHED_FIFO for threads that need it.

A copy of heimdall_tpu/runtime/scheduler.py: the port imports nothing of the JAX
package.
"""

import enum
import logging
import queue
import threading
import time
from dataclasses import dataclass
from typing import Any, Callable, Dict, Optional

from heimdall_tpu_torch import native_bridge

logger = logging.getLogger("heimdall.scheduler")


class TaskKind(enum.Enum):
    PERIODIC = "periodic"
    APERIODIC = "aperiodic"     # runs on execute() commands
    SPORADIC = "sporadic"       # like aperiodic with a minimum inter-arrival


class TaskCommand(enum.Enum):
    EXECUTE = "execute"
    PAUSE = "pause"
    RESUME = "resume"
    STOP = "stop"


@dataclass
class TaskStats:
    """Execution statistics (reference lib.rs:104-229 RtContext)."""
    executions: int = 0
    deadline_misses: int = 0
    min_exec_s: float = float("inf")
    max_exec_s: float = 0.0
    total_exec_s: float = 0.0
    min_jitter_s: float = float("inf")
    max_jitter_s: float = 0.0
    total_jitter_s: float = 0.0
    jitter_samples: int = 0

    @property
    def avg_exec_s(self) -> float:
        return self.total_exec_s / self.executions if self.executions else 0.0

    @property
    def avg_jitter_s(self) -> float:
        return self.total_jitter_s / self.jitter_samples \
            if self.jitter_samples else 0.0

    def to_dict(self) -> Dict[str, float]:
        return {
            "executions": self.executions,
            "deadline_misses": self.deadline_misses,
            "min_exec_ms": 0.0 if self.executions == 0
            else self.min_exec_s * 1000,
            "max_exec_ms": self.max_exec_s * 1000,
            "avg_exec_ms": self.avg_exec_s * 1000,
            "avg_jitter_us": self.avg_jitter_s * 1e6,
            "max_jitter_us": self.max_jitter_s * 1e6,
        }


class RtTask:
    """A scheduled task with its own thread and command channel."""

    def __init__(self, name: str, fn: Callable[[], Any],
                 kind: TaskKind = TaskKind.PERIODIC,
                 period_s: float = 0.1,
                 deadline_s: Optional[float] = None,
                 min_interarrival_s: float = 0.0,
                 cpu: int = -1, rt_priority: int = 0):
        self.name = name
        self.fn = fn
        self.kind = kind
        self.period_s = period_s
        self.deadline_s = deadline_s if deadline_s is not None else period_s
        self.min_interarrival_s = min_interarrival_s
        self.cpu = cpu
        self.rt_priority = rt_priority
        self.stats = TaskStats()
        self._commands: "queue.Queue" = queue.Queue()
        self._thread: Optional[threading.Thread] = None
        self._paused = False
        self._running = False
        self._last_sporadic = 0.0

    # ------------------------------------------------------------------
    def start(self) -> None:
        if self._running:
            return
        self._running = True
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name=f"rt_{self.name}")
        self._thread.start()

    def stop(self) -> None:
        if not self._running:
            return
        self._commands.put(TaskCommand.STOP)
        self._thread.join(timeout=2 * max(self.period_s, 0.5))
        self._running = False

    def execute(self) -> None:
        """Fire an aperiodic/sporadic task."""
        self._commands.put(TaskCommand.EXECUTE)

    def pause(self) -> None:
        self._commands.put(TaskCommand.PAUSE)

    def resume(self) -> None:
        self._commands.put(TaskCommand.RESUME)

    # ------------------------------------------------------------------
    def _run_once(self, scheduled_at: Optional[float]) -> None:
        start = time.perf_counter()
        if scheduled_at is not None:
            jitter = abs(start - scheduled_at)
            st = self.stats
            st.total_jitter_s += jitter
            st.jitter_samples += 1
            st.min_jitter_s = min(st.min_jitter_s, jitter)
            st.max_jitter_s = max(st.max_jitter_s, jitter)
        try:
            self.fn()
        except Exception as exc:  # noqa: BLE001 - tasks must not kill loop
            logger.error("task %s failed: %s", self.name, exc)
        elapsed = time.perf_counter() - start
        st = self.stats
        st.executions += 1
        st.total_exec_s += elapsed
        st.min_exec_s = min(st.min_exec_s, elapsed)
        st.max_exec_s = max(st.max_exec_s, elapsed)
        if elapsed > self.deadline_s:
            st.deadline_misses += 1
            logger.warning("task %s missed deadline: %.3fs > %.3fs",
                           self.name, elapsed, self.deadline_s)

    def _loop(self) -> None:
        lib = native_bridge._load()
        if lib is not None and (self.cpu >= 0 or self.rt_priority > 0):
            lib.hn_init_rt(self.cpu, self.rt_priority, 0)

        next_run = time.perf_counter()
        while True:
            if self.kind == TaskKind.PERIODIC:
                try:
                    timeout = max(next_run - time.perf_counter(), 0)
                    cmd = self._commands.get(timeout=timeout)
                except queue.Empty:
                    cmd = None
                if cmd == TaskCommand.STOP:
                    return
                if cmd == TaskCommand.PAUSE:
                    self._paused = True
                    continue
                if cmd == TaskCommand.RESUME:
                    self._paused = False
                    next_run = time.perf_counter()
                    continue
                if time.perf_counter() >= next_run:
                    if not self._paused:
                        self._run_once(next_run)
                    next_run += self.period_s
                    if next_run < time.perf_counter():  # overrun: resync
                        next_run = time.perf_counter() + self.period_s
            else:
                cmd = self._commands.get()
                if cmd == TaskCommand.STOP:
                    return
                if cmd == TaskCommand.PAUSE:
                    self._paused = True
                elif cmd == TaskCommand.RESUME:
                    self._paused = False
                elif cmd == TaskCommand.EXECUTE and not self._paused:
                    if self.kind == TaskKind.SPORADIC:
                        now = time.perf_counter()
                        if now - self._last_sporadic < \
                                self.min_interarrival_s:
                            continue   # enforce minimum inter-arrival
                        self._last_sporadic = now
                    self._run_once(None)


class RtScheduler:
    """Task collection (reference scheduler.rs RtScheduler)."""

    def __init__(self):
        self.tasks: Dict[str, RtTask] = {}

    def add_task(self, task: RtTask) -> RtTask:
        if task.name in self.tasks:
            self.tasks[task.name].stop()
        self.tasks[task.name] = task
        return task

    def start_all(self) -> None:
        for task in self.tasks.values():
            task.start()

    def stop_all(self) -> None:
        for task in self.tasks.values():
            task.stop()

    def stats(self) -> Dict[str, Dict[str, float]]:
        return {name: t.stats.to_dict() for name, t in self.tasks.items()}
