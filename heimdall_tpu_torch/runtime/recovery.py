"""Failure detection and recovery: error taxonomy + retry machinery.

Rebuilds the reference's best-developed aux subsystem (SURVEY.md §5;
rust/heimdall-gige/src/error.rs:12-245): a typed error hierarchy with
Transient/Permanent/Fatal categories, per-error recovery strategies
(Retry / ResetDevice / ResetConnection / RestartSystem / Custom), a
generic ``with_recovery`` retry wrapper with exponential backoff, and
fault-injection helpers used by the fakes and the test-suite.

A copy of heimdall_tpu/runtime/recovery.py: the port imports nothing of the JAX
package.
"""

import enum
import logging
import random
import threading
import time
from dataclasses import dataclass, field
from typing import Any, Callable, Optional

logger = logging.getLogger("heimdall.recovery")


class ErrorCategory(enum.Enum):
    TRANSIENT = "transient"    # retry likely to succeed
    PERMANENT = "permanent"    # needs device/connection reset
    FATAL = "fatal"            # needs operator / system restart


class RecoveryAction(enum.Enum):
    RETRY = "retry"
    RESET_DEVICE = "reset_device"
    RESET_CONNECTION = "reset_connection"
    RESTART_SYSTEM = "restart_system"
    CUSTOM = "custom"


class HeimdallError(Exception):
    """Base error with a category and a default recovery strategy."""

    category = ErrorCategory.TRANSIENT

    def __init__(self, message: str,
                 category: Optional[ErrorCategory] = None):
        super().__init__(message)
        if category is not None:
            self.category = category


class AcquisitionError(HeimdallError):
    category = ErrorCategory.TRANSIENT


class TimeoutError_(HeimdallError):
    category = ErrorCategory.TRANSIENT


class DeviceError(HeimdallError):
    category = ErrorCategory.PERMANENT


class ConnectionError_(HeimdallError):
    category = ErrorCategory.PERMANENT


class ConfigurationError(HeimdallError):
    category = ErrorCategory.FATAL


class DeviceLostError(HeimdallError):
    """Accelerator dropped (preemption / reset) — the inspection analog of a
    camera disconnect; recovery re-creates device buffers and recompiles."""
    category = ErrorCategory.PERMANENT


@dataclass
class RecoveryStrategy:
    """Per-error recovery policy (reference error.rs:87-205)."""
    retry_count: int = 3
    delay_s: float = 0.1
    backoff: float = 2.0
    max_delay_s: float = 1.0
    action: RecoveryAction = RecoveryAction.RETRY
    custom_handler: Optional[Callable[[Exception], None]] = None

    @classmethod
    def for_error(cls, exc: Exception) -> "RecoveryStrategy":
        category = getattr(exc, "category", ErrorCategory.TRANSIENT)
        if category == ErrorCategory.TRANSIENT:
            return cls(retry_count=3, delay_s=0.1,
                       action=RecoveryAction.RETRY)
        if category == ErrorCategory.PERMANENT:
            return cls(retry_count=1, delay_s=0.5,
                       action=RecoveryAction.RESET_DEVICE)
        return cls(retry_count=0, action=RecoveryAction.RESTART_SYSTEM)


def with_recovery(fn: Callable[[], Any],
                  strategy: Optional[RecoveryStrategy] = None,
                  on_reset: Optional[Callable[[], None]] = None,
                  name: str = "operation") -> Any:
    """Run ``fn`` with the reference's retry semantics (error.rs:208-245).

    Retries with exponential backoff per the (error-derived) strategy; for
    RESET_* actions calls ``on_reset`` between attempts.  Re-raises the
    last error when recovery is exhausted.
    """
    attempt = 0
    last_exc: Optional[Exception] = None
    while True:
        try:
            return fn()
        except Exception as exc:  # noqa: BLE001 - recovery boundary
            last_exc = exc
            strat = strategy or RecoveryStrategy.for_error(exc)
            if attempt >= strat.retry_count:
                logger.error("%s failed after %d attempts: %s",
                             name, attempt + 1, exc)
                raise
            if strat.action in (RecoveryAction.RESET_DEVICE,
                                RecoveryAction.RESET_CONNECTION) \
                    and on_reset is not None:
                logger.warning("%s: %s -> %s", name, exc, strat.action.value)
                on_reset()
            elif strat.action == RecoveryAction.CUSTOM \
                    and strat.custom_handler is not None:
                strat.custom_handler(exc)
            delay = min(strat.delay_s * (strat.backoff ** attempt),
                        strat.max_delay_s)
            logger.info("%s attempt %d failed (%s); retrying in %.2fs",
                        name, attempt + 1, exc, delay)
            time.sleep(delay)
            attempt += 1


@dataclass
class FaultInjector:
    """Deterministic fault injection for tests and fakes (the reference
    injects 1% acquisition failures — gige/camera.rs:619-622)."""
    failure_probability: float = 0.01
    seed: int = 0
    _rng: random.Random = field(default=None, repr=False)

    def __post_init__(self):
        self._rng = random.Random(self.seed)

    def maybe_fail(self, exc_factory=AcquisitionError,
                   message: str = "injected fault") -> None:
        if self._rng.random() < self.failure_probability:
            raise exc_factory(message)


class CircuitBreakerOpen(HeimdallError):
    category = ErrorCategory.PERMANENT


class CircuitBreaker:
    """Closed → open → half-open circuit breaker.

    The reference designed (but never built) this in
    docs/architecture_design.md:784-831: after ``failure_threshold``
    consecutive failures the circuit opens and calls fail fast for
    ``reset_timeout_s``; then one probe call is allowed (half-open) and
    success re-closes the circuit.
    """

    def __init__(self, failure_threshold: int = 5,
                 reset_timeout_s: float = 30.0, name: str = "breaker"):
        self.failure_threshold = failure_threshold
        self.reset_timeout_s = reset_timeout_s
        self.name = name
        self.state = "closed"
        self.consecutive_failures = 0
        self._opened_at = 0.0
        self._lock = threading.Lock()

    def call(self, fn: Callable[[], Any]) -> Any:
        with self._lock:
            if self.state == "open":
                if time.time() - self._opened_at >= self.reset_timeout_s:
                    self.state = "half_open"
                    logger.info("%s: half-open (probe allowed)", self.name)
                else:
                    raise CircuitBreakerOpen(
                        f"{self.name} open "
                        f"({self.consecutive_failures} failures)")
        try:
            result = fn()
        except Exception:
            with self._lock:
                self.consecutive_failures += 1
                if (self.state == "half_open"
                        or self.consecutive_failures
                        >= self.failure_threshold):
                    self.state = "open"
                    self._opened_at = time.time()
                    logger.warning("%s: OPEN after %d failures",
                                   self.name, self.consecutive_failures)
            raise
        with self._lock:
            self.consecutive_failures = 0
            if self.state != "closed":
                logger.info("%s: closed", self.name)
            self.state = "closed"
        return result


class Watchdog:
    """Heartbeat watchdog (architecture_design.md watchdog design):
    fires ``on_timeout`` when ``kick()`` is not called within
    ``timeout_s`` — wraps hung acquisition or device loops."""

    def __init__(self, timeout_s: float,
                 on_timeout: Callable[[], None],
                 check_interval_s: float = None, name: str = "watchdog"):
        self.timeout_s = timeout_s
        self.on_timeout = on_timeout
        self.check_interval_s = check_interval_s or max(timeout_s / 4,
                                                        0.005)
        self.name = name
        self._last_kick = time.time()
        self._thread: Optional[threading.Thread] = None
        self._stop = threading.Event()
        self.timeouts = 0

    def kick(self) -> None:
        self._last_kick = time.time()

    def start(self) -> None:
        self._stop.clear()
        self._last_kick = time.time()
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=2)
            self._thread = None

    def _loop(self) -> None:
        while not self._stop.is_set():
            if time.time() - self._last_kick > self.timeout_s:
                self.timeouts += 1
                logger.error("%s: heartbeat missed (>%.2fs)", self.name,
                             self.timeout_s)
                try:
                    self.on_timeout()
                except Exception:  # noqa: BLE001
                    logger.exception("watchdog handler failed")
                self._last_kick = time.time()   # avoid storming
            time.sleep(self.check_interval_s)
