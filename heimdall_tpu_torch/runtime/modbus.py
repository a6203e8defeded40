"""Modbus/TCP transport for the PLC client.

The reference declares modbus PLC comms in its config defaults
(heimdall/core/config.py:50-61: protocol "modbus", 192.168.1.100:502,
rejection delay 100 ms / pulse 50 ms) but never implements the wire
protocol — rejection is a log stub (heimdall/core/system.py:152-160).
This module supplies the real framer so ``PLCClient(transport=
ModbusTCPTransport())`` talks to an actual line controller.

Implements the Modbus/TCP application protocol (MBAP header + PDU):

  * FC 0x03 read holding registers
  * FC 0x06 write single register
  * FC 0x10 write multiple registers

Strictly validated: transaction-id matching, exception responses raised as
ModbusError with the standard exception-code names, short-read handling,
and a socket timeout so a dead PLC fails fast into the recovery layer
(runtime/recovery.py) rather than hanging the reject path.

A copy of heimdall_tpu/runtime/modbus.py: the port imports nothing of the JAX
package.
"""

import socket
import struct
import threading
from typing import List, Optional

MODBUS_PORT = 502
_PROTOCOL_ID = 0

_EXCEPTIONS = {
    1: "ILLEGAL FUNCTION",
    2: "ILLEGAL DATA ADDRESS",
    3: "ILLEGAL DATA VALUE",
    4: "SERVER DEVICE FAILURE",
    5: "ACKNOWLEDGE",
    6: "SERVER DEVICE BUSY",
    8: "MEMORY PARITY ERROR",
    10: "GATEWAY PATH UNAVAILABLE",
    11: "GATEWAY TARGET DEVICE FAILED TO RESPOND",
}


class ModbusError(IOError):
    """Modbus exception response or malformed frame."""

    def __init__(self, message: str, exception_code: Optional[int] = None):
        super().__init__(message)
        self.exception_code = exception_code


class ModbusTCPTransport:
    """PLCClient transport speaking Modbus/TCP over a blocking socket.

    Thread-safe: one request/response exchange at a time (the reject path
    and the heartbeat may fire from different threads).
    """

    def __init__(self, unit_id: int = 1, timeout_s: float = 2.0):
        self.unit_id = unit_id
        self.timeout_s = timeout_s
        self._sock: Optional[socket.socket] = None
        self._txn = 0
        self._lock = threading.Lock()

    # -- PLCClient transport protocol ---------------------------------------
    def connect(self, ip: str, port: int = MODBUS_PORT) -> bool:
        self.disconnect()
        sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        sock.settimeout(self.timeout_s)
        sock.connect((ip, port))
        sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        self._sock = sock
        return True

    def disconnect(self) -> None:
        if self._sock is not None:
            try:
                self._sock.close()
            finally:
                self._sock = None

    def read_register(self, address: int) -> int:
        return self.read_registers(address, 1)[0]

    def write_register(self, address: int, value: int) -> None:
        pdu = struct.pack(">BHH", 0x06, address, value & 0xFFFF)
        resp = self._exchange(pdu)
        if resp != pdu:
            raise ModbusError("write echo mismatch")

    # -- bulk operations -----------------------------------------------------
    def read_registers(self, address: int, count: int) -> List[int]:
        if not 1 <= count <= 125:
            raise ValueError("count must be in [1, 125]")
        resp = self._exchange(struct.pack(">BHH", 0x03, address, count))
        fc, nbytes = struct.unpack(">BB", resp[:2])
        if fc != 0x03 or nbytes != 2 * count or len(resp) != 2 + nbytes:
            raise ModbusError("malformed read response")
        return list(struct.unpack(f">{count}H", resp[2:]))

    def write_registers(self, address: int, values: List[int]) -> None:
        if not 1 <= len(values) <= 123:
            raise ValueError("1 to 123 registers per write")
        pdu = (struct.pack(">BHHB", 0x10, address, len(values),
                           2 * len(values))
               + struct.pack(f">{len(values)}H",
                             *[v & 0xFFFF for v in values]))
        resp = self._exchange(pdu)
        if resp != struct.pack(">BHH", 0x10, address, len(values)):
            raise ModbusError("malformed write-multiple response")

    # -- framing -------------------------------------------------------------
    def _exchange(self, pdu: bytes) -> bytes:
        """Send one PDU, return the response PDU (sans unit id)."""
        with self._lock:
            if self._sock is None:
                raise ConnectionError("modbus transport not connected")
            self._txn = (self._txn + 1) & 0xFFFF
            mbap = struct.pack(">HHHB", self._txn, _PROTOCOL_ID,
                               len(pdu) + 1, self.unit_id)
            self._sock.sendall(mbap + pdu)

            header = self._recv_exact(7)
            txn, proto, length, unit = struct.unpack(">HHHB", header)
            if txn != self._txn or proto != _PROTOCOL_ID:
                raise ModbusError(
                    f"MBAP mismatch (txn {txn} != {self._txn})")
            if unit != self.unit_id:
                raise ModbusError(f"unexpected unit id {unit}")
            resp = self._recv_exact(length - 1)
            if resp and resp[0] & 0x80:
                code = resp[1] if len(resp) > 1 else 0
                raise ModbusError(
                    f"modbus exception {code} "
                    f"({_EXCEPTIONS.get(code, 'UNKNOWN')})", code)
            return resp

    def _recv_exact(self, n: int) -> bytes:
        chunks = b""
        while len(chunks) < n:
            chunk = self._sock.recv(n - len(chunks))
            if not chunk:
                raise ConnectionError("modbus connection closed by peer")
            chunks += chunk
        return chunks


class SimulatedModbusServer:
    """In-process Modbus/TCP server (holding registers only) for tests and
    the line simulation — the stand-in for the line's real PLC, playing the
    role the reference's simulated hardware layers do (SURVEY.md §4)."""

    def __init__(self, host: str = "127.0.0.1", port: int = 0,
                 n_registers: int = 1024):
        self.registers = [0] * n_registers
        self._srv = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._srv.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._srv.bind((host, port))
        self._srv.listen(4)
        self.address = self._srv.getsockname()
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._serve, daemon=True)
        self.requests_served = 0

    def start(self) -> "SimulatedModbusServer":
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        try:
            self._srv.close()
        except OSError:
            pass

    # -- server loop ----------------------------------------------------------
    def _serve(self) -> None:
        while not self._stop.is_set():
            try:
                conn, _ = self._srv.accept()
            except OSError:
                return
            threading.Thread(target=self._handle, args=(conn,),
                             daemon=True).start()

    def _handle(self, conn: socket.socket) -> None:
        try:
            while not self._stop.is_set():
                header = self._recv_exact(conn, 7)
                if header is None:
                    return
                txn, proto, length, unit = struct.unpack(">HHHB", header)
                pdu = self._recv_exact(conn, length - 1)
                if pdu is None:
                    return
                resp = self._respond(pdu)
                self.requests_served += 1
                mbap = struct.pack(">HHHB", txn, proto, len(resp) + 1, unit)
                conn.sendall(mbap + resp)
        except OSError:
            pass
        finally:
            conn.close()

    def _respond(self, pdu: bytes) -> bytes:
        fc = pdu[0]
        try:
            if fc == 0x03:
                addr, count = struct.unpack(">HH", pdu[1:5])
                if addr + count > len(self.registers):
                    return struct.pack(">BB", fc | 0x80, 2)
                vals = self.registers[addr:addr + count]
                return (struct.pack(">BB", 0x03, 2 * count)
                        + struct.pack(f">{count}H", *vals))
            if fc == 0x06:
                addr, value = struct.unpack(">HH", pdu[1:5])
                if addr >= len(self.registers):
                    return struct.pack(">BB", fc | 0x80, 2)
                self.registers[addr] = value
                return pdu
            if fc == 0x10:
                addr, count, nbytes = struct.unpack(">HHB", pdu[1:6])
                if addr + count > len(self.registers):
                    return struct.pack(">BB", fc | 0x80, 2)
                vals = struct.unpack(f">{count}H", pdu[6:6 + nbytes])
                self.registers[addr:addr + count] = list(vals)
                return struct.pack(">BHH", 0x10, addr, count)
            return struct.pack(">BB", fc | 0x80, 1)   # illegal function
        except struct.error:
            return struct.pack(">BB", fc | 0x80, 3)   # illegal data value

    @staticmethod
    def _recv_exact(conn: socket.socket, n: int) -> Optional[bytes]:
        chunks = b""
        while len(chunks) < n:
            chunk = conn.recv(n - len(chunks))
            if not chunk:
                return None
            chunks += chunk
        return chunks
