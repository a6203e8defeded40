"""The port's Modbus/TCP transport and PLC client against heimdall_tpu's.

The bytes each package puts on the wire are recorded from a real socket
exchange with a SimulatedModbusServer and must be equal, request and
response; the port's transport talks to JAX's server and JAX's transport
to the port's server; the reject pulse reaches the PLC's registers through
the port's PLCClient(transport=ModbusTCPTransport()).
"""

import struct
import time

import pytest

from heimdall_tpu.runtime import modbus as jmb
from heimdall_tpu.runtime import plc as jplc
from heimdall_tpu_torch.runtime import modbus as tmb
from heimdall_tpu_torch.runtime import plc as tplc

PACKAGES = {"jax": (jmb, jplc), "port": (tmb, tplc)}


class Recording:
    """A connected socket that records every byte sent and received."""

    def __init__(self, sock):
        self.sock = sock
        self.sent = []
        self.received = []

    def sendall(self, data):
        self.sent.append(bytes(data))
        self.sock.sendall(data)

    def recv(self, n):
        data = self.sock.recv(n)
        self.received.append(data)
        return data

    def close(self):
        self.sock.close()


def _exchange_trace(transport_mod, server_mod):
    """A fixed sequence of exchanges; returns (results, bytes sent, bytes
    received, the server's registers)."""
    srv = server_mod.SimulatedModbusServer().start()
    try:
        t = transport_mod.ModbusTCPTransport(unit_id=3)
        t.connect(*srv.address)
        rec = t._sock = Recording(t._sock)
        out = []
        t.write_register(7, 0xBEEF)
        t.write_register(8, -1)                  # masked to 0xFFFF
        out.append(t.read_register(7))
        t.write_registers(10, [1, 2, 3, 65535, 70000])
        out.append(t.read_registers(8, 7))
        with pytest.raises(transport_mod.ModbusError) as exc:
            t.read_registers(5000, 10)
        out.append(exc.value.exception_code)
        with pytest.raises(transport_mod.ModbusError) as exc:
            t.write_register(4000, 1)
        out.append(exc.value.exception_code)
        for bad in ((0, 126), (0, 0)):
            with pytest.raises(ValueError):
                t.read_registers(*bad)
        with pytest.raises(ValueError):
            t.write_registers(0, [])
        t.disconnect()
        with pytest.raises(ConnectionError):
            t.read_register(0)
        time.sleep(0.05)
        return (out, b"".join(rec.sent), b"".join(rec.received),
                list(srv.registers[:20]), srv.requests_served)
    finally:
        srv.stop()


def test_wire_bytes_equal_jax():
    j = _exchange_trace(jmb, jmb)
    t = _exchange_trace(tmb, tmb)
    assert t == j
    out, sent, _, regs, served = t
    assert out[0] == 0xBEEF and out[2:] == [2, 2]
    assert out[1] == [0xFFFF, 0, 1, 2, 3, 65535, 70000 & 0xFFFF]
    # the first request: MBAP txn 1, protocol 0, length 6, unit 3, then
    # FC 0x06 register 7 = 0xBEEF
    assert sent[:12] == struct.pack(">HHHB", 1, 0, 6, 3) + struct.pack(
        ">BHH", 0x06, 7, 0xBEEF)
    assert served == 7


@pytest.mark.parametrize("transport,server", [("port", "jax"),
                                              ("jax", "port")])
def test_transport_talks_to_the_other_package(transport, server):
    got = _exchange_trace(PACKAGES[transport][0], PACKAGES[server][0])
    assert got == _exchange_trace(jmb, jmb)


def test_golden_mbap_frame():
    """FC 0x06 write register 100 = 1, txn 1, unit 1 (JAX's golden frame),
    captured without a peer."""
    frames = []
    for mod in (tmb, jmb):
        t = mod.ModbusTCPTransport()

        class Capture:
            sent = b""

            def sendall(self, b):
                Capture.sent = b
                raise ConnectionError("capture only")

        t._sock = Capture()
        with pytest.raises(ConnectionError):
            t.write_register(100, 1)
        frames.append(Capture.sent)
    assert frames[0] == frames[1] == struct.pack(">HHHB", 1, 0, 6, 1) + \
        struct.pack(">BHH", 0x06, 100, 1)


@pytest.mark.parametrize("server", ["jax", "port"])
def test_reject_pulse_through_port_plc(server):
    srv = PACKAGES[server][0].SimulatedModbusServer().start()
    try:
        plc = tplc.PLCClient(ip=srv.address[0], port=srv.address[1],
                             transport=tmb.ModbusTCPTransport())
        assert plc.connect()
        plc.write_register(tplc.REG_HEARTBEAT, 5)
        assert plc.read_register(tplc.REG_HEARTBEAT) == 5
        ctl = tplc.RejectionController(plc=plc, delay_ms=10,
                                       pulse_duration_ms=5)
        ctl.reject("station_1", confidence=0.9)
        deadline = time.time() + 2.0
        while ctl.rejects_fired < 1 and time.time() < deadline:
            time.sleep(0.005)
        assert ctl.rejects_fired == 1
        assert srv.registers[tplc.REG_REJECT_PULSE] == 0
        # heartbeat write + read, pulse on + off
        assert srv.requests_served == 4
        assert ctl.stats()["fired"] == 1
        plc.disconnect()
    finally:
        srv.stop()


def test_register_map_equal():
    for name in ("REG_REJECT_PULSE", "REG_LINE_SPEED", "REG_HEARTBEAT"):
        assert getattr(tplc, name) == getattr(jplc, name)
    assert tmb.MODBUS_PORT == jmb.MODBUS_PORT == 502
