"""The port's transport (``deepspeed_tpu_torch/transport.py``) against the
JAX package's: frames byte-equal to JAX's ``encode_frame`` for the same
message and blobs, each side decoding the other's frames (JAX's bf16 blobs
arrive in the port's host form, their raw 16-bit patterns), tier entries
on the wire byte-equal, a shm ring one package writes and the other reads,
shm and TCP round trips, and the typed errors: a torn slot and a crc fault
give ``TransportCorrupt``, a full ring ``TransportError``, a gone peer
``TransportClosed``.  No tolerance: every comparison is exact."""

import struct
import threading
import time

import ml_dtypes
import numpy as np
import pytest
import torch

from deepspeed_tpu import transport as jtx
from deepspeed_tpu.inference.kv_tier import encode_entry as jax_encode_entry
from deepspeed_tpu_torch import faults
from deepspeed_tpu_torch import transport as tx
from deepspeed_tpu_torch.faults import FaultPlan
from deepspeed_tpu_torch.inference.kv_tier import encode_entry
from deepspeed_tpu_torch.telemetry import MetricsRegistry

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _no_leaked_plan():
    faults.clear_fault_plan()
    yield
    faults.clear_fault_plan()


def _blobs(kind):
    rng = np.random.default_rng(0)
    return {
        "none": [],
        "f32": [rng.normal(size=(3, 4)).astype(np.float32)],
        "mixed": [np.arange(10, dtype=np.int8),
                  rng.normal(size=(2, 5, 7)).astype(np.float32),
                  np.arange(6, dtype=np.int32).reshape(2, 3),
                  np.zeros((0, 4), np.float32)],
    }[kind]


MESSAGES = {
    "none": {"op": "poll", "ack": -1},
    "f32": {"op": "x", "rid": 7, "nested": {"a": [1, 2.5, None]}},
    "mixed": {"op": "admit", "keys": ["ab", "cd"], "budget_s": 0.5},
}


@pytest.mark.parametrize("kind", sorted(MESSAGES))
def test_frames_byte_equal_to_jax_and_cross_decode(kind):
    msg, blobs = MESSAGES[kind], _blobs(kind)
    frame = tx.encode_frame(msg, blobs)
    assert frame == jtx.encode_frame(msg, blobs)
    for decode in (tx.decode_frame, jtx.decode_frame):
        got, gb = decode(frame)
        assert got == msg
        assert len(gb) == len(blobs)
        for a, b in zip(gb, blobs):
            assert a.dtype == b.dtype and a.shape == b.shape
            np.testing.assert_array_equal(a, b)


def test_jax_bf16_blob_decodes_to_the_port_host_form():
    a = np.arange(24, dtype=ml_dtypes.bfloat16).reshape(2, 12)
    msg, blobs = tx.decode_frame(jtx.encode_frame({"op": "b"}, [a]))
    assert msg == {"op": "b"}
    assert blobs[0].dtype == np.int16
    np.testing.assert_array_equal(blobs[0], a.view(np.int16))
    want = torch.arange(24, dtype=torch.bfloat16).reshape(2, 12)
    np.testing.assert_array_equal(blobs[0], want.view(torch.int16).numpy())


def _pages(seed, shape=(2, 4, 8, 16)):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=shape).astype(np.float32),
            rng.normal(size=shape).astype(np.float32))


@pytest.mark.parametrize("quantize", [False, True])
def test_tier_entries_on_the_wire_byte_equal_to_jax(quantize):
    """The same pages encode to the same entry (int8 codes, scales and
    crc32s included), and a frame of entries is byte-equal to JAX's."""
    keys = [b"a" * 8, b"b" * 8]
    mine = [encode_entry(k, *_pages(i), quantize=quantize,
                         page_dtype=torch.float32)
            for i, k in enumerate(keys)]
    theirs = [jax_encode_entry(k, *_pages(i), quantize=quantize,
                               page_dtype=np.float32)
              for i, k in enumerate(keys)]
    for m, t in zip(mine, theirs):
        assert (m.buffers, m.checksums, m.nbytes, m.quantized, m.dtype) \
            == (t.buffers, t.checksums, t.nbytes, t.quantized, t.dtype)
    frame = tx.encode_frame(*tx.entries_to_frame(mine, {"op": "admit"}))
    assert frame == jtx.encode_frame(
        *jtx.entries_to_frame(theirs, {"op": "admit"}))
    got = tx.entries_from_frame(*tx.decode_frame(frame))
    for g, t in zip(got, theirs):
        assert g.location == "host" and g.checksums == t.checksums
        for a, b in zip(g.data, t.data):
            np.testing.assert_array_equal(a, b)


def test_frame_corruption_is_typed():
    buf = tx.encode_frame({"op": "x"}, [np.arange(64, dtype=np.int32)])
    for pos in (5, 13, len(buf) - 1):       # crc, header, payload
        bad = bytearray(buf)
        bad[pos] ^= 0x40
        with pytest.raises(tx.TransportCorrupt):
            tx.decode_frame(bytes(bad))
    with pytest.raises(tx.TransportCorrupt):
        tx.decode_frame(buf[:7])
    assert issubclass(tx.TransportCorrupt, tx.TransportError)
    assert issubclass(tx.TransportError, IOError)


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_shm_ring_round_trip_across_the_packages(tmp_path, writer):
    """One package produces into a ring, the other consumes: the slot
    layout, the fragmenting and the wrap-around are the same."""
    path = str(tmp_path / "x.ring")
    w, r = (tx, jtx) if writer == "port" else (jtx, tx)
    w.ShmRing.create(path, slot_bytes=96, n_slots=8).close()
    prod = w.ShmRing.attach(path, "producer")
    cons = r.ShmRing.attach(path, "consumer")
    rng = np.random.default_rng(0)
    for i in range(60):
        data = bytes(rng.integers(0, 256, i * 7 % 311 + 1, dtype=np.uint8))
        prod.send_bytes(data)
        assert cons.recv_bytes(timeout_s=1.0) == data
    assert prod._head == cons._tail > 8
    prod.close()
    cons.close(unlink=True)


def test_shm_ring_torn_slot_and_backpressure(tmp_path):
    path = str(tmp_path / "t.ring")
    tx.ShmRing.create(path, slot_bytes=96, n_slots=4).close()
    prod = tx.ShmRing.attach(path, "producer")
    cons = tx.ShmRing.attach(path, "consumer")
    prod.send_bytes(b"precious payload " * 4)
    base = 64 + ((prod._head - 1) % prod.n_slots) * prod.slot_bytes
    prod.mm[base + 40] ^= 0xFF
    with pytest.raises(tx.TransportCorrupt):
        cons.recv_bytes(timeout_s=1.0)
    prod.send_bytes(b"next frame")
    assert cons.recv_bytes(timeout_s=1.0) == b"next frame"
    prod.send_bytes(b"seq victim")          # a torn sequence word
    base = 64 + ((prod._head - 1) % prod.n_slots) * prod.slot_bytes
    struct.pack_into("<Q", prod.mm, base, 999999)
    with pytest.raises(tx.TransportCorrupt, match="torn"):
        cons.recv_bytes(timeout_s=1.0)
    for _ in range(4):                      # full: bounded, never overwrite
        prod.send_bytes(b"x" * 40)
    t0 = time.monotonic()
    with pytest.raises(tx.TransportError, match="backpressure"):
        prod.send_bytes(b"x" * 40, timeout_s=0.1)
    assert time.monotonic() - t0 >= 0.08
    assert cons.recv_bytes(timeout_s=1.0) == b"x" * 40
    assert cons.recv_bytes(timeout_s=0.0) == b"x" * 40
    with pytest.raises(tx.TransportError, match="slots"):
        prod.send_bytes(b"x" * 4096)
    prod.close()
    cons.close(unlink=True)


def test_tcp_round_trip_with_a_jax_peer_and_peer_close():
    lst = jtx.TcpListener()
    cli = tx.connect_tcp("127.0.0.1", lst.port)
    srv = lst.accept(timeout_s=5.0)
    frame = tx.encode_frame({"op": "ping"}, _blobs("mixed"))
    cli.send_bytes(frame)
    assert jtx.decode_frame(srv.recv_bytes(timeout_s=2.0))[0] == \
        {"op": "ping"}
    srv.send_bytes(jtx.encode_frame({"op": "pong"}))
    assert tx.decode_frame(cli.recv_bytes(timeout_s=2.0))[0] == \
        {"op": "pong"}
    assert cli.recv_bytes(timeout_s=0.05) is None
    srv.close()
    with pytest.raises(tx.TransportClosed):
        for _ in range(50):                 # close may race the FIN
            cli.recv_bytes(timeout_s=0.1)
    cli.close()
    lst.close()


def _loopback(tmp_path, registry=None):
    c2s, s2c = tx.create_shm_pair(str(tmp_path), "chan")
    client = tx.Channel(tx.attach_shm_pair(c2s, s2c, "client"),
                        peer="child", registry=registry)
    server = jtx.Channel(jtx.attach_shm_pair(c2s, s2c, "server"),
                         peer="parent")
    return client, server


def test_channel_rpc_against_a_jax_server_drops_stale_replies(tmp_path):
    client, server = _loopback(tmp_path)

    def serve():
        msg, blobs = server.recv(timeout_s=5.0)
        # a stale reply of an older call first: the client drops it
        server.send({"_seq": msg["_seq"] - 1, "echo": "stale"})
        server.send({"_seq": msg["_seq"], "echo": msg["op"],
                     "n": len(blobs)}, blobs)

    th = threading.Thread(target=serve, daemon=True)
    th.start()
    rep, blobs = client.request({"op": "hello"},
                                [np.arange(6, dtype=np.int32)],
                                timeout_s=5.0)
    th.join(timeout=5)
    assert rep["echo"] == "hello" and rep["n"] == 1
    np.testing.assert_array_equal(blobs[0], np.arange(6, dtype=np.int32))
    with pytest.raises(tx.TransportError, match="timed out"):
        client.request({"op": "nobody"}, timeout_s=0.2)


def test_crc_fault_rule_is_detected_and_counted(tmp_path):
    reg = MetricsRegistry(namespace="t")
    c2s, s2c = tx.create_shm_pair(str(tmp_path), "c")
    a = tx.Channel(tx.attach_shm_pair(c2s, s2c, "client"), peer="child",
                   registry=reg)
    b = tx.Channel(tx.attach_shm_pair(c2s, s2c, "server"), peer="parent",
                   registry=reg)
    faults.install_fault_plan(FaultPlan([
        {"subsystem": "transport", "mode": "error",
         "match": "corrupt:child", "count": 1},
        {"subsystem": "transport", "mode": "error",
         "match": "send:parent", "count": 1}]))
    a.send({"op": "x"}, [np.arange(8, dtype=np.int32)])
    with pytest.raises(tx.TransportCorrupt):
        b.recv(timeout_s=1.0)
    a.send({"op": "y"})                     # the rule's count is spent
    assert b.recv(timeout_s=1.0)[0] == {"op": "y"}
    with pytest.raises(tx.TransportError, match="injected"):
        b.send({"op": "z"})
    cnt = reg.snapshot()["counters"]
    assert cnt["transport_corrupt_frames"] == 1
    assert cnt["transport_injected_faults"] == 2
