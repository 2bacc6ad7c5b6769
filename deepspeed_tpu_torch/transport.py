"""Process-boundary transport: the wire under the KV fabric and the
out-of-process fleet (port of ``deepspeed_tpu/transport.py``, host-only:
numpy and the standard library, frames byte-compatible with the JAX
package's).

Two interchangeable byte movers live behind one framed-message surface:

- :class:`ShmRing` — a file-backed mmap ring for same-host peers.
  Fixed-size slots, single-producer/single-consumer per direction,
  per-fragment crc32, and a sequence-number publication order that
  makes torn writes *detectable*: the producer writes payload, then
  length/crc, then the slot's sequence word LAST, and only then
  advances the shared head — a consumer never trusts a slot whose
  sequence doesn't match its own consume cursor.  A full ring is
  backpressure (bounded poll-sleep), never silent drop.
- :class:`TcpEndpoint` — a length-prefixed TCP stream, the general
  path.  Reconnect rides :func:`deepspeed_tpu_torch.faults.
  retry_with_backoff` at the :class:`Channel` layer.

Above both sits :class:`Channel`: JSON header + raw array blobs in one
crc-framed message, ``transport`` fault-rule hooks (``send:<peer>``,
``recv:<peer>``, ``corrupt:<peer>``), ``transport_*`` metrics, and a
sequence-matched ``request()`` RPC.  :func:`entry_to_wire` /
:func:`entry_from_wire` carry :class:`~deepspeed_tpu_torch.inference.
prefix_cache.TierEntry` pages — including int8-quantized cold pages —
with their demote-time per-buffer crc32s travelling verbatim, so the
importer's promotion-time checksum stays the correctness last line no
matter what the wire did.  A corrupt frame raises
:class:`TransportCorrupt` here and degrades to recompute upstream;
it never becomes wrong tokens.  Every wait is bounded.

bf16 pages travel in the port's host form (their raw 16-bit patterns,
dtype ``int16``); a ``bfloat16`` blob in a frame from the JAX package
decodes to that same form.
"""

from __future__ import annotations

import json
import mmap
import os
import socket
import struct
import time
import zlib
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from deepspeed_tpu_torch import faults as _faults
from deepspeed_tpu_torch.telemetry import MetricsRegistry
from deepspeed_tpu_torch.utils.logging import logger

__all__ = [
    "TransportError", "TransportCorrupt", "TransportClosed",
    "TransportOversize", "encode_frame", "decode_frame", "entry_to_wire",
    "entry_from_wire",
    "entries_to_frame", "entries_from_frame",
    "ShmRing", "ShmEndpoint", "TcpEndpoint", "TcpListener",
    "connect_tcp", "Channel",
]


class TransportError(IOError):
    """The wire failed (timeout, broken pipe, injected fault).  An
    IOError so :func:`~deepspeed_tpu_torch.faults.retry_with_backoff`'s
    default ``retry_on`` covers it."""


class TransportCorrupt(TransportError):
    """A frame arrived but its checksum/sequence bookkeeping does not
    add up (bit rot, torn write, injected corruption).  The payload
    must be discarded — upstream degrades to recompute."""


class TransportClosed(TransportError):
    """The peer is gone (EOF / closed endpoint) — distinct from a
    transient error so a router can fail over instead of retrying."""


class TransportOversize(TransportError):
    """A frame needs more slots than the whole shm ring holds.  Raised
    before any slot is written, so the ring stays usable: the sender may
    answer with a smaller frame (the replica child replies with a typed
    error)."""


# --------------------------------------------------------------------
# frame codec: one JSON header + N raw array blobs, crc32 over all of it
# --------------------------------------------------------------------

_FRAME_MAGIC = 0x44535457          # "DSTW"
_FRAME_HDR = struct.Struct("<III")  # magic, crc32, json_len


def _np_dtype(name: str) -> np.dtype:
    """``np.dtype`` lookup; ``bfloat16`` (which numpy lacks) maps to the
    port's host form of bf16, its raw 16-bit pattern as ``int16``."""
    if name == "bfloat16":
        return np.dtype(np.int16)
    return np.dtype(name)


# every message (and every migrated page) funnels through here; one
# json dump + flat byte concat, no per-element work
# dstpu: hot-path
def encode_frame(msg: Dict[str, Any],
                 blobs: Sequence[np.ndarray] = ()) -> bytes:
    parts: List[bytes] = []
    meta = []
    for b in blobs:
        a = np.ascontiguousarray(b)
        parts.append(a.tobytes())
        meta.append([list(a.shape), str(a.dtype), a.nbytes])
    head = dict(msg)
    if meta:
        head["_blobs"] = meta
    jb = json.dumps(head, separators=(",", ":")).encode("utf-8")
    payload = b"".join([jb] + parts)
    crc = zlib.crc32(struct.pack("<I", len(jb)) + payload) & 0xFFFFFFFF
    return _FRAME_HDR.pack(_FRAME_MAGIC, crc, len(jb)) + payload


# dstpu: hot-path — the receive side of every message
def decode_frame(buf: bytes) -> Tuple[Dict[str, Any], List[np.ndarray]]:
    if len(buf) < _FRAME_HDR.size:
        raise TransportCorrupt(f"frame truncated: {len(buf)} bytes")
    magic, crc, jlen = _FRAME_HDR.unpack_from(buf, 0)
    if magic != _FRAME_MAGIC:
        raise TransportCorrupt(f"bad frame magic {magic:#x}")
    payload = buf[_FRAME_HDR.size:]
    want = zlib.crc32(struct.pack("<I", jlen) + payload) & 0xFFFFFFFF
    if want != crc:
        raise TransportCorrupt(
            f"frame crc mismatch ({want:#x} != {crc:#x})")
    if jlen > len(payload):
        raise TransportCorrupt("frame header overruns payload")
    try:
        head = json.loads(payload[:jlen].decode("utf-8"))
    except (UnicodeDecodeError, json.JSONDecodeError) as e:
        raise TransportCorrupt(f"frame header undecodable: {e}")
    blobs: List[np.ndarray] = []
    off = jlen
    for shape, dtype, nbytes in head.pop("_blobs", []):
        raw = payload[off:off + nbytes]
        if len(raw) != nbytes:
            raise TransportCorrupt("frame blob overruns payload")
        blobs.append(np.frombuffer(raw, dtype=_np_dtype(dtype))
                     .reshape(shape).copy())
        off += nbytes
    return head, blobs


# --------------------------------------------------------------------
# TierEntry <-> wire: quantized or bit-exact pages, checksums verbatim
# --------------------------------------------------------------------

# dstpu: hot-path — per migrated page on the export leg
def entry_to_wire(entry) -> Tuple[Dict[str, Any], List[np.ndarray]]:
    """One host-resident :class:`TierEntry` as (header, blobs).  The
    demote-time per-buffer crc32s ride the header untouched — the
    importer's promotion check, not the wire, is what proves the
    payload."""
    blobs = [np.ascontiguousarray(a) for a in (entry.data or ())]
    meta = {
        "key": entry.key.hex(),
            "quantized": bool(entry.quantized),
        "dtype": str(entry.dtype),
        "buffers": [[n, list(s), str(d)] for n, s, d in entry.buffers],
        "nbytes": int(entry.nbytes),
        "tick": int(entry.tick),
        "checksums": (list(map(int, entry.checksums))
                      if entry.checksums is not None else None),
        "nblobs": len(blobs),
    }
    return meta, blobs


# dstpu: hot-path — per migrated page on the admit leg
def entry_from_wire(meta: Dict[str, Any], blobs: Sequence[np.ndarray]):
    """Rebuild a host-resident :class:`TierEntry` from the wire form.
    ``location`` is always ``"host"`` on arrival — whatever tier the
    page came FROM, the copy that crossed the wire lives in memory."""
    from deepspeed_tpu_torch.inference.prefix_cache import TierEntry
    cks = meta.get("checksums")
    return TierEntry(
        key=bytes.fromhex(meta["key"]),
        location="host",
        # dstpu: host-sync-ok: JSON-header coercion — every value here
        # is decoded wire metadata, no device arrays in this function
        quantized=bool(meta["quantized"]),
        dtype=str(meta["dtype"]),
        buffers=tuple((n, tuple(s), d) for n, s, d in meta["buffers"]),
        nbytes=int(meta["nbytes"]),
        data=tuple(blobs) if blobs else None,
        tick=int(meta.get("tick", 0)),
        checksums=tuple(int(c) for c in cks) if cks else None)


def entries_to_frame(entries, extra: Optional[Dict[str, Any]] = None
                     ) -> Tuple[Dict[str, Any], List[np.ndarray]]:
    """Pack N entries into one message: headers in the JSON, every
    buffer flattened into the blob train (each header's ``nblobs``
    tells the decoder where its slice ends)."""
    metas, blobs = [], []
    for e in entries:
        m, bl = entry_to_wire(e)
        metas.append(m)
        blobs.extend(bl)
    msg = dict(extra or {})
    msg["entries"] = metas
    return msg, blobs


def entries_from_frame(msg: Dict[str, Any],
                       blobs: Sequence[np.ndarray]) -> List[Any]:
    out, off = [], 0
    for m in msg.get("entries", []):
        n = int(m.get("nblobs", 0))
        out.append(entry_from_wire(m, blobs[off:off + n]))
        off += n
    return out


# --------------------------------------------------------------------
# shared-memory ring: file-backed mmap, SPSC per direction
# --------------------------------------------------------------------

_SHM_MAGIC = 0x44535452            # "DSTR"
_SHM_HDR = 64                      # magic,slot,nslots,pad + head,tail
_SLOT_HDR = 24                     # seq u64 | total u32 | frag u32 | crc u32 | pad u32
_HEAD_OFF = 16
_TAIL_OFF = 24


class ShmRing:
    """One direction of a same-host pair: fixed-slot mmap ring.

    Single producer, single consumer.  A frame larger than one slot
    fragments across consecutive slots; the producer publishes the
    shared head ONCE after the last fragment, so ``head > tail``
    guarantees the whole frame is readable.  Torn/overwritten slots
    surface as :class:`TransportCorrupt` (sequence or crc mismatch),
    never as silently wrong bytes — and the cursor still advances past
    the bad frame so the stream recovers."""

    def __init__(self, path: str, role: str, *, _create: bool = False,
                 slot_bytes: int = 1 << 14, n_slots: int = 64):
        if role not in ("producer", "consumer"):
            raise ValueError(f"role must be producer|consumer: {role}")
        self.path, self.role = path, role
        self._closed = False
        if _create:
            if slot_bytes <= _SLOT_HDR:
                raise ValueError(f"slot_bytes {slot_bytes} too small")
            size = _SHM_HDR + n_slots * slot_bytes
            with open(path, "wb") as f:
                f.write(b"\0" * size)
            self._f = open(path, "r+b")
            self.mm = mmap.mmap(self._f.fileno(), size)
            struct.pack_into("<IIII", self.mm, 0, _SHM_MAGIC,
                             slot_bytes, n_slots, 0)
        else:
            self._f = open(path, "r+b")
            size = os.fstat(self._f.fileno()).st_size
            self.mm = mmap.mmap(self._f.fileno(), size)
        magic, self.slot_bytes, self.n_slots, _ = struct.unpack_from(
            "<IIII", self.mm, 0)
        if magic != _SHM_MAGIC:
            raise TransportError(f"not a dstpu shm ring: {path}")
        self._cap = self.slot_bytes - _SLOT_HDR
        # each side owns exactly one cursor; the other is read from the
        # map (SPSC — no locks, publication order is the fence)
        self._head = struct.unpack_from("<Q", self.mm, _HEAD_OFF)[0]
        self._tail = struct.unpack_from("<Q", self.mm, _TAIL_OFF)[0]

    @classmethod
    def create(cls, path: str, *, slot_bytes: int = 1 << 14,
               n_slots: int = 64) -> "ShmRing":
        return cls(path, "producer", _create=True,
                   slot_bytes=slot_bytes, n_slots=n_slots)

    @classmethod
    def attach(cls, path: str, role: str) -> "ShmRing":
        return cls(path, role)

    # ------------------------------------------------------------ send
    # dstpu: hot-path — the same-host data plane's write side
    def send_bytes(self, data: bytes,
                   timeout_s: Optional[float] = 5.0) -> None:
        if self._closed:
            raise TransportClosed(f"shm ring {self.path} closed")
        if self.role != "producer":
            raise TransportError("consumer side cannot send")
        need = max(1, -(-len(data) // self._cap))
        if need > self.n_slots:
            raise TransportOversize(
                f"frame of {len(data)} B needs {need} slots > ring's "
                f"{self.n_slots} — raise transport.slot_bytes/ring_slots")
        deadline = (None if timeout_s is None
                    else time.monotonic() + timeout_s)
        # backpressure: a full ring parks the producer (bounded), it
        # never overwrites unconsumed slots
        while self.n_slots - (self._head - self._read_tail()) < need:
            if deadline is not None and time.monotonic() > deadline:
                raise TransportError(
                    f"shm ring {self.path} full for {timeout_s}s "
                    "(consumer stalled) — backpressure timeout")
            time.sleep(2e-4)
        off = 0
        for i in range(need):
            frag = data[off:off + self._cap]
            off += len(frag)
            base = _SHM_HDR + ((self._head + i) % self.n_slots) \
                * self.slot_bytes
            # publication order IS the torn-write guard: payload, then
            # length/crc, then the sequence word — a reader whose
            # cursor doesn't match seq rejects the slot
            self.mm[base + _SLOT_HDR:base + _SLOT_HDR + len(frag)] = frag
            struct.pack_into("<III", self.mm, base + 8, len(data),
                             len(frag), zlib.crc32(frag) & 0xFFFFFFFF)
            struct.pack_into("<Q", self.mm, base, self._head + i)
        self._head += need
        struct.pack_into("<Q", self.mm, _HEAD_OFF, self._head)

    # ------------------------------------------------------------ recv
    # dstpu: hot-path — the same-host data plane's read side
    def recv_bytes(self, timeout_s: float = 0.0) -> Optional[bytes]:
        if self._closed:
            raise TransportClosed(f"shm ring {self.path} closed")
        if self.role != "consumer":
            raise TransportError("producer side cannot recv")
        deadline = time.monotonic() + max(0.0, timeout_s)
        while self._read_head() <= self._tail:
            if time.monotonic() >= deadline:
                return None
            time.sleep(2e-4)
        base = self._slot_base(self._tail)
        seq, total, _frag, _crc = struct.unpack_from(
            "<QIII", self.mm, base)
        if seq != self._tail:
            # a slot whose sequence lags the cursor was torn or never
            # fully published; skip it so the stream can recover
            self._advance(1)
            raise TransportCorrupt(
                f"shm ring {self.path}: torn slot (seq {seq} != "
                f"cursor {self._tail - 1})")
        need = max(1, -(-total // self._cap))
        if need > self.n_slots:
            self._advance(1)
            raise TransportCorrupt(
                f"shm ring {self.path}: implausible frame length "
                f"{total}")
        parts: List[bytes] = []
        for i in range(need):
            b = self._slot_base(self._tail + i)
            seq_i, total_i, frag_i, crc_i = struct.unpack_from(
                "<QIII", self.mm, b)
            frag = bytes(self.mm[b + _SLOT_HDR:b + _SLOT_HDR + frag_i])
            if (seq_i != self._tail + i or total_i != total
                    or frag_i > self._cap
                    or (zlib.crc32(frag) & 0xFFFFFFFF) != crc_i):
                self._advance(need)
                raise TransportCorrupt(
                    f"shm ring {self.path}: fragment {i}/{need} failed "
                    "seq/crc verification (torn or corrupted write)")
            parts.append(frag)
        self._advance(need)
        data = b"".join(parts)
        if len(data) != total:
            raise TransportCorrupt(
                f"shm ring {self.path}: reassembled {len(data)} B != "
                f"declared {total}")
        return data

    # --------------------------------------------------------- plumbing
    def _slot_base(self, seq: int) -> int:
        return _SHM_HDR + (seq % self.n_slots) * self.slot_bytes

    def _advance(self, n: int) -> None:
        self._tail += n
        struct.pack_into("<Q", self.mm, _TAIL_OFF, self._tail)

    def _read_head(self) -> int:
        return struct.unpack_from("<Q", self.mm, _HEAD_OFF)[0]

    def _read_tail(self) -> int:
        return struct.unpack_from("<Q", self.mm, _TAIL_OFF)[0]

    def close(self, unlink: bool = False) -> None:
        if self._closed:
            return
        self._closed = True
        try:
            self.mm.close()
            self._f.close()
        except Exception:
            pass
        if unlink:
            try:
                os.unlink(self.path)
            except OSError:
                pass


class ShmEndpoint:
    """Duplex same-host endpoint: two SPSC rings, one per direction."""

    kind = "shm"

    def __init__(self, tx: ShmRing, rx: ShmRing):
        self.tx, self.rx = tx, rx

    def send_bytes(self, data: bytes, timeout_s=5.0) -> None:
        self.tx.send_bytes(data, timeout_s=timeout_s)

    def recv_bytes(self, timeout_s: float = 0.0) -> Optional[bytes]:
        return self.rx.recv_bytes(timeout_s=timeout_s)

    def close(self, unlink: bool = False) -> None:
        self.tx.close(unlink=unlink)
        self.rx.close(unlink=unlink)


# --------------------------------------------------------------------
# TCP: length-prefixed frames on a stream socket
# --------------------------------------------------------------------

class TcpEndpoint:
    """Duplex general-path endpoint: ``[u32 length]``-prefixed frames
    on one TCP connection (TCP_NODELAY — frames are latency-bound
    control messages or already-batched page trains)."""

    kind = "tcp"

    def __init__(self, sock: socket.socket):
        self.sock = sock
        try:
            sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        except OSError:
            pass
        self._closed = False

    # dstpu: hot-path — the general-path data plane's write side
    def send_bytes(self, data: bytes, timeout_s=5.0) -> None:
        if self._closed:
            raise TransportClosed("tcp endpoint closed")
        try:
            self.sock.settimeout(timeout_s)
            self.sock.sendall(struct.pack("<I", len(data)) + data)
        except socket.timeout:
            raise TransportError(f"tcp send timed out after {timeout_s}s")
        except OSError as e:
            raise TransportClosed(f"tcp send failed: {e}")

    def _recv_exact(self, n: int, deadline: float) -> Optional[bytes]:
        buf = bytearray()
        while len(buf) < n:
            rem = deadline - time.monotonic()
            if rem <= 0:
                return None
            try:
                self.sock.settimeout(min(rem, 0.5))
                chunk = self.sock.recv(n - len(buf))
            except socket.timeout:
                continue
            except OSError as e:
                raise TransportClosed(f"tcp recv failed: {e}")
            if not chunk:
                raise TransportClosed("tcp peer closed the stream")
            buf.extend(chunk)
        return bytes(buf)

    # dstpu: hot-path — the general-path data plane's read side
    def recv_bytes(self, timeout_s: float = 0.0) -> Optional[bytes]:
        if self._closed:
            raise TransportClosed("tcp endpoint closed")
        deadline = time.monotonic() + max(1e-4, timeout_s)
        hdr = self._recv_exact(4, deadline)
        if hdr is None:
            return None
        (n,) = struct.unpack("<I", hdr)
        # the header committed us to a frame: wait out the body past the
        # soft timeout rather than desynchronize the stream
        body = self._recv_exact(n, time.monotonic() + 10.0)
        if body is None:
            raise TransportError(
                f"tcp frame truncated mid-body ({n} B promised)")
        return body

    def close(self) -> None:
        if self._closed:
            return
        self._closed = True
        try:
            self.sock.close()
        except OSError:
            pass


class TcpListener:
    """Ephemeral-port listener for a replica child's transport plane."""

    def __init__(self, host: str = "127.0.0.1", port: int = 0):
        self.sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self.sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self.sock.bind((host, port))
        self.sock.listen(4)
        self.host, self.port = self.sock.getsockname()[:2]

    def accept(self, timeout_s: float = 10.0) -> TcpEndpoint:
        self.sock.settimeout(timeout_s)
        try:
            conn, _ = self.sock.accept()
        except socket.timeout:
            raise TransportError(
                f"no transport connection within {timeout_s}s")
        return TcpEndpoint(conn)

    def close(self) -> None:
        try:
            self.sock.close()
        except OSError:
            pass


def connect_tcp(host: str, port: int, *, attempts: int = 5,
                backoff_s: float = 0.05,
                timeout_s: float = 5.0) -> TcpEndpoint:
    """Dial a replica child's transport port, retrying with backoff
    (the child may still be binding when the parent reads the
    handshake)."""
    def dial():
        s = socket.create_connection((host, port), timeout=timeout_s)
        return TcpEndpoint(s)
    return _faults.retry_with_backoff(
        dial, attempts=attempts, backoff_s=backoff_s,
        retry_on=(OSError,))


# --------------------------------------------------------------------
# Channel: framed messages + faults + metrics + RPC over any endpoint
# --------------------------------------------------------------------

class Channel:
    """One peer-pair message channel over an :class:`ShmEndpoint` or
    :class:`TcpEndpoint`.

    Injected ``transport`` fault rules hook three keys per peer:
    ``send:<peer>`` / ``recv:<peer>`` (latency rules sleep, error
    rules raise :class:`TransportError` — the reconnect/backoff path)
    and ``corrupt:<peer>`` (one byte of the encoded frame flips AFTER
    the crc was computed, so the receiver must detect it).  A
    ``reconnect`` callable makes send-side endpoint failures retriable
    through :func:`~deepspeed_tpu_torch.faults.retry_with_backoff`."""

    def __init__(self, endpoint, peer: str = "peer", *,
                 registry: Optional[MetricsRegistry] = None,
                 reconnect: Optional[Callable[[], Any]] = None,
                 io_timeout_s: float = 5.0,
                 reconnect_attempts: int = 3,
                 reconnect_backoff_s: float = 0.05):
        self.endpoint = endpoint
        self.peer = peer
        self.reconnect = reconnect
        self.io_timeout_s = float(io_timeout_s)
        self.reconnect_attempts = int(reconnect_attempts)
        self.reconnect_backoff_s = float(reconnect_backoff_s)
        self._seq = 0
        r = registry if registry is not None \
            else MetricsRegistry(enabled=False)
        self._c_tx = r.counter("transport_tx_frames",
                               "frames sent on this peer channel")
        self._c_rx = r.counter("transport_rx_frames",
                               "frames received on this peer channel")
        self._c_txb = r.counter("transport_tx_bytes",
                                "payload bytes sent (frame-encoded)")
        self._c_rxb = r.counter("transport_rx_bytes",
                                "payload bytes received")
        self._c_corrupt = r.counter(
            "transport_corrupt_frames",
            "frames rejected by crc/sequence verification")
        self._c_reconnects = r.counter(
            "transport_reconnects",
            "endpoint re-dials after a send-side failure")
        self._c_injected = r.counter(
            "transport_injected_faults",
            "transport fault rules that fired on this channel")
        self._h_rpc = r.histogram(
            "transport_rpc_seconds",
            "request() round trips on this channel")

    # ------------------------------------------------------------ send
    # dstpu: hot-path — every control message and page train
    def send(self, msg: Dict[str, Any],
             blobs: Sequence[np.ndarray] = ()) -> None:
        delay, err = _faults.poll("transport", f"send:{self.peer}")
        if delay:
            self._c_injected.inc()
            time.sleep(delay)
        if err is not None:
            self._c_injected.inc()
            raise TransportError(
                f"injected transport send failure ({self.peer})")
        frame = encode_frame(msg, blobs)
        _d, corrupt = _faults.poll("transport", f"corrupt:{self.peer}")
        if corrupt is not None:
            # flip one payload byte AFTER the crc was stamped: the
            # receiver's decode_frame must catch it — this is the
            # injected analogue of a torn DMA or flaky NIC
            self._c_injected.inc()
            fb = bytearray(frame)
            fb[-1] ^= 0xFF
            frame = bytes(fb)
        try:
            self.endpoint.send_bytes(frame, timeout_s=self.io_timeout_s)
        except TransportClosed:
            if self.reconnect is None:
                raise
            self._redial()
            self.endpoint.send_bytes(frame, timeout_s=self.io_timeout_s)
        self._c_tx.inc()
        self._c_txb.inc(len(frame))

    def _redial(self) -> None:
        def again():
            ep = self.reconnect()
            if ep is None:
                raise TransportError(f"reconnect to {self.peer} failed")
            return ep
        logger.warning("transport: channel to %s dropped — redialing",
                       self.peer)
        self.endpoint = _faults.retry_with_backoff(
            again, attempts=self.reconnect_attempts,
            backoff_s=self.reconnect_backoff_s)
        self._c_reconnects.inc()

    # ------------------------------------------------------------ recv
    # dstpu: hot-path — the receive side of every message
    def recv(self, timeout_s: float = 0.0
             ) -> Optional[Tuple[Dict[str, Any], List[np.ndarray]]]:
        delay, err = _faults.poll("transport", f"recv:{self.peer}")
        if delay:
            self._c_injected.inc()
            time.sleep(delay)
        if err is not None:
            self._c_injected.inc()
            raise TransportError(
                f"injected transport recv failure ({self.peer})")
        buf = self.endpoint.recv_bytes(timeout_s=timeout_s)
        if buf is None:
            return None
        try:
            msg, blobs = decode_frame(buf)
        except TransportCorrupt:
            self._c_corrupt.inc()
            raise
        self._c_rx.inc()
        self._c_rxb.inc(len(buf))
        return msg, blobs

    # ------------------------------------------------------------- rpc
    def request(self, msg: Dict[str, Any],
                blobs: Sequence[np.ndarray] = (),
                timeout_s: float = 10.0
                ) -> Tuple[Dict[str, Any], List[np.ndarray]]:
        """Client-side RPC: stamp a sequence number, send, wait for
        the matching reply.  Replies carrying an older sequence (a
        previously timed-out call finally answered) are drained and
        dropped — the stream never desynchronizes."""
        self._seq += 1
        seq = self._seq
        t0 = time.perf_counter()
        self.send(dict(msg, _seq=seq), blobs)
        deadline = time.monotonic() + timeout_s
        while True:
            rem = deadline - time.monotonic()
            if rem <= 0:
                raise TransportError(
                    f"rpc {msg.get('op')!r} to {self.peer} timed out "
                    f"after {timeout_s}s")
            got = self.recv(timeout_s=min(rem, 0.25))
            if got is None:
                continue
            rmsg, rblobs = got
            if rmsg.get("_seq") != seq:
                continue            # stale reply from a timed-out call
            self._h_rpc.observe(time.perf_counter() - t0)
            return rmsg, rblobs

    def close(self, **kw) -> None:
        try:
            self.endpoint.close(**kw)
        except TypeError:
            self.endpoint.close()
        except Exception:
            pass


# --------------------------------------------------------------------
# pair construction: what proc_fleet/replica_child use to wire a peer
# --------------------------------------------------------------------

def create_shm_pair(dirpath: str, name: str, *,
                    slot_bytes: int = 1 << 14,
                    n_slots: int = 64) -> Tuple[str, str]:
    """Create the two ring files for one parent<->child pair and
    return ``(c2s_path, s2c_path)`` — client-to-server and back.  The
    CREATOR initializes both; each side attaches with its own role."""
    c2s = os.path.join(dirpath, f"{name}.c2s.ring")
    s2c = os.path.join(dirpath, f"{name}.s2c.ring")
    for p in (c2s, s2c):
        ShmRing.create(p, slot_bytes=slot_bytes, n_slots=n_slots).close()
    return c2s, s2c


def attach_shm_pair(c2s: str, s2c: str, side: str) -> ShmEndpoint:
    """Attach one side of a ring pair: the ``"client"`` produces into
    c2s and consumes s2c; the ``"server"`` mirrors it."""
    if side == "client":
        return ShmEndpoint(tx=ShmRing.attach(c2s, "producer"),
                           rx=ShmRing.attach(s2c, "consumer"))
    if side == "server":
        return ShmEndpoint(tx=ShmRing.attach(s2c, "producer"),
                           rx=ShmRing.attach(c2s, "consumer"))
    raise ValueError(f"side must be client|server: {side}")
