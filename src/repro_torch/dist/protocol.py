"""Framed RPC wire protocol for the worker pool — the port's copy of
``repro.dist.protocol``, frame for frame and byte for byte, so a torch
worker serves a JAX master and a JAX worker serves a torch master.  Shares
cross the wire as numpy uint32 in the reference's interleaved layout
(``repro_torch.core.galois.to_numpy`` / ``from_numpy`` convert them).

A *message* is one header frame followed by zero or more binary array
frames; every frame is a 4-byte big-endian length prefix + payload.  The
header is a small dict serialized with msgpack when available (JSON
otherwise — the first payload byte tags the codec, so mixed installs still
interoperate) and carries an ``_arrays`` manifest describing the binary
frames that follow.

Array payload codecs.  Shares of GR(p^e, D) are planar uint32 coefficient
tensors whose elements rarely use the carrier's full bit-width — a
Z_{2^16} share wastes half of every 32-bit limb, and masked/padded slots
are all-zero.  Each array frame therefore carries a per-array codec:

- ``"raw"``      — verbatim C-order bytes (v0 wire format; manifest entry
  is the 3-element ``[name, dtype, shape]`` so v0 peers interoperate);
- ``"pack"``     — bit-packed to the array's true bit-width ``w``
  (``w = max(x).bit_length()``; ``w=0`` ships zero payload bytes), an
  8x-or-better win whenever the ring's modulus is below the carrier;
- ``"pack+zlib"``/``"pack+zstd"`` — bit-packing followed by a general
  compressor for the residual structure (zstd only when the optional
  ``zstandard`` module is installed — never a hard dependency).

Coded entries extend the manifest to ``[name, dtype, shape, codec, width,
raw_nbytes]``; the receive side dispatches on entry length, so either
peer may be older.  The codec each connection uses is negotiated in the
capability handshake (see :func:`negotiate`): a v0 worker that advertises
nothing gets ``"raw"`` frames and never sees a packed byte.

Addresses are strings: ``tcp:HOST:PORT`` or ``unix:/path/to.sock`` (the
latter preferred for local pools — no TCP stack, no port collisions).
``tcp:HOST:0`` binds an ephemeral port; ``listen`` returns the resolved
address so workers can be pointed at it.
"""
from __future__ import annotations

import json
import socket
import struct
import zlib
from typing import Dict, List, Optional, Tuple

import numpy as np

try:  # msgpack is the preferred header codec; JSON is the stdlib fallback
    import msgpack  # type: ignore

    _HAVE_MSGPACK = True
except ImportError:  # pragma: no cover - exercised on minimal installs
    _HAVE_MSGPACK = False

try:  # optional: zstd beats zlib on ratio and speed when present
    import zstandard  # type: ignore

    _HAVE_ZSTD = True
except ImportError:  # this container has no zstandard wheel; zlib covers it
    _HAVE_ZSTD = False

__all__ = [
    "Channel",
    "ProtocolError",
    "connect",
    "decode_array",
    "encode_array",
    "listen",
    "negotiate",
    "pack_bits",
    "parse_address",
    "recv_msg",
    "send_msg",
    "supported_codecs",
    "unpack_bits",
]

PROTOCOL_VERSION = 2  # v2 adds codec negotiation + streamed chunk frames
_LEN = struct.Struct(">I")
MAX_FRAME = 1 << 31  # 2 GiB: anything larger is a corrupt length prefix


class ProtocolError(RuntimeError):
    """Malformed frame or peer hangup mid-message."""


# --------------------------------------------------------------------------
# bit packing
# --------------------------------------------------------------------------

_UNSIGNED = {np.dtype(d) for d in ("u1", "u2", "u4", "u8")}


def pack_bits(arr: np.ndarray, width: Optional[int] = None) -> Tuple[bytes, int]:
    """Bit-pack an unsigned integer array to ``width`` bits per element.

    ``width=None`` measures the minimal width (``max(arr).bit_length()``);
    ``width=0`` (an all-zeros array) packs to zero bytes.  Returns
    ``(payload, width)``; round-trips through :func:`unpack_bits` for any
    width 0..64.
    """
    a = np.ascontiguousarray(arr)
    if a.dtype not in _UNSIGNED:
        raise TypeError(f"pack_bits needs an unsigned dtype, got {a.dtype}")
    if width is None:
        width = int(a.max()).bit_length() if a.size else 0
    if not 0 <= width <= 64:
        raise ValueError(f"width {width} outside 0..64")
    if width == 0:
        return b"", 0
    # little-endian bit plane: each element becomes 64 LSB-first bits, of
    # which the low `width` are kept — packbits re-packs them 8 per byte
    a64 = a.astype("<u8", copy=False).reshape(-1)
    bits = np.unpackbits(
        a64.view(np.uint8).reshape(-1, 8), axis=1, bitorder="little"
    )[:, :width]
    return np.packbits(bits.reshape(-1), bitorder="little").tobytes(), width


def unpack_bits(
    payload: bytes, width: int, dtype, shape: Tuple[int, ...]
) -> np.ndarray:
    """Inverse of :func:`pack_bits`."""
    dtype = np.dtype(dtype)
    n = int(np.prod(shape, dtype=np.int64)) if shape else 1
    if width == 0:
        return np.zeros(shape, dtype=dtype)
    bits = np.unpackbits(
        np.frombuffer(payload, dtype=np.uint8), bitorder="little"
    )[: n * width].reshape(n, width)
    full = np.zeros((n, 64), dtype=np.uint8)
    full[:, :width] = bits
    a64 = np.packbits(full, axis=1, bitorder="little").view("<u8").reshape(n)
    return a64.astype(dtype).reshape(shape)


# --------------------------------------------------------------------------
# array codecs + negotiation
# --------------------------------------------------------------------------

# preference order for negotiation: strongest first
_CODEC_PREFERENCE = ("pack+zstd", "pack+zlib", "pack", "raw")


def supported_codecs() -> Tuple[str, ...]:
    """Codecs this process can decode, strongest first."""
    return tuple(
        c for c in _CODEC_PREFERENCE if c != "pack+zstd" or _HAVE_ZSTD
    )


def negotiate(peer_codecs: Optional[List[str]], prefer: str = "auto") -> str:
    """Pick the connection codec from the peer's advertised list.

    A v0 peer advertises nothing (``None``) and gets ``"raw"``.
    ``prefer`` pins a specific codec when both sides support it
    (``"auto"`` takes the strongest mutual codec).
    """
    theirs = set(peer_codecs or ("raw",))
    mutual = [c for c in supported_codecs() if c in theirs]
    if not mutual:
        return "raw"
    if prefer != "auto" and prefer in mutual:
        return prefer
    if prefer != "auto":
        return "raw"  # pinned codec unsupported by the peer: stay safe
    return mutual[0]


def encode_array(
    arr: np.ndarray, codec: str, level: int = 3
) -> Tuple[bytes, List]:
    """Encode one array for the wire; returns ``(payload, manifest_entry)``.

    Falls back to raw (with a 3-element v0 manifest entry) for dtypes the
    packer can't handle, so the codec layer is always safe to apply.
    """
    arr = np.ascontiguousarray(arr)
    raw_nbytes = arr.nbytes
    if codec == "raw" or arr.dtype not in _UNSIGNED:
        return memoryview(arr).cast("B"), [
            "", arr.dtype.str, list(arr.shape)
        ]
    payload, width = pack_bits(arr)
    used = "pack"
    if codec == "pack+zlib":
        z = zlib.compress(payload, level)
        if len(z) < len(payload):  # compressors can inflate tiny payloads
            payload, used = z, "pack+zlib"
    elif codec == "pack+zstd":
        if not _HAVE_ZSTD:  # pragma: no cover - env without zstandard
            raise ProtocolError("pack+zstd negotiated but zstandard missing")
        z = zstandard.ZstdCompressor(level=level).compress(payload)
        if len(z) < len(payload):
            payload, used = z, "pack+zstd"
    return payload, ["", arr.dtype.str, list(arr.shape), used, width,
                     raw_nbytes]


def decode_array(payload: bytes, entry: List) -> np.ndarray:
    """Decode one array frame from its manifest entry (v0 or coded)."""
    if len(entry) == 3:  # v0 raw entry: [name, dtype, shape]
        _, dtype, shape = entry
        return np.frombuffer(payload, dtype=np.dtype(dtype)).reshape(
            tuple(shape)
        )
    _, dtype, shape, codec, width, _raw = entry
    if codec == "pack+zlib":
        payload = zlib.decompress(payload)
    elif codec == "pack+zstd":
        if not _HAVE_ZSTD:  # pragma: no cover - mixed-install edge
            raise ProtocolError("peer sent pack+zstd but zstandard missing")
        payload = zstandard.ZstdDecompressor().decompress(payload)
    elif codec != "pack":
        raise ProtocolError(f"unknown array codec {codec!r}")
    return unpack_bits(payload, int(width), dtype, tuple(shape))


# --------------------------------------------------------------------------
# framing
# --------------------------------------------------------------------------


def _recvall(sock: socket.socket, n: int) -> bytes:
    buf = bytearray(n)
    view = memoryview(buf)
    got = 0
    while got < n:
        k = sock.recv_into(view[got:], n - got)
        if k == 0:
            raise ProtocolError(f"peer closed mid-frame ({got}/{n} bytes)")
        got += k
    return bytes(buf)


def _send_frame(sock: socket.socket, payload: bytes) -> None:
    sock.sendall(_LEN.pack(len(payload)) + payload)


def _recv_frame(sock: socket.socket) -> bytes:
    (n,) = _LEN.unpack(_recvall(sock, 4))
    if n > MAX_FRAME:
        raise ProtocolError(f"frame length {n} exceeds {MAX_FRAME}")
    return _recvall(sock, n)


# --------------------------------------------------------------------------
# messages
# --------------------------------------------------------------------------


def send_msg(
    sock: socket.socket,
    header: Dict,
    arrays: Optional[Dict[str, np.ndarray]] = None,
    codec: str = "raw",
    level: int = 3,
) -> Tuple[int, int]:
    """Send one message: header dict + named array payloads.

    ``codec`` selects the array wire encoding (see module doc); the
    default ``"raw"`` emits the v0 frame layout byte for byte.  Returns
    ``(raw_bytes, wire_bytes)`` — the pre-codec array payload size and
    what actually hit the socket (framing included), for bandwidth
    accounting.
    """
    arrays = arrays or {}
    manifest = []
    blobs = []
    raw_total = 0
    for name, arr in arrays.items():
        arr = np.ascontiguousarray(arr)
        raw_total += arr.nbytes
        if codec == "raw":
            # zero-copy send: the array's own buffer feeds sendall
            # directly (no tobytes() copy) behind a v0 manifest entry
            manifest.append([name, arr.dtype.str, list(arr.shape)])
            blobs.append(memoryview(arr).cast("B"))
        else:
            payload, entry = encode_array(arr, codec, level)
            entry[0] = name
            manifest.append(entry)
            blobs.append(payload)
    header = dict(header, _arrays=manifest)
    if _HAVE_MSGPACK:
        head = b"M" + msgpack.packb(header, use_bin_type=True)
    else:
        head = b"J" + json.dumps(header).encode("utf-8")
    _send_frame(sock, head)
    wire_total = 4 + len(head)
    for blob in blobs:
        nbytes = blob.nbytes if isinstance(blob, memoryview) else len(blob)
        sock.sendall(_LEN.pack(nbytes))
        sock.sendall(blob)
        wire_total += 4 + nbytes
    return raw_total, wire_total


def _recv_msg_ex(
    sock: socket.socket,
) -> Tuple[Dict, Dict[str, np.ndarray], int, int]:
    """Receive one message; returns (header, arrays, raw_bytes, wire_bytes)."""
    head = _recv_frame(sock)
    if not head:
        raise ProtocolError("empty header frame")
    codec, body = head[:1], head[1:]
    if codec == b"M":
        if not _HAVE_MSGPACK:  # pragma: no cover - mixed-install edge
            raise ProtocolError("peer sent msgpack but msgpack is missing")
        header = msgpack.unpackb(body, raw=False)
    elif codec == b"J":
        header = json.loads(body.decode("utf-8"))
    else:
        raise ProtocolError(f"unknown header codec {codec!r}")
    arrays: Dict[str, np.ndarray] = {}
    raw_total = 0
    wire_total = 4 + len(head)
    for entry in header.pop("_arrays", []):
        blob = _recv_frame(sock)
        wire_total += 4 + len(blob)
        arr = decode_array(blob, entry)
        raw_total += arr.nbytes
        arrays[entry[0]] = arr
    return header, arrays, raw_total, wire_total


def recv_msg(
    sock: socket.socket,
) -> Tuple[Dict, Dict[str, np.ndarray]]:
    """Receive one message: (header dict, {name: np.ndarray})."""
    header, arrays, _, _ = _recv_msg_ex(sock)
    return header, arrays


class Channel:
    """A socket plus its negotiated codec and cumulative byte accounting.

    Every pool connection sends/receives through a Channel so raw
    (pre-codec) vs. on-wire bytes are counted in one place; the counters
    feed ``PoolStats`` and ``Master.stats()``.  Not thread-safe on its
    own — callers serialize sends (the pool wraps sends in a per-worker
    lock).
    """

    def __init__(self, sock: socket.socket, codec: str = "raw",
                 level: int = 3):
        self.sock = sock
        self.codec = codec
        self.level = level
        self.raw_out = 0
        self.wire_out = 0
        self.raw_in = 0
        self.wire_in = 0

    def send(self, header: Dict, arrays=None,
             codec: Optional[str] = None) -> Tuple[int, int]:
        raw, wire = send_msg(
            self.sock, header, arrays,
            codec=self.codec if codec is None else codec, level=self.level,
        )
        self.raw_out += raw
        self.wire_out += wire
        return raw, wire

    def recv(self) -> Tuple[Dict, Dict[str, np.ndarray], int, int]:
        header, arrays, raw, wire = _recv_msg_ex(self.sock)
        self.raw_in += raw
        self.wire_in += wire
        return header, arrays, raw, wire


# --------------------------------------------------------------------------
# addresses
# --------------------------------------------------------------------------


def parse_address(address) -> Tuple[str, object]:
    """``tcp:HOST:PORT`` -> ("tcp", (host, port)); ``unix:PATH`` ->
    ("unix", path).  ``Endpoint`` instances are accepted too."""
    address = str(address)  # Endpoint.__str__ is the canonical address
    kind, _, rest = address.partition(":")
    if kind == "unix" and rest:
        return "unix", rest
    if kind == "tcp" and rest:
        host, _, port = rest.rpartition(":")
        if host and port.isdigit():
            return "tcp", (host, int(port))
    raise ValueError(
        f"bad address {address!r}; expected tcp:HOST:PORT or unix:/path"
    )


def listen(address, backlog: int = 64) -> Tuple[socket.socket, str]:
    """Bind + listen; returns (socket, resolved address string)."""
    kind, where = parse_address(address)
    if kind == "unix":
        sock = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
        sock.bind(where)
        sock.listen(backlog)
        return sock, str(address)
    host, port = where
    sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
    sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
    sock.bind((host, port))
    sock.listen(backlog)
    host, port = sock.getsockname()[:2]
    return sock, f"tcp:{host}:{port}"


def connect(address, timeout: Optional[float] = None) -> socket.socket:
    kind, where = parse_address(address)
    if kind == "unix":
        sock = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
        sock.settimeout(timeout)
        sock.connect(where)
    else:
        sock = socket.create_connection(where, timeout=timeout)
        sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
    sock.settimeout(None)
    return sock
