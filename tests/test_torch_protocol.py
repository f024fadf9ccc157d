"""repro_torch.dist.protocol and repro_torch.dist.config held against
repro.dist's: the same bytes on the wire and the same decoded arrays for
every codec, and the same pool configuration from the same environment or
hostfile.  No processes: sockets are in-process socket pairs."""
import dataclasses
import socket
import threading
import warnings

import numpy as np
import pytest

import repro.dist.config as jconfig
import repro.dist.protocol as jproto
import repro_torch.dist.config as pconfig
import repro_torch.dist.protocol as pproto

CODECS = ("raw", "pack", "pack+zlib")


def _arrays():
    rng = np.random.default_rng(3)
    return {
        # a Z_2^16 share in uint32 carriers: packing halves it
        "fa": rng.integers(0, 1 << 16, size=(4, 6, 3), dtype=np.uint64).astype(np.uint32),
        # full-width words: packing keeps all 32 bits
        "gb": rng.integers(0, 1 << 32, size=(6, 5, 3), dtype=np.uint64).astype(np.uint32),
        "zeros": np.zeros((3, 7), dtype=np.uint32),  # width 0: no payload bytes
        "small": np.arange(40, dtype=np.uint16).reshape(5, 8),
        "signed": np.arange(-6, 6, dtype=np.int32),  # not packable: raw entry
    }


HEADER = {"type": "task", "req": 3, "task": 17, "i": 5, "codec": "pack",
          "ring": {"p": 2, "e": 16, "degrees": [3]}, "use_kernel": "auto",
          "trace": "t-1", "launches": {"tc": 2, "limbs": 4}}


def _wire(mod, codec):
    """(bytes the socket carried, what send_msg returned, decoded message)."""
    a, b = socket.socketpair()
    chunks = []
    try:
        reader = threading.Thread(target=lambda: chunks.append(mod._recv_msg_ex(b)))
        reader.start()
        sent = mod.send_msg(a, HEADER, _arrays(), codec=codec)
        reader.join(timeout=30)
        assert not reader.is_alive()
    finally:
        a.close()
        b.close()
    # again, this time keeping the raw bytes
    a, b = socket.socketpair()
    try:
        mod.send_msg(a, HEADER, _arrays(), codec=codec)
        a.shutdown(socket.SHUT_WR)
        raw = bytearray()
        while True:
            got = b.recv(1 << 16)
            if not got:
                break
            raw += got
    finally:
        a.close()
        b.close()
    return bytes(raw), sent, chunks[0]


@pytest.mark.parametrize("codec", CODECS)
def test_send_msg_bytes_and_decode_equal_reference(codec):
    ref_bytes, ref_sent, (ref_head, ref_arrays, ref_raw, ref_wire) = _wire(jproto, codec)
    bytes_, sent, (head, arrays, raw, wire) = _wire(pproto, codec)
    assert bytes_ == ref_bytes
    assert sent == ref_sent and (raw, wire) == (ref_raw, ref_wire)
    assert head == ref_head == HEADER
    assert arrays.keys() == ref_arrays.keys() == _arrays().keys()
    for name, want in _arrays().items():
        for got in (arrays[name], ref_arrays[name]):
            assert got.dtype == want.dtype and got.shape == want.shape
            np.testing.assert_array_equal(got, want)
    if codec != "raw":
        assert wire < raw + 4 * 64  # the Z_2^16 share and the zeros shrink


@pytest.mark.parametrize("width", [0, 1, 7, 8, 13, 16, 31, 32, 33, 64])
def test_pack_bits_equals_reference(width):
    rng = np.random.default_rng(width)
    hi = 1 << width if width < 64 else 1 << 63
    arr = rng.integers(0, max(hi, 1), size=(5, 9), dtype=np.uint64)
    want, wbits = jproto.pack_bits(arr, width)
    got, gbits = pproto.pack_bits(arr, width)
    assert (got, gbits) == (want, wbits)
    np.testing.assert_array_equal(pproto.unpack_bits(got, gbits, np.uint64, arr.shape), arr)


def test_negotiation_and_addresses_equal_reference():
    assert pproto.supported_codecs() == jproto.supported_codecs()
    assert pproto.PROTOCOL_VERSION == jproto.PROTOCOL_VERSION
    for peer in (None, ["raw"], ["pack"], ["pack+zlib", "pack", "raw"], ["zstd?"]):
        for prefer in ("auto", "raw", "pack", "pack+zlib", "pack+zstd"):
            assert pproto.negotiate(peer, prefer) == jproto.negotiate(peer, prefer)
    for addr in ("tcp:127.0.0.1:0", "tcp:host:7777", "unix:/tmp/x.sock"):
        assert pproto.parse_address(addr) == jproto.parse_address(addr)
    for bad in ("tcp:nope", "udp:1:2", ""):
        with pytest.raises(ValueError):
            pproto.parse_address(bad)


HOSTFILE = """# cluster
10.0.0.4 slots=8
10.0.0.5 slots=8 port=7777   # second rack
localhost
"""


def _asdict(cfg):
    return dataclasses.asdict(cfg)


def test_pool_config_from_env_equals_reference(tmp_path):
    path = tmp_path / "hosts.txt"
    path.write_text(HOSTFILE)
    envs = [
        {},
        {"REPRO_DIST_WORKERS": "6", "REPRO_DIST_TRANSPORT": "pack",
         "REPRO_DIST_STREAM_CHUNK": "4096", "REPRO_OBS_HTTP_PORT": "0",
         "REPRO_HEDGE_FACTOR": "2.5", "REPRO_HEALTH_EWMA": "0.3"},
        {"REPRO_DIST_HOSTFILE": str(path), "REPRO_DIST_MASTER_ADDR": "tcp:0.0.0.0:9000"},
        {"REPRO_DIST_HOSTFILE": HOSTFILE, "REPRO_DIST_WORKERS": "3"},
    ]
    for env in envs:
        want, got = jconfig.PoolConfig.from_env(env), pconfig.PoolConfig.from_env(env)
        assert _asdict(got) == _asdict(want), env
        assert (got.total_workers, got.multi_host) == (want.total_workers, want.multi_host)
    # overrides win over the environment in both
    env = envs[1]
    assert _asdict(pconfig.PoolConfig.from_env(env, workers=2, transport="raw")) == \
        _asdict(jconfig.PoolConfig.from_env(env, workers=2, transport="raw"))
    # the legacy worker-count variable still works (one deprecation warning)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        legacy = {"REPRO_POOL_WORKERS": "5"}
        assert pconfig.PoolConfig.from_env(legacy).workers == \
            jconfig.PoolConfig.from_env(legacy).workers == 5
    with pytest.raises(ValueError, match="transport"):
        pconfig.PoolConfig(transport="gzip")


def test_parse_hostfile_and_endpoints_equal_reference(tmp_path):
    path = tmp_path / "hosts.txt"
    path.write_text(HOSTFILE)
    for source in (HOSTFILE, str(path), "127.0.0.1 slots=3\n127.0.0.1 slots=3\n"):
        want = jconfig.parse_hostfile(source)
        got = pconfig.parse_hostfile(source)
        assert [dataclasses.asdict(h) for h in got] == [dataclasses.asdict(h) for h in want]
        assert [h.is_local for h in got] == [h.is_local for h in want]
    for bad in ("", "# only a comment\n", "host slots=x\n", "host gpus=4\n"):
        with pytest.raises(ValueError) as ref_err:
            jconfig.parse_hostfile(bad)
        with pytest.raises(ValueError) as port_err:
            pconfig.parse_hostfile(bad)
        assert str(port_err.value) == str(ref_err.value)
    want = jconfig.PoolConfig.from_hostfile(HOSTFILE, transport="pack+zlib")
    got = pconfig.PoolConfig.from_hostfile(HOSTFILE, transport="pack+zlib")
    assert _asdict(got) == _asdict(want)
    for addr in ("tcp:127.0.0.1:0", "unix:/tmp/p.sock", pconfig.Endpoint.tcp("h", 5)):
        ref_addr = addr if isinstance(addr, str) else addr.address
        assert pconfig.Endpoint.parse(addr).address == jconfig.Endpoint.parse(ref_addr).address
