"""Worker-process entrypoint:
``python -m repro_torch.dist.worker --connect ADDR [--device cpu]`` — the
port's counterpart of ``repro.dist.worker``, on the same wire protocol.

On connect the worker sends a ``hello`` capability handshake — device kind
(``"gpu"`` on a card, ``"cpu"`` otherwise, as the reference reports
``jax.default_backend()``), pid, the ring-arithmetic envelope, the wire
codecs it can decode, its autotune coverage (the entries of the committed
tile cache, and those of this device's kind: ``cuda|<card>`` or ``cpu``),
plus the port's own fields: ``torch_version`` and, on a card,
the card's name (``card``) and the kernel library's ``build_info()``
(``kernels``).  Then it serves ``task`` messages until the master says
``shutdown`` or the socket drops.

A task carries the codeword-ring constructor args, a share index and the
two encoded shares (numpy uint32, interleaved (t, r, D)); the worker moves
them to its device, computes the block product ``h = fa @ gb`` with
``repro_torch.kernels.gr_matmul`` and replies with ``h`` in the
connection's codec.  On a card that product runs on one of the
hand-written CUDA routes or not at all: a task whose ring no kernel takes,
or whose header pins ``use_kernel`` false, is answered with an error frame
(``ok: false``) naming the reason, and the plain version never runs there.
On the CPU (``--device cpu``) the product is the plain PyTorch version.

Pipelined streaming: a task header with ``stream: k`` carries no arrays;
``k`` ``chunk`` messages follow, each a contraction-axis slice of
``fa``/``gb``; the worker accumulates ``h = ring.add(h, partial)``, exact
because partial products are already reduced.

A daemon thread pushes ``heartbeat`` messages every ``--heartbeat``
seconds.  Heartbeats and result frames carry the worker's kernel launch
counts (``launches``: ``kernels.counters.launches_by_route``), an extra
header field a JAX master ignores; a ``ping`` is answered by a heartbeat
that echoes the ping's ``seq``, so a master can read counts that include
every task sent before the ping.  ``delay_ms`` / ``inject_fail`` in a task
header are the reference's failure-injection knobs; ``echo`` bounces its
payload back.
"""
from __future__ import annotations

import argparse
import os
import socket
import sys
import threading
import time
from typing import Dict, Optional, Tuple

from ..obs.trace import now as obs_now
from .protocol import (
    PROTOCOL_VERSION,
    ProtocolError,
    connect,
    recv_msg,
    send_msg,
    supported_codecs,
)

__all__ = ["WorkerRuntime", "main"]


def _capabilities(device) -> Dict:
    """The capability handshake payload (device, rings, codecs, autotune)."""
    import torch

    from ..device import device_kind
    from ..kernels.autotune import load_cache

    try:
        cache = load_cache()
        prefix = f"{device_kind(device)}|"
        coverage = sum(1 for k in cache if k.startswith(prefix))
        entries = len(cache)
    except (OSError, ValueError):  # a bad cache must not keep a worker out of the pool
        coverage, entries = 0, 0
    caps = {
        "protocol": PROTOCOL_VERSION,
        "pid": os.getpid(),
        "device": "gpu" if device.type == "cuda" else "cpu",
        "torch_version": torch.__version__,
        # ring envelope mirrors Ring.__init__'s overflow discipline
        "rings": {"p2_max_e": 32, "general_max_q": 1 << 12},
        "codecs": list(supported_codecs()),
        "streaming": True,
        "tracing": True,
        "autotune": {"entries": entries, "device_entries": coverage},
    }
    if device.type == "cuda":
        from ..kernels.build import build_info

        caps["card"] = torch.cuda.get_device_name(device)
        caps["kernels"] = build_info()
    return caps


def _launches() -> Dict[str, int]:
    from ..kernels import counters

    return dict(counters.launches_by_route)


class _StreamState:
    """Accumulator for one in-flight streamed task."""

    def __init__(self, header: Dict, remaining: int):
        self.header = header  # the original task header (ring, knobs, ids)
        self.remaining = remaining
        self.h = None  # running sum, a tensor on the worker's device
        self.wall_us = 0.0
        self.failed = False
        self.t0 = obs_now()  # span start when the task is traced


class WorkerRuntime:
    """One worker's serve loop over an established socket."""

    def __init__(
        self,
        sock: socket.socket,
        name: str = "worker",
        heartbeat_s: float = 1.0,
        device=None,
    ):
        from ..device import resolve_device

        self.sock = sock
        self.name = name
        self.heartbeat_s = heartbeat_s
        self.device = resolve_device(device)
        self._send_lock = threading.Lock()
        self._stop = threading.Event()
        # (p, e, degrees) -> (ring, product, add)
        self._compute: Dict[Tuple, Tuple] = {}
        # (req, task) -> _StreamState for chunked tasks
        self._streams: Dict[Tuple[int, int], _StreamState] = {}
        self.tasks_done = 0
        self.busy_us = 0.0  # cumulative compute wall, shipped in heartbeats

    # -- ring-matmul closures ----------------------------------------------

    def _closure(self, ring_args: Dict, use_kernel):
        """(ring, product, add) for the task's ring on this worker's device.

        ``product(fa, gb)`` takes the numpy shares and returns ``h`` as a
        tensor on the device.  On a card it raises ValueError for a task
        no kernel may take (see module doc)."""
        from ..core.galois import from_numpy, make_ring
        from ..kernels import gr_matmul, kernel_supported

        key = (int(ring_args["p"]), int(ring_args["e"]),
               tuple(int(d) for d in ring_args["degrees"]))
        if key not in self._compute:
            ring = make_ring(*key)
            dev = self.device

            def product(fa, gb):
                return gr_matmul(from_numpy(fa, ring, dev), from_numpy(gb, ring, dev), ring)

            self._compute[key] = (ring, product, ring.add)
        ring, product, add = self._compute[key]
        if self.device.type == "cuda":
            # "auto" and True both mean the kernel; there is no other path
            if use_kernel is False:
                raise ValueError(
                    f"use_kernel=False on the card: {ring}'s product runs on a "
                    "kernel or not at all (a CPU worker runs the plain version)")
            if not kernel_supported(ring):
                raise ValueError(
                    f"{ring} lies outside the kernels' envelope: no kernel takes "
                    "its products on the card")
        return ring, product, add

    # -- messaging ---------------------------------------------------------

    def _send(self, header: Dict, arrays=None, codec: str = "raw") -> None:
        with self._send_lock:
            send_msg(self.sock, header, arrays, codec=codec)

    def _heartbeat(self, **extra) -> Dict:
        return {"type": "heartbeat", "t": time.time(),
                "tasks_done": self.tasks_done,
                "busy_us": round(self.busy_us, 1),
                "launches": _launches(), **extra}

    def _heartbeat_loop(self) -> None:
        while not self._stop.wait(self.heartbeat_s):
            try:
                self._send(self._heartbeat())
            except OSError:
                return  # master gone; the main loop notices on recv

    def _reply(self, header: Dict, ok: bool, h=None, err: str = "",
               wall_us: float = 0.0, t0: Optional[float] = None,
               streamed: int = 0) -> None:
        reply = {
            "type": "result",
            "req": header["req"],
            "task": header["task"],
            "i": header["i"],
            "ok": ok,
            "wall_us": wall_us,
            "launches": _launches(),
        }
        if header.get("trace") and t0 is not None:
            # piggyback the compute span on the result frame; the master
            # re-stamps it with the request's trace id and worker id
            tags: Dict = {"pid": os.getpid(), "ok": ok}
            if streamed:
                tags["streamed"] = streamed
                tags["busy_us"] = round(wall_us, 1)
            reply["spans"] = [{
                "name": "compute", "t0": t0, "t1": obs_now(), "tags": tags,
            }]
        out = {}
        if ok:
            out["h"] = h
        else:
            reply["err"] = err
        # results travel in the codec the master stamped on the task
        self._send(reply, out, codec=header.get("codec", "raw"))
        self.tasks_done += 1
        self.busy_us += wall_us

    def _apply_injection(self, header: Dict) -> None:
        delay_ms = float(header.get("delay_ms", 0.0))
        if delay_ms > 0.0:  # failure-injection knob (see module doc)
            time.sleep(delay_ms / 1e3)
        if header.get("inject_fail"):  # exercises the master's share retry
            raise RuntimeError("injected worker failure")

    def _handle_task(self, header: Dict, arrays: Dict) -> None:
        from ..core.galois import to_numpy

        stream = int(header.get("stream", 0))
        if stream > 0:
            # chunked task: remember the header, accumulate as chunks land
            key = (header["req"], header["task"])
            state = _StreamState(header, stream)
            t0 = time.perf_counter()
            try:
                self._apply_injection(header)
                self._closure(header["ring"], header.get("use_kernel", "auto"))
            except Exception as e:
                state.failed = True
                self._reply(header, ok=False,
                            err=f"{type(e).__name__}: {e}",
                            wall_us=(time.perf_counter() - t0) * 1e6,
                            t0=state.t0, streamed=stream)
            self._streams[key] = state
            return
        tw0 = obs_now()
        t0 = time.perf_counter()
        try:
            self._apply_injection(header)
            _, product, _ = self._closure(header["ring"], header.get("use_kernel", "auto"))
            # the copy back to the host ends the timed region: wall_us is
            # the device round trip, not the launch
            h = to_numpy(product(arrays["fa"], arrays["gb"]))
        except Exception as e:  # computation errors surface at the master
            self._reply(header, ok=False, err=f"{type(e).__name__}: {e}",
                        wall_us=(time.perf_counter() - t0) * 1e6, t0=tw0)
            return
        self._reply(header, ok=True, h=h,
                    wall_us=(time.perf_counter() - t0) * 1e6, t0=tw0)

    def _handle_chunk(self, header: Dict, arrays: Dict) -> None:
        from ..core.galois import to_numpy

        key = (header.get("req"), header.get("task"))
        state = self._streams.get(key)
        if state is None:
            return  # task was re-dispatched elsewhere; drop silently
        state.remaining -= 1
        last = state.remaining <= 0
        if not state.failed:
            t0 = time.perf_counter()
            try:
                _, product, add = self._closure(
                    state.header["ring"], state.header.get("use_kernel", "auto"))
                part = product(arrays["fa"], arrays["gb"])
                state.h = part if state.h is None else add(state.h, part)
                if last:
                    state.h = to_numpy(state.h)
            except Exception as e:
                state.failed = True
                state.wall_us += (time.perf_counter() - t0) * 1e6
                self._reply(state.header, ok=False,
                            err=f"{type(e).__name__}: {e}",
                            wall_us=state.wall_us, t0=state.t0,
                            streamed=int(state.header.get("stream", 0)))
            else:
                state.wall_us += (time.perf_counter() - t0) * 1e6
        if last:
            self._streams.pop(key, None)
            if not state.failed:
                self._reply(state.header, ok=True, h=state.h,
                            wall_us=state.wall_us, t0=state.t0,
                            streamed=int(state.header.get("stream", 0)))

    def serve(self) -> int:
        self._send({"type": "hello", "name": self.name, **_capabilities(self.device)})
        hb = threading.Thread(target=self._heartbeat_loop, daemon=True)
        hb.start()
        try:
            while True:
                try:
                    header, arrays = recv_msg(self.sock)
                except (ProtocolError, OSError):
                    return 0  # master hung up: clean exit
                kind = header.get("type")
                if kind == "task":
                    self._handle_task(header, arrays)
                elif kind == "chunk":
                    self._handle_chunk(header, arrays)
                elif kind == "echo":
                    self._send({"type": "echo_reply",
                                "seq": header.get("seq")}, arrays,
                               codec=header.get("codec", "raw"))
                elif kind == "ping":
                    # answered after every task received before it
                    self._send(self._heartbeat(ping=header.get("seq")))
                elif kind == "shutdown":
                    return 0
                # unknown types are ignored: forward-compatible masters
        finally:
            self._stop.set()
            try:
                self.sock.close()
            except OSError:
                pass


def main(argv: Optional[list] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument(
        "--connect", required=True, metavar="ADDR",
        help="master address: tcp:HOST:PORT or unix:/path/to.sock",
    )
    ap.add_argument("--name", default=f"worker-{os.getpid()}")
    ap.add_argument(
        "--heartbeat", type=float, default=1.0, metavar="SECONDS",
        help="heartbeat push interval (default 1s)",
    )
    ap.add_argument(
        "--connect-timeout", type=float, default=30.0, metavar="SECONDS",
    )
    ap.add_argument(
        "--device", default=None,
        help="torch device of the products (default: the card; cpu runs "
        "the plain version)",
    )
    args = ap.parse_args(argv)
    from ..device import resolve_device

    try:
        device = resolve_device(args.device)
    except RuntimeError as e:
        print(f"repro_torch.dist.worker: {e}", file=sys.stderr)
        return 2
    import torch

    if device.type == "cpu":
        # one intra-op thread: the pool's W worker processes share the
        # host's cores, and W thread teams would oversubscribe them
        torch.set_num_threads(1)
    else:
        from ..kernels.build import load_library

        load_library()  # built by the master before it spawned us: a dlopen
        torch.zeros(1, device=device)  # the CUDA context, before the hello
    sock = connect(args.connect, timeout=args.connect_timeout)
    return WorkerRuntime(sock, args.name, args.heartbeat, device=device).serve()


if __name__ == "__main__":
    sys.exit(main())
