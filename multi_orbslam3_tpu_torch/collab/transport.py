"""Injectable transports for the client<->server delta streams.

The reference touches ROS only through mPubMap/mSubMap
(src/Communicator.cc:110-153) — the injectability SURVEY.md §4 calls out
as the test seam. Same here: systems talk to a Transport interface;
tests and single-host runs use in-process queues; a TCP length-prefixed
socket transport covers true multi-process deployments (the gRPC/DCN
slot). Payloads are opaque bytes (MapDelta.to_bytes).

Shutdown semantics: every socket endpoint owns its receive threads and
``close()`` performs a full handshake — stop flag, socket shutdown, and
a bounded join — so no daemon thread ever touches a socket object while
the interpreter is finalizing (a raw daemon ``recv`` during teardown can
segfault CPython). Endpoints also register an atexit hook as a backstop
for callers that never call close(). The client reconnects on a dropped
connection (the reference gets this from roscpp's reconnect).
"""

from __future__ import annotations

import atexit
import collections
import socket
import struct
import threading
import time
from typing import Dict, List, Optional


class Transport:
    """Bidirectional channel endpoints keyed by (agent_id, direction)."""

    def send_up(self, agent: int, payload: bytes) -> None:      # client -> server
        raise NotImplementedError

    def send_down(self, agent: int, payload: bytes) -> None:    # server -> client
        raise NotImplementedError

    def poll_up(self, agent: int) -> List[bytes]:               # server side
        raise NotImplementedError

    def poll_down(self, agent: int) -> List[bytes]:             # client side
        raise NotImplementedError


class InProcessTransport(Transport):
    """Queue-pair transport for tests and single-process multi-agent runs."""

    def __init__(self):
        self._up: Dict[int, collections.deque] = collections.defaultdict(
            collections.deque)
        self._down: Dict[int, collections.deque] = collections.defaultdict(
            collections.deque)
        self._lock = threading.Lock()
        self.bytes_up = 0
        self.bytes_down = 0

    def send_up(self, agent: int, payload: bytes) -> None:
        with self._lock:
            self._up[agent].append(payload)
            self.bytes_up += len(payload)

    def send_down(self, agent: int, payload: bytes) -> None:
        with self._lock:
            self._down[agent].append(payload)
            self.bytes_down += len(payload)

    def _drain(self, q) -> List[bytes]:
        out = []
        with self._lock:
            while q:
                out.append(q.popleft())
        return out

    def poll_up(self, agent: int) -> List[bytes]:
        return self._drain(self._up[agent])

    def poll_down(self, agent: int) -> List[bytes]:
        return self._drain(self._down[agent])


# ---------------------------------------------------------------------------
# Length-prefixed TCP transport (multi-process deployments).
# Frame: uint32 agent | uint8 direction (0 up, 1 down) | uint32 len | bytes.
# ---------------------------------------------------------------------------

_HDR = struct.Struct(">IBI")


class SocketTransportServer(Transport):
    """Server-side endpoint: accepts one connection per client process."""

    def __init__(self, host: str = "127.0.0.1", port: int = 0):
        self._srv = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._srv.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._srv.bind((host, port))
        self._srv.listen(16)
        self.port = self._srv.getsockname()[1]
        self._conns: Dict[int, socket.socket] = {}
        self._inbox: Dict[int, collections.deque] = collections.defaultdict(
            collections.deque)
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._threads: List[threading.Thread] = []
        self._accept_thread = threading.Thread(target=self._accept_loop,
                                               daemon=True)
        self._accept_thread.start()
        atexit.register(self.close)

    def _accept_loop(self):
        while not self._stop.is_set():
            try:
                conn, _ = self._srv.accept()
            except OSError:
                return
            t = threading.Thread(target=self._recv_loop, args=(conn,),
                                 daemon=True)
            with self._lock:
                self._threads.append(t)
            t.start()

    def _recv_loop(self, conn: socket.socket):
        try:
            while not self._stop.is_set():
                hdr = _recv_exact(conn, _HDR.size)
                if hdr is None:
                    return
                agent, direction, ln = _HDR.unpack(hdr)
                payload = _recv_exact(conn, ln)
                if payload is None:
                    return
                with self._lock:
                    self._conns[agent] = conn
                    self._inbox[agent].append(payload)
        except (OSError, ValueError):
            return
        finally:
            with self._lock:
                for a, c2 in list(self._conns.items()):
                    if c2 is conn:
                        del self._conns[a]
            try:
                conn.close()
            except OSError:
                pass

    def send_down(self, agent: int, payload: bytes) -> None:
        with self._lock:
            conn = self._conns.get(agent)
        if conn is not None:
            try:
                conn.sendall(_HDR.pack(agent, 1, len(payload)) + payload)
            except OSError:
                # client dropped: forget the connection; the client
                # reconnects and re-registers on its next uplink
                with self._lock:
                    if self._conns.get(agent) is conn:
                        del self._conns[agent]

    def poll_up(self, agent: int) -> List[bytes]:
        out = []
        with self._lock:
            q = self._inbox[agent]
            while q:
                out.append(q.popleft())
        return out

    def connected_agents(self) -> List[int]:
        """Agents with a live registered connection (deployment
        orchestration: run_server's --idle-exit watches this)."""
        with self._lock:
            return sorted(self._conns)

    def send_up(self, agent: int, payload: bytes) -> None:
        raise RuntimeError("server endpoint cannot send_up")

    def poll_down(self, agent: int) -> List[bytes]:
        raise RuntimeError("server endpoint cannot poll_down")

    def close(self):
        """Shutdown handshake: stop flag -> unblock every blocking recv by
        shutting the sockets down -> join the recv threads (bounded)."""
        if self._stop.is_set():
            return
        self._stop.set()
        atexit.unregister(self.close)
        # shutdown unblocks a thread parked in accept() (close alone does
        # not on Linux); a connect would also work but shutdown is racefree
        _shutdown_socket(self._srv)
        with self._lock:
            conns = list(self._conns.values())
            threads = list(self._threads)
            self._conns.clear()
        for conn in conns:
            _shutdown_socket(conn)
        self._accept_thread.join(timeout=2.0)
        for t in threads:
            t.join(timeout=2.0)


class SocketTransportClient(Transport):
    """Client-side endpoint for one agent. Reconnects on a dropped
    connection (bounded retries with backoff)."""

    def __init__(self, agent: int, host: str, port: int,
                 reconnect_tries: int = 20):
        self.agent = agent
        self._host, self._port = host, port
        self._reconnect_tries = reconnect_tries
        self._sock = socket.create_connection((host, port))
        self._inbox: collections.deque = collections.deque()
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._recv_loop, daemon=True)
        self._thread.start()
        atexit.register(self.close)

    def _reconnect(self) -> bool:
        for _ in range(self._reconnect_tries):
            if self._stop.is_set():
                return False
            try:
                sock = socket.create_connection(
                    (self._host, self._port), timeout=2.0)
                sock.settimeout(None)
                with self._lock:
                    self._sock = sock
                return True
            except OSError:
                time.sleep(0.25)
        return False

    def _recv_loop(self):
        while not self._stop.is_set():
            with self._lock:
                sock = self._sock
            try:
                hdr = _recv_exact(sock, _HDR.size)
                if hdr is None:
                    raise OSError("peer closed")
                _, _, ln = _HDR.unpack(hdr)
                payload = _recv_exact(sock, ln)
                if payload is None:
                    raise OSError("peer closed")
                with self._lock:
                    self._inbox.append(payload)
            except (OSError, ValueError):
                if self._stop.is_set() or not self._reconnect():
                    return

    def send_up(self, agent: int, payload: bytes) -> None:
        frame = _HDR.pack(self.agent, 0, len(payload)) + payload
        with self._lock:
            sock = self._sock
        try:
            sock.sendall(frame)
        except OSError:
            # one retry after reconnect; beyond that the delta stays in
            # the caller's unacked outbox and is resent next cycle
            if self._reconnect():
                with self._lock:
                    sock = self._sock
                try:
                    sock.sendall(frame)
                except OSError:
                    pass

    def poll_down(self, agent: int) -> List[bytes]:
        out = []
        with self._lock:
            while self._inbox:
                out.append(self._inbox.popleft())
        return out

    def send_down(self, agent: int, payload: bytes) -> None:
        raise RuntimeError("client endpoint cannot send_down")

    def poll_up(self, agent: int) -> List[bytes]:
        raise RuntimeError("client endpoint cannot poll_up")

    def close(self):
        if self._stop.is_set():
            return
        self._stop.set()
        atexit.unregister(self.close)
        with self._lock:
            sock = self._sock
        _shutdown_socket(sock)
        self._thread.join(timeout=2.0)


def _shutdown_socket(sock: socket.socket) -> None:
    try:
        sock.shutdown(socket.SHUT_RDWR)
    except OSError:
        pass
    try:
        sock.close()
    except OSError:
        pass


def _recv_exact(conn: socket.socket, n: int) -> Optional[bytes]:
    buf = b""
    while len(buf) < n:
        chunk = conn.recv(n - len(buf))
        if not chunk:
            return None
        buf += chunk
    return buf
