"""Transport layer: the pluggable unreliable-datagram seam (the reference's
`network/sockets.py`, copied without the pre-encoded and batched send lanes
that only its native endpoints and batched pump use).

`UdpNonBlockingSocket` is real nonblocking UDP; `InMemoryNetwork` is a
virtual network with programmable latency, jitter, loss and duplication,
driven by a seeded RNG and an injectable clock — deterministic protocol
tests without real sockets. Both carry the real wire bytes.
"""

from __future__ import annotations

import heapq
import random
import socket as _socket
from typing import Any, Dict, List, Protocol, Tuple

from ..errors import InvalidRequest
from ..utils.clock import Clock
from .messages import Message, decode_all, encode_message

# Sized to cover the largest datagram UDP can carry (65507 payload bytes):
# recvfrom() drops whatever outgrows its buffer without an error.
RECV_BUFFER_SIZE = 65536
# the bound senders enforce: the receive buffer, capped at the largest
# payload UDP itself can carry
MAX_DATAGRAM_SIZE = min(RECV_BUFFER_SIZE, 65507)


def check_datagram_size(wire: bytes) -> bytes:
    """Every send path funnels through here, so a message that could not
    survive recvfrom() (or UDP itself) raises at the sender instead of
    being truncated at the receiver. A real exception (not an assert) so
    the guard survives `python -O`."""
    if len(wire) > MAX_DATAGRAM_SIZE:
        raise InvalidRequest(
            f"datagram of {len(wire)} bytes exceeds MAX_DATAGRAM_SIZE "
            f"({MAX_DATAGRAM_SIZE}): it would be truncated or rejected by "
            "the real transport — split the message or grow the buffer"
        )
    return wire


class NonBlockingSocket(Protocol):
    """Unreliable, unordered datagram transport. The endpoint protocol layers
    reliability on top; implementations must never block."""

    def send_to(self, msg: Message, addr: Any) -> None: ...

    def receive_all_messages(self) -> List[Tuple[Any, Message]]: ...


class UdpNonBlockingSocket:
    """Nonblocking UDP bound to 0.0.0.0:port. Addresses are (host, port)
    tuples."""

    def __init__(self, port: int):
        self.sock = _socket.socket(_socket.AF_INET, _socket.SOCK_DGRAM)
        self.sock.bind(("0.0.0.0", port))
        self.sock.setblocking(False)

    @property
    def local_port(self) -> int:
        return self.sock.getsockname()[1]

    def send_to(self, msg: Message, addr: Any) -> None:
        self.sock.sendto(check_datagram_size(encode_message(msg)), addr)

    def receive_all_wire(self) -> List[Tuple[Any, bytes]]:
        """Raw datagrams, before the codec."""
        received: List[Tuple[Any, bytes]] = []
        while True:
            try:
                buf, src = self.sock.recvfrom(RECV_BUFFER_SIZE)
            except BlockingIOError:
                return received
            except ConnectionResetError:
                continue
            received.append((src, buf))

    def receive_all_messages(self) -> List[Tuple[Any, Message]]:
        return decode_all(self.receive_all_wire())

    def close(self) -> None:
        self.sock.close()


class InMemoryNetwork:
    """A hub of virtual endpoints sharing one fault model and one clock:
    flat latency, jitter, loss and duplication for every link.
    `blackholed` addresses drop everything in and out silently, before any
    draw of the RNG, as the reference's do. (The reference's per-link
    `FaultProfile` serves its chaos harness and is left out.)"""

    def __init__(
        self,
        clock: Clock,
        *,
        latency_ms: int = 0,
        jitter_ms: int = 0,
        loss: float = 0.0,
        duplicate: float = 0.0,
        seed: int = 0,
    ):
        self.clock = clock
        self.latency_ms = latency_ms
        self.jitter_ms = jitter_ms
        self.loss = loss
        self.duplicate = duplicate
        self.rng = random.Random(seed)
        self.blackholed: set = set()
        # addr -> heap of (deliver_at_ms, seq, (src, wire_bytes))
        self.queues: Dict[Any, List[Tuple[int, int, Tuple[Any, bytes]]]] = {}
        self._seq = 0

    def socket(self, addr: Any) -> "InMemorySocket":
        self.queues.setdefault(addr, [])
        return InMemorySocket(self, addr)

    def set_blackhole(self, addrs, on: bool = True) -> None:
        """Silently drop all traffic to AND from these addresses (on) or
        lift the blackout (off). Queued-but-undelivered datagrams are left
        to deliver: they were already in the air."""
        if on:
            self.blackholed.update(addrs)
        else:
            self.blackholed.difference_update(addrs)

    def _deliver(self, src: Any, dst: Any, wire: bytes) -> None:
        if src in self.blackholed or dst in self.blackholed:
            return
        if self.rng.random() < self.loss:
            return
        copies = 2 if self.rng.random() < self.duplicate else 1
        delays = []
        for _ in range(copies):
            delay = self.latency_ms
            if self.jitter_ms:
                delay += self.rng.randint(0, self.jitter_ms)
            delays.append(delay)
        now = self.clock.now_ms()
        for delay in delays:
            self._seq += 1
            heapq.heappush(
                self.queues.setdefault(dst, []),
                (now + delay, self._seq, (src, wire)),
            )

    def _drain_wire(self, addr: Any) -> List[Tuple[Any, bytes]]:
        q = self.queues.setdefault(addr, [])
        now = self.clock.now_ms()
        out: List[Tuple[Any, bytes]] = []
        while q and q[0][0] <= now:
            _, _, (src, wire) = heapq.heappop(q)
            out.append((src, wire))
        return out


class InMemorySocket:
    """One endpoint's view of an InMemoryNetwork; satisfies NonBlockingSocket."""

    def __init__(self, net: InMemoryNetwork, addr: Any):
        self.net = net
        self.addr = addr

    def send_to(self, msg: Message, addr: Any) -> None:
        # serialize through the real wire codec so fault tests cover it
        self.net._deliver(self.addr, addr, check_datagram_size(encode_message(msg)))

    def receive_all_wire(self) -> List[Tuple[Any, bytes]]:
        return self.net._drain_wire(self.addr)

    def receive_all_messages(self) -> List[Tuple[Any, Message]]:
        return decode_all(self.receive_all_wire())
