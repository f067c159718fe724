"""Wire protocol of the serving pool: framed JSON and raw array payloads
over persistent, multiplexed channels.

Counterpart of ``csmom_tpu.serve.proto``, copied: the frame bytes are
the reference's for the same header and arrays, so a port worker
answers a reference client and the other way round.  Stdlib and numpy
only: the supervisor's monitor loop and the health probes never import
torch.

A frame is a 4-byte big-endian length, then a length-prefixed JSON
header, then the raw bytes of each array the header declares (name,
dtype, shape, nbytes, in order).  Binary payloads because a request
panel is up to ``128 x 60`` float32; JSON headers so every control field
stays readable in a socket dump.

**Addresses**: ``unix:/path/w0.sock`` (an ``AF_UNIX`` stream socket),
``tcp:host:port`` (``AF_INET``), or a bare path (unix).

**Persistent multiplexed channels** (the request path):

- :class:`Channel`: one connected stream socket (``TCP_NODELAY`` and
  ``SO_KEEPALIVE``), one writer lock serializing frames out, and
  leader/follower demultiplexing in: the first waiting dispatcher takes
  the read baton, parses every arriving frame and delivers each reply
  to the waiter registered under its echoed ``_mux`` id, so many
  in-flight requests share one socket, an out-of-order reply settles
  the right waiter, and an idle channel parks no thread.  A reply with
  no ``_mux`` settles the only pending request (a legacy in-order peer).
- :class:`ChannelPool`: a bounded number of channels a peer, a pipeline
  depth a channel, lazy idle reaping, and reconnect with exponential
  backoff (a refusing peer fails fast until the backoff expires).  A
  request that fails on a REUSED channel before its reply is retried
  once on a freshly dialed one: a pooled channel whose peer restarted
  costs a redial, not a failover.
- Low-copy payloads: array specs are encoded once per ``(name, dtype,
  shape)``; a frame goes out as one scatter-gather ``sendmsg`` of the
  header and each array's own buffer; the receive side reads into a
  reusable buffer.  :class:`HeaderTemplate` pre-encodes a request's
  invariant header fields.

Bounds: a frame larger than ``MAX_FRAME_BYTES`` is refused on its
length prefix, before the payload is allocated, and array specs must
reconcile with the frame's byte count before an array is built.  Once a
frame starts arriving it must land within ``deadline_s``
(``RECV_DEADLINE_S``), the socket timeout re-armed from the remaining
budget on every read, so a stalled or trickling peer raises a
:class:`ProtocolError`; idle between frames is healthy and waits under
its own budget.  :func:`request_once` is the one-shot connect / send /
receive / close for probes and lifecycle ops (ping, ready, stats,
drain, stop); the request path uses :class:`ChannelPool`.

**Chaos** (the ``serve.transport`` checkpoint): every ``score`` dispatch
visits it before touching the wire.  ``conn_reset`` raises a connection
reset into the caller's failover; ``net_delay`` stalls the transport by
``CSMOM_CHAOS_NET_DELAY_S`` (a straggler for the hedging policy);
``partition`` cuts this process off from the peer for
``CSMOM_CHAOS_PARTITION_S`` seconds: every live channel to it is
severed at once, failing its in-flight requests, and every dial fails
until the partition heals.  Probe and lifecycle ops do not visit it.

A ``score`` header may carry a ``trace`` entry (identity only, never
timestamps), and the peer's reply then carries a ``trace_half`` with
its server-side stage chain; the channel reports when it was acquired
and when the frame finished sending (``marks``).

Ops a worker answers (:mod:`csmom_tpu_torch.serve.worker`); a router
replica answers the same lifecycle set, and the fleet aggregator
(:mod:`csmom_tpu_torch.obs.fleet`) answers ``stats_stream``:

============  ==================================================
op            meaning
============  ==================================================
ping          liveness: the process responds
ready         readiness report (warm, self-probe, cache version)
score         one scoring request (arrays: values, mask)
stats         accounting, batch stats, builds and kernel launches
tune_quota    retune one SLO class's admission quota (the fleet's
              autoscaler; a worker only)
stats_stream  one metrics snapshot delta, emitter -> fleet
              aggregator: a lifecycle op on a persistent channel,
              never the request path, and free of chaos faults
              (``serve.transport`` faults fire only for ``score``)
drain         stop admitting, drain the queue, report accounting
stop          drain, then exit the process
============  ==================================================
"""

from __future__ import annotations

import functools
import itertools
import json
import math
import os
import socket
import struct
import threading
import time

import numpy as np

from csmom_tpu_torch.utils.deadline import mono_now_s

__all__ = ["Channel", "ChannelPool", "HeaderTemplate", "MAX_FRAME_BYTES",
           "ProtocolError", "RECV_DEADLINE_S", "ReplyTimeout",
           "ScoreHeaderCache", "connect", "free_tcp_port", "listen",
           "parse_address", "recv_msg", "request", "request_once",
           "send_msg", "serve_connection", "tune_stream_socket",
           "unlink_address"]

# largest legal frame: the biggest production micro-panel is ~30 KB, so
# 32 MB is three orders of magnitude of headroom while still refusing a
# garbage length prefix before it can exhaust memory
MAX_FRAME_BYTES = 32 * 1024 * 1024

# total budget for receiving ONE frame (header + payload) once its
# first byte arrived.  Generous against any honest peer (a full frame
# is one sendmsg away), tight against a wedged one: a peer that stops
# mid-frame costs this much wall, never a thread forever.
RECV_DEADLINE_S = 30.0

# how long an accepted SERVER connection may sit idle between frames
# before the serve loop closes it (resource hygiene; the client pool
# transparently redials).  Client channels park no thread while idle —
# the pool's idle reaper owns their lifecycle.
SERVE_IDLE_S = 300.0

_LEN = struct.Struct("!I")

# chaos partition state (the `partition` action at serve.transport):
# peer address -> monotonic heal time.  Process-local on purpose — a
# partition separates THIS process from a peer host, not the world.
# Shared between the pooled and one-shot paths so a partition armed on
# either starves both.
_PARTITION_LOCK = threading.Lock()
_PARTITIONED: dict = {}

# fault-duration knobs (chaos actions are caller-interpreted and the
# checkpoint returns only the action name, so durations ride the same
# env channel the plans do)
PARTITION_ENV = "CSMOM_CHAOS_PARTITION_S"
NET_DELAY_ENV = "CSMOM_CHAOS_NET_DELAY_S"
_PARTITION_DEFAULT_S = 1.0
_NET_DELAY_DEFAULT_S = 0.25


class ProtocolError(RuntimeError):
    """A malformed frame (bad length, truncated payload, spec mismatch,
    or a receive deadline expiring on a stalled peer)."""


class FrameEncodeError(ProtocolError):
    """The caller's own frame could not be encoded (oversized arrays,
    malformed header core) — nothing touched the wire, so retrying on a
    fresh channel can only waste a dial and mask the diagnostic."""


class ReplyTimeout(ProtocolError):
    """A multiplexed request outwaited its reply budget.  The CHANNEL
    is still healthy (other requests may be in flight and the peer may
    still answer — a late reply is dropped by the demux) — only this
    request's attempt failed, so the pool must not redial over it."""


# ------------------------------------------------------------ addresses ---

def parse_address(address: str) -> tuple:
    """``("unix", path)`` or ``("tcp", (host, port))`` for an address
    string.  Bare paths are unix; ``tcp:`` needs
    ``host:port`` with an integer port."""
    if address.startswith("unix:"):
        path = address[len("unix:"):]
        if not path:
            raise ValueError(f"empty unix socket path in {address!r}")
        return "unix", path
    if address.startswith("tcp:"):
        rest = address[len("tcp:"):]
        host, sep, port_s = rest.rpartition(":")
        if not sep or not host:
            raise ValueError(
                f"bad tcp address {address!r}: use tcp:host:port")
        try:
            port = int(port_s)
        except ValueError:
            raise ValueError(
                f"bad tcp port in {address!r}: {port_s!r} is not an "
                "integer") from None
        if not 0 <= port <= 65535:
            raise ValueError(f"tcp port {port} outside [0, 65535]")
        return "tcp", (host, port)
    return "unix", address


def free_tcp_port(host: str = "127.0.0.1") -> int:
    """One currently-free TCP port (bind-to-0 then release).  Classic
    small race with other port grabbers; fine for the loopback fabrics
    the supervisor spawns, where it owns the port range in practice."""
    s = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
    try:
        s.bind((host, 0))
        return int(s.getsockname()[1])
    finally:
        s.close()


def tune_stream_socket(sock: socket.socket) -> None:
    """Per-connection socket options, applied on BOTH the connect and
    the accept side of every stream: ``TCP_NODELAY`` because the framed
    replies are small and latency-critical — Nagle would sit on a
    sub-MSS reply frame waiting for an ACK that is itself delayed,
    a 40 ms quantum on every reply — and ``SO_KEEPALIVE`` so a silently vanished peer (host partition,
    container kill) eventually reads as a dead channel instead of a
    socket that stays "connected" forever.  Unix sockets have neither
    knob (no Nagle, no keepalive) and are left alone."""
    if sock.family != socket.AF_INET:
        return
    try:
        sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        sock.setsockopt(socket.SOL_SOCKET, socket.SO_KEEPALIVE, 1)
    except OSError:
        pass  # an already-reset socket: the first send will report it


def listen(address: str, backlog: int = 64) -> socket.socket:
    """A bound, listening server socket for ``address`` (unix or tcp).
    Unix paths are unlinked first (a crashed predecessor's stale socket
    file must not block the bind); tcp sets ``SO_REUSEADDR`` for the
    same reason."""
    scheme, target = parse_address(address)
    if scheme == "unix":
        try:
            os.unlink(target)
        except OSError:
            pass
        srv = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
        srv.bind(target)
    else:
        srv = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        srv.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        srv.bind(target)
    srv.listen(backlog)
    return srv


def unlink_address(address: str) -> None:
    """Remove a unix socket path (no-op for tcp) — shutdown hygiene."""
    scheme, target = parse_address(address)
    if scheme == "unix":
        try:
            os.unlink(target)
        except OSError:
            pass


def _partition_reason(address: str) -> str:
    return (f"chaos partition: this process is partitioned from "
            f"{address} (heals in <= "
            f"{os.environ.get(PARTITION_ENV, _PARTITION_DEFAULT_S)}s)")


def _partitioned_until(address: str) -> float | None:
    with _PARTITION_LOCK:
        heal_at = _PARTITIONED.get(address)
        if heal_at is None:
            return None
        if mono_now_s() >= heal_at:
            del _PARTITIONED[address]
            return None
        return heal_at


def _chaos_env_s(env: str, default_s: float) -> float:
    """A chaos duration knob from the environment, defaulting on a
    malformed value — a typo'd \"250ms\" must degrade to the default
    fault, not raise an unhandled ValueError through the dispatch
    thread and strand its request non-terminal."""
    raw = os.environ.get(env)
    if not raw:
        return default_s
    try:
        return float(raw)
    except ValueError:
        return default_s


def _chaos_transport(address: str, op: str, on_partition=None) -> None:
    """The ``serve.transport`` checkpoint, fired per score dispatch.

    Caller-interpreted actions: ``conn_reset`` raises into the caller's
    existing connection-failure handling; ``net_delay`` sleeps the
    configured straggler delay; ``partition`` cuts this process off from
    ``address`` for the configured window.  ``on_partition(address,
    reason)`` is the persistent-channel hook: the pool severs every
    LIVE channel to the peer so in-flight requests reason-close — a
    partition breaks streams mid-flight, not just future dials.  An
    already-armed partition fails the dispatch whether or not a fault
    fires on this visit.
    """
    from csmom_tpu_torch.chaos.inject import checkpoint

    fired = checkpoint("serve.transport", addr=address, op=op)
    if fired == "partition":
        heal_s = _chaos_env_s(PARTITION_ENV, _PARTITION_DEFAULT_S)
        with _PARTITION_LOCK:
            _PARTITIONED[address] = mono_now_s() + heal_s
    elif fired == "net_delay":
        time.sleep(_chaos_env_s(NET_DELAY_ENV, _NET_DELAY_DEFAULT_S))
    elif fired == "conn_reset":
        raise ConnectionResetError(
            f"chaos conn_reset injected at serve.transport (peer "
            f"{address})")
    if _partitioned_until(address) is not None:
        reason = _partition_reason(address)
        if on_partition is not None:
            on_partition(address, reason)
        raise ConnectionRefusedError(reason)


def connect(address: str, timeout_s: float) -> socket.socket:
    """One connected, timeout-armed, tuned client socket to a peer."""
    scheme, target = parse_address(address)
    family = socket.AF_UNIX if scheme == "unix" else socket.AF_INET
    sock = socket.socket(family, socket.SOCK_STREAM)
    sock.settimeout(timeout_s)
    try:
        sock.connect(target)
    except OSError:
        sock.close()
        raise
    tune_stream_socket(sock)
    return sock


# ------------------------------------------------------------- encoding ---

@functools.lru_cache(maxsize=1024)
def _spec_fragment(name: str, dtype: str, shape: tuple,
                   nbytes: int) -> bytes:
    """One array's header spec as pre-encoded JSON.  The serve tiers
    dispatch the SAME few (name, dtype, bucket-shape) combinations for
    an entire run, so the per-request spec encode collapses to a dict
    probe instead of a ``json.dumps`` of invariant fields."""
    return json.dumps({"name": name, "dtype": dtype,
                       "shape": list(shape), "nbytes": nbytes}).encode()


def _encode_frame(header_core: bytes, arrays: dict | None,
                  mux_id: int | None) -> tuple:
    """``(buffers, total_len)`` for one frame: the length-prefixed
    header (with ``_mux`` and ``_arrays`` spliced into the core object
    bytes) followed by each array's OWN buffer — no payload
    concatenation; the socket layer gathers them."""
    blobs = []
    specs = []
    nbytes_total = 0
    for name, arr in (arrays or {}).items():
        a = np.ascontiguousarray(arr)
        specs.append(_spec_fragment(name, str(a.dtype), a.shape,
                                    int(a.nbytes)))
        blobs.append(a)
        nbytes_total += int(a.nbytes)
    if header_core[:1] != b"{" or header_core[-1:] != b"}":
        raise ProtocolError(
            "header core must be an encoded JSON object (a malformed "
            "template would splice into an unparseable frame and kill "
            "the whole channel at the peer)")
    parts = [header_core[:-1]]
    sep = b"" if header_core == b"{}" else b","
    if mux_id is not None:
        parts.append(sep + b'"_mux":%d' % mux_id)
        sep = b","
    parts.append(sep + b'"_arrays":[' + b",".join(specs) + b"]}")
    hb = b"".join(parts)
    total = _LEN.size + len(hb) + nbytes_total
    if 2 * _LEN.size + len(hb) + nbytes_total > MAX_FRAME_BYTES:
        raise ProtocolError(
            f"frame of {2 * _LEN.size + len(hb) + nbytes_total} bytes "
            f"exceeds MAX_FRAME_BYTES ({MAX_FRAME_BYTES}); split the "
            "request")
    head = _LEN.pack(total) + _LEN.pack(len(hb)) + hb
    buffers = [head]
    for a in blobs:
        buffers.append(memoryview(a).cast("B"))
    return buffers, total


def _send_buffers(sock: socket.socket, buffers: list) -> None:
    """Scatter-gather send: the kernel walks the iovec instead of this
    process concatenating header + payload into one throwaway bytes
    object per frame.  Handles partial sends (sendmsg is not sendall)."""
    views = [memoryview(b) for b in buffers]
    if not hasattr(sock, "sendmsg"):  # pragma: no cover - posix has it
        sock.sendall(b"".join(views))
        return
    while views:
        sent = sock.sendmsg(views)
        while sent > 0 and views:
            if sent >= len(views[0]):
                sent -= len(views[0])
                views.pop(0)
            else:
                views[0] = views[0][sent:]
                sent = 0


class HeaderTemplate:
    """Pre-encoded invariant header fields for the request hot path.

    A dispatch tier's score headers repeat the same op / kind /
    priority / panel-version fields thousands of times per run;
    ``render`` splices only the per-request variable fields (req id,
    deadline, trace identity) onto the cached prefix instead of
    re-``json.dumps``-ing the whole header every dispatch.  ``render``
    returns header-core BYTES accepted by :meth:`Channel.request` and
    :meth:`ChannelPool.request` wherever a header dict is."""

    __slots__ = ("_prefix", "_empty")

    def __init__(self, **invariant):
        core = json.dumps(invariant, separators=(",", ":"))
        self._prefix = core[:-1].encode()
        self._empty = core == "{}"

    def render(self, **variable) -> bytes:
        if not variable:
            return self._prefix + b"}"
        frag = json.dumps(variable, separators=(",", ":")).encode()
        sep = b"" if self._empty else b","
        return self._prefix + sep + frag[1:]


class ScoreHeaderCache:
    """Per-``(kind, class, panel_version)`` pre-encoded score headers —
    the ONE implementation both dispatch tiers (router → workers,
    fabric client → replicas) render their hot-path frames through, so
    a header-field or cache-policy change cannot silently diverge the
    two wire formats.  Bounded: the key space is tiny in production
    (endpoints × classes × one live panel version); a runaway key space
    clears and starts over."""

    __slots__ = ("_templates", "_bound")

    def __init__(self, bound: int = 256):
        self._templates: dict = {}
        self._bound = bound

    def render(self, kind: str, priority: str, panel_version,
               req_id: int, deadline_rel_s, trace_ctx=None) -> bytes:
        key = (kind, priority, panel_version)
        tmpl = self._templates.get(key)
        if tmpl is None:
            if len(self._templates) > self._bound:
                self._templates.clear()
            tmpl = self._templates[key] = HeaderTemplate(
                op="score", kind=kind, priority=priority,
                panel_version=panel_version)
        variable = {"req_id": req_id, "deadline_rel_s": deadline_rel_s}
        if trace_ctx is not None:
            wire = trace_ctx.to_wire()
            if wire is not None:
                # the trace context crosses the process boundary in the
                # frame header (identity only, never timestamps): the
                # peer answers with its half, and the two stitch at the
                # dispatcher
                variable["trace"] = wire
        return tmpl.render(**variable)


def _header_core(obj) -> bytes:
    """Header-core bytes from a dict or pre-rendered template bytes."""
    if isinstance(obj, (bytes, bytearray)):
        return bytes(obj)
    return json.dumps(obj).encode("utf-8")


def send_msg(sock: socket.socket, obj, arrays: dict | None = None) -> None:
    """Send one frame: ``obj`` (a dict, or header-core bytes from
    :meth:`HeaderTemplate.render`) as the JSON header plus raw array
    bytes, scatter-gathered onto the socket."""
    buffers, _ = _encode_frame(_header_core(obj), arrays, None)
    _send_buffers(sock, buffers)


# ------------------------------------------------------------- receiving ---

def _recv_into_exact(sock: socket.socket, mv: memoryview,
                     give_up_s: float) -> None:
    """Fill ``mv`` from ``sock`` before the ``give_up_s`` monotonic
    deadline, reading INTO the caller's buffer (no per-chunk bytes
    objects, no final join copy).  The socket timeout is re-armed per
    read from the REMAINING budget — a peer trickling one byte per
    timeout window used to reset the clock forever; now the total wall
    is bounded."""
    n = len(mv)
    got = 0
    while got < n:
        remaining = give_up_s - mono_now_s()
        if remaining <= 0:
            raise ProtocolError(
                f"receive deadline expired mid-frame ({got}/{n} "
                "bytes read) — the peer stalled; closing rather than "
                "wedging this thread")
        sock.settimeout(remaining)
        try:
            k = sock.recv_into(mv[got:])
        except socket.timeout:
            raise ProtocolError(
                f"receive deadline expired mid-frame ({got}/{n} "
                "bytes read) — the peer stalled; closing rather than "
                "wedging this thread") from None
        if not k:
            raise ProtocolError(
                f"connection closed mid-frame ({got}/{n} bytes read) "
                "— the peer died or reset")
        got += k


def _recv_first_byte(sock: socket.socket, idle_timeout_s: float):
    """The idle wait for a frame's FIRST byte: ``None`` on clean EOF
    (the peer closed between frames — a legal channel end), the byte
    on arrival, ``ProtocolError`` when the idle budget expires.

    Waits in bounded windows and NEVER arms blocking mode
    (``settimeout(None)``): a channel socket is shared with a writer
    thread via a ``dup()``'d object, and flipping the underlying fd to
    blocking would change the writer's send semantics mid-frame."""
    deadline = (None if math.isinf(idle_timeout_s)
                else mono_now_s() + idle_timeout_s)
    while True:
        if deadline is None:
            window = 60.0
        else:
            window = deadline - mono_now_s()
            if window <= 0:
                raise _IdleWindow(
                    f"connection idle for {idle_timeout_s:.0f}s — "
                    "closing (the peer pool redials on demand)")
        sock.settimeout(min(60.0, max(0.001, window)))
        try:
            b = sock.recv(1)
        except socket.timeout:
            continue
        return b if b else None


def recv_msg(sock: socket.socket, deadline_s: float = RECV_DEADLINE_S,
             *, idle_timeout_s: float | None = None,
             scratch: bytearray | None = None):
    """Receive one frame; returns ``(obj, arrays)``.

    Strict mode (``idle_timeout_s=None``, the one-shot contract): the
    whole frame — length prefix included — must arrive within
    ``deadline_s``.  Channel mode (``idle_timeout_s`` set): the FIRST
    byte may take up to ``idle_timeout_s`` (``inf`` = wait forever,
    the client reader's mode — the pool owns its lifecycle) and a
    clean EOF at a frame boundary returns ``None``; once the first
    byte lands, the REST of the frame must arrive within
    ``deadline_s`` — idle is healthy, trickling is not.

    ``scratch`` is an optional reusable receive buffer (grown in
    place, never shrunk): a channel reader passes its own so a steady
    request stream allocates no per-frame payload buffers.

    Every declared array is rebuilt from the binary tail; a spec whose
    byte counts do not reconcile with the frame is a protocol error,
    not a best-effort parse — half a panel must never score.  The
    length prefix is judged against ``MAX_FRAME_BYTES`` BEFORE any
    payload allocation: a corrupt or hostile prefix costs a pointed
    refusal, never the allocation it names.
    """
    # _recv_into_exact re-arms the socket timeout downward per read;
    # restore the caller's timeout afterwards so a later send/receive
    # on the same connection doesn't inherit a near-zero residual
    caller_timeout = sock.gettimeout()
    prefix = bytearray(_LEN.size)
    try:
        if idle_timeout_s is None:
            give_up = mono_now_s() + deadline_s
            _recv_into_exact(sock, memoryview(prefix), give_up)
        else:
            first = _recv_first_byte(sock, idle_timeout_s)
            if first is None:
                return None
            give_up = mono_now_s() + deadline_s
            prefix[0] = first[0]
            _recv_into_exact(sock, memoryview(prefix)[1:], give_up)
        (total,) = _LEN.unpack(prefix)
        if total > MAX_FRAME_BYTES:
            raise ProtocolError(
                f"declared frame length {total} exceeds MAX_FRAME_BYTES "
                f"({MAX_FRAME_BYTES}) — corrupt length prefix?  Refusing "
                "before allocating it")
        if scratch is None:
            scratch = bytearray(total)
        elif len(scratch) < total:
            scratch.extend(bytes(total - len(scratch)))
        payload = memoryview(scratch)[:total]
        _recv_into_exact(sock, payload, give_up)
    finally:
        try:
            sock.settimeout(caller_timeout)
        except OSError:
            pass  # the socket may already be closed/reset
    if total < _LEN.size:
        raise ProtocolError("frame shorter than its header length prefix")
    (hlen,) = _LEN.unpack(payload[:_LEN.size])
    if _LEN.size + hlen > total:
        raise ProtocolError(
            f"header length {hlen} overruns the {total}-byte frame")
    try:
        obj = json.loads(
            bytes(payload[_LEN.size:_LEN.size + hlen]).decode("utf-8"))
    except (UnicodeDecodeError, json.JSONDecodeError) as e:
        raise ProtocolError(f"unparseable frame header: {e}") from None
    if not isinstance(obj, dict):
        raise ProtocolError(
            f"frame header must be a JSON object, got {type(obj).__name__}")
    specs = obj.pop("_arrays", [])
    arrays: dict = {}
    off = _LEN.size + hlen
    for spec in specs:
        try:
            name = spec["name"]
            dtype = np.dtype(spec["dtype"])
            shape = tuple(int(s) for s in spec["shape"])
            nbytes = int(spec["nbytes"])
        except (KeyError, TypeError, ValueError) as e:
            raise ProtocolError(f"bad array spec {spec!r}: {e}") from None
        want = dtype.itemsize * int(np.prod(shape)) if shape else dtype.itemsize
        if nbytes != want or off + nbytes > total:
            raise ProtocolError(
                f"array {name!r} spec inconsistent with frame "
                f"(declared {nbytes} bytes, shape wants {want}, "
                f"{total - off} remain)")
        # .copy() because the scratch buffer is reused for the next
        # frame — the array must own its bytes past this call
        arrays[name] = np.frombuffer(
            payload[off:off + nbytes], dtype=dtype).reshape(shape).copy()
        off += nbytes
    if off != total:
        raise ProtocolError(
            f"{total - off} trailing bytes after the declared arrays")
    return obj, arrays


# --------------------------------------------------------------- one-shot ---

def request_once(address: str, obj: dict, arrays: dict | None = None,
                 timeout_s: float = 5.0) -> tuple:
    """One-shot round trip: connect, send, receive one reply, close.

    The one-shot transport, for PROBES and one-shot admin/lifecycle
    ops (ping / ready / stats / drain / stop), where a fresh connection
    per call is the point — a probe must measure the peer's ability to
    accept, and an admin op must not ride a channel the request path
    might sever.  Request hot paths use :class:`ChannelPool`.

    ``timeout_s`` bounds the connect AND the whole reply receive (the
    receive-deadline contract), so one call can never outwait its
    budget no matter how the peer misbehaves.  ``score`` ops visit the
    ``serve.transport`` chaos checkpoint before dialing.
    """
    if obj.get("op") == "score":
        _chaos_transport(address, "score")
    sock = connect(address, timeout_s)
    try:
        send_msg(sock, obj, arrays)
        return recv_msg(sock, deadline_s=timeout_s)
    finally:
        try:
            sock.close()
        except OSError:
            pass


# the reference's older name for the same call
request = request_once


# ----------------------------------------------------------- the channel ---

class _IdleWindow(ProtocolError):
    """An idle window elapsed with no frame started (leader's read
    slice) — not an error, re-check budgets and wait again.  Subclasses
    ProtocolError so the SERVER loop's existing catch treats an idle
    expiry there as the connection close it already was."""


class _Waiter:
    """One in-flight request's parking spot on a channel.

    ``obj``/``error`` are the truth; ``event`` is only a wakeup hint
    (a leader exiting pokes one waiter's event WITHOUT a reply so it
    takes over reading) — every consumer re-checks obj/error after any
    wake, so hint races are benign by construction."""

    __slots__ = ("event", "obj", "arrays", "error")

    def __init__(self):
        self.event = threading.Event()
        self.obj = None
        self.arrays = None
        self.error: BaseException | None = None

    @property
    def done(self) -> bool:
        return self.obj is not None or self.error is not None


class Channel:
    """One persistent, multiplexed connection to a peer.

    Many requests interleave: each send is tagged with a ``_mux`` id
    under the writer lock, and replies route to the waiter registered
    under the echoed id.  A reply with no tag settles the oldest
    pending request (a legacy in-order peer).  Any transport error —
    reset, EOF, a mid-frame receive deadline — kills the channel and
    fails EVERY in-flight request with the reason, so a partition
    mid-stream reason-closes the stream, never wedges it.

    **Leader/follower demux — no reader thread.**  The first dispatcher
    to grab the read baton (``_rlock``) reads frames, delivering each
    reply to its waiter, until its OWN reply lands; then it returns and
    pokes a pending follower to take over.  A solo request's reply
    therefore wakes the requesting thread STRAIGHT from the kernel —
    one scheduler hop, exactly like the old socket-per-request design —
    and a dedicated reader thread's extra wake-parse-wake hop (which
    under a CPU-saturated burst quantized every reply to scheduler
    latency) never exists.  An idle channel parks no thread at all.
    """

    __slots__ = ("address", "alive", "close_reason", "last_used_s",
                 "created_s", "frame_deadline_s", "_sock", "_wsock",
                 "_wlock", "_plock", "_rlock", "_scratch", "_pending",
                 "_mux_ids", "orphan_replies", "_timeout_orphaned")

    # how long one frame WRITE may take before the channel is judged
    # wedged (a full kernel buffer against a stalled peer)
    SEND_TIMEOUT_S = RECV_DEADLINE_S

    # a leader's read slice: long enough to stay parked in the kernel
    # for the common case, short enough to re-check its own deadline
    LEAD_IDLE_SLICE_S = 0.25
    # a follower's safety-net poll (pokes normally wake it sooner)
    FOLLOW_WAIT_S = 0.25

    def __init__(self, address: str, sock: socket.socket,
                 frame_deadline_s: float = RECV_DEADLINE_S):
        self.address = address
        self.frame_deadline_s = frame_deadline_s
        self._sock = sock
        # the writer gets its OWN socket object over a dup'd fd with a
        # FIXED timeout: the read side re-arms the original's timeout
        # per read (idle windows, frame deadlines), and Python socket
        # timeouts are per-object — sharing one object between threads
        # would race the writer's send budget.  Neither object ever
        # arms blocking mode, so the shared fd's mode never flips
        # under a concurrent operation.
        self._wsock = sock.dup()
        self._wsock.settimeout(self.SEND_TIMEOUT_S)
        self.alive = True
        self.close_reason: str | None = None
        self.last_used_s = mono_now_s()
        self.created_s = self.last_used_s
        self._wlock = threading.Lock()     # serializes frames OUT
        self._plock = threading.Lock()     # guards the pending registry
        self._rlock = threading.Lock()     # the read baton (the leader)
        self._scratch = bytearray()        # leader-only receive buffer
        # mux id -> _Waiter; dict insertion order doubles as the
        # oldest-pending order for legacy untagged replies (entries are
        # popped on completion, so nothing accumulates per request)
        self._pending: dict = {}
        self._mux_ids = itertools.count(1)
        self.orphan_replies = 0            # replies whose waiter gave up
        self._timeout_orphaned = False     # a waiter once gave up: an
        #                                    untagged reply could be its

    @property
    def in_flight(self) -> int:
        # lock-free read on purpose: a load-balancing/reap HEURISTIC,
        # not an invariant — taking _plock here would hand the pool's
        # registry lock a global ordering constraint for a count that
        # may be stale by the time the caller acts on it anyway
        return len(self._pending)

    def request(self, obj, arrays: dict | None, timeout_s: float,
                marks: dict | None = None) -> tuple:
        """One multiplexed round trip on this channel.  ``obj`` is a
        header dict or :meth:`HeaderTemplate.render` bytes.  ``marks``
        (optional dict) receives ``t_sent_s`` — the monotonic instant
        the frame finished sending — for the trace's transport split."""
        mux = next(self._mux_ids)
        w = _Waiter()
        with self._plock:
            if not self.alive:
                raise ConnectionResetError(
                    f"channel to {self.address} is closed "
                    f"({self.close_reason})")
            self._pending[mux] = w
        try:
            try:
                buffers, _ = _encode_frame(_header_core(obj), arrays,
                                           mux)
            except ProtocolError as e:
                # the REQUEST is malformed, not the channel: surface
                # the pointed diagnostic, never the redial path
                raise FrameEncodeError(str(e)) from None
            try:
                # the writer lock EXISTS to serialize frame writes on
                # one socket; it guards nothing else, is a leaf, and
                # the send is bounded by wsock's fixed SEND_TIMEOUT_S
                with self._wlock:
                    _send_buffers(self._wsock, buffers)
            except OSError as e:
                self._die(f"send failed: {type(e).__name__}: {e}")
                raise
            self.last_used_s = mono_now_s()
            if marks is not None:
                marks["t_sent_s"] = self.last_used_s
            out = self._await_reply(w, mono_now_s() + timeout_s,
                                    timeout_s)
            self.last_used_s = mono_now_s()
            return out
        finally:
            with self._plock:
                self._pending.pop(mux, None)

    # ---------------------------------------------------- leader/follower --

    def _await_reply(self, w: _Waiter, give_up_s: float,
                     timeout_s: float) -> tuple:
        """Wait for ``w``'s reply, leading the channel's reads whenever
        no one else is: the leader parses every arriving frame and
        delivers it to its waiter (possibly itself); followers sleep on
        their own events and inherit the baton by poke when the leader
        returns."""
        while True:
            if w.error is not None:
                raise w.error
            if w.obj is not None:
                return w.obj, w.arrays
            remaining = give_up_s - mono_now_s()
            if remaining <= 0:
                self._timeout_orphaned = True
                raise ReplyTimeout(
                    f"no reply from {self.address} within "
                    f"{timeout_s:.1f}s (channel healthy; the late reply "
                    "will be dropped by the demux)")
            if self._rlock.acquire(blocking=False):
                try:
                    self._lead(w, give_up_s)
                finally:
                    self._rlock.release()
                    self._poke_follower()
            else:
                # follower: the leader delivers our reply (event set
                # with obj) or pokes us to take over (event set, no
                # obj) — the loop top re-checks truth either way
                w.event.wait(min(remaining, self.FOLLOW_WAIT_S))
                w.event.clear()

    def _lead(self, w: _Waiter, give_up_s: float) -> None:
        """Read frames until OUR reply lands, our budget runs out, or
        the channel dies (death reason-closes every waiter)."""
        while not w.done:
            remaining = give_up_s - mono_now_s()
            if remaining <= 0:
                return
            try:
                msg = recv_msg(
                    self._sock, self.frame_deadline_s,
                    idle_timeout_s=min(remaining,
                                       self.LEAD_IDLE_SLICE_S),
                    scratch=self._scratch)
            except _IdleWindow:
                continue  # no frame started; re-check our budget
            except (OSError, ProtocolError, ValueError) as e:
                self._die(f"{type(e).__name__}: {e}")
                return
            if msg is None:
                self._die("peer closed the channel")
                return
            self._deliver(*msg)

    def _deliver(self, obj: dict, arrays: dict) -> None:
        mux = obj.pop("_mux", None)
        with self._plock:
            if mux is None:
                if len(self._pending) > 1 or self._timeout_orphaned:
                    # an untagged reply can only be attributed when ONE
                    # request is in flight: registration order is not
                    # send order (the writer lock decides that), so
                    # guessing could hand thread A thread B's scores.
                    # A legacy peer must not be multiplexed — and
                    # after ANY timeout the lone pending waiter may not
                    # be this reply's requester either.  Kill the
                    # channel; the reason-closed requests fail over.
                    die = True
                else:
                    mux = next(iter(self._pending), None)
                    die = False
            else:
                die = False
            wt = self._pending.get(mux)
        if die:
            self._die("untagged reply that cannot be attributed (multiple "
                      "requests in flight, or a prior timeout orphaned "
                      "one) — a legacy in-order peer cannot be "
                      "multiplexed")
            return
        if wt is None:
            # the waiter timed out and moved on: drop the late reply
            # (counted — a rising number means the reply budget is
            # tighter than the peer's service time)
            self.orphan_replies += 1
            return
        wt.obj, wt.arrays = obj, arrays
        wt.event.set()

    def _poke_follower(self) -> None:
        """Wake one undelivered waiter so leadership never strands: the
        poked waiter re-checks its truth, finds no reply, and takes the
        baton (its FOLLOW_WAIT_S poll is only the safety net)."""
        with self._plock:
            for wt in self._pending.values():
                if not wt.done:
                    wt.event.set()
                    return

    def _die(self, reason: str) -> None:
        """Mark dead and reason-close every in-flight request (the
        exactly-once guard: only the first reason sticks)."""
        with self._plock:
            if not self.alive:
                return
            self.alive = False
            self.close_reason = str(reason)[:200]
            waiters = list(self._pending.values())
            self._pending.clear()
        for s in (self._sock, self._wsock):
            try:
                s.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
            try:
                s.close()
            except OSError:
                pass
        for w in waiters:
            w.error = ConnectionResetError(
                f"channel to {self.address} died mid-request: "
                f"{self.close_reason}")
            w.event.set()

    def close(self, reason: str = "closed by pool") -> None:
        self._die(reason)


class ChannelPool:
    """Per-peer bounded channel registry: dial on demand, reuse across
    requests, reap idle, back off on a refusing peer.

    The hot-path transport: one pool per dispatch tier (router →
    workers); probes and admin ops stay on :func:`request_once`.
    """

    def __init__(self, max_per_peer: int = 8, idle_reap_s: float = 60.0,
                 connect_timeout_s: float = 2.0,
                 backoff_base_s: float = 0.05,
                 backoff_cap_s: float = 1.0,
                 frame_deadline_s: float = RECV_DEADLINE_S,
                 pipeline_depth: int = 8):
        self.max_per_peer = max(1, int(max_per_peer))
        self.idle_reap_s = idle_reap_s
        self.connect_timeout_s = connect_timeout_s
        self.frame_deadline_s = frame_deadline_s
        # how many in-flight requests one channel carries before the
        # pool prefers dialing another (up to max_per_peer).  One
        # channel is one read baton here and one serve-loop thread at
        # the peer — under a burst, spreading frames across a few
        # parallel loops is what keeps a GIL-bound tier's frame
        # parsing off the critical path; past the bound, requests
        # share the least-loaded channel anyway (mux absorbs it).
        self.pipeline_depth = max(1, int(pipeline_depth))
        self.backoff_base_s = backoff_base_s
        self.backoff_cap_s = backoff_cap_s
        self._mu = threading.Lock()        # registry only; never held
        #                                    across a dial or a request
        self._channels: dict = {}          # address -> [Channel, ...]
        self._dialing: dict = {}           # address -> in-flight dial count
        self._backoff: dict = {}           # address -> (fails, retry_at_s)
        self._rr = itertools.count()
        # counters (exposed via stats(); the fabric artifact's evidence
        # that the transport actually reused connections)
        self.dials = 0
        self.dial_failures = 0
        self.reuses = 0
        self.stale_retries = 0
        self.severed = 0
        self.reaped_idle = 0

    # ------------------------------------------------------------ acquire --

    def _acquire(self, address: str,
                 newer_than_s: float | None = None) -> tuple:
        """``(channel, fresh)`` — a healthy channel to ``address``,
        dialing one when the peer has capacity.  Raises the dial error
        (or a fast-fail during reconnect backoff).

        ``newer_than_s`` is the stale-retry floor: only channels
        CREATED after that instant count as reusable (the caller just
        watched an older one die), so concurrent retries against a
        restarted peer share one sibling dial under the per-peer bound
        instead of each bursting its own connect."""
        dial_give_up = mono_now_s() + self.connect_timeout_s
        while True:
            now = mono_now_s()
            to_reap: list = []
            reuse = None
            backoff_err = None
            dial = False
            with self._mu:
                chans = self._channels.setdefault(address, [])
                # lazy idle reap + dead-channel pruning (no reaper
                # thread: the next acquire is the natural maintenance
                # point).  The closes themselves run AFTER the registry
                # lock releases — the pool lock must not order against
                # channel internals.
                kept = []
                for ch in chans:
                    if not ch.alive:
                        continue
                    if (ch.in_flight == 0
                            and now - ch.last_used_s > self.idle_reap_s):
                        to_reap.append(ch)
                        self.reaped_idle += 1
                        continue
                    kept.append(ch)
                chans[:] = kept
                usable = (kept if newer_than_s is None
                          else [c for c in kept
                                if c.created_s > newer_than_s])
                best = (min(usable, key=lambda c: c.in_flight)
                        if usable else None)
                capacity = (len(kept) + self._dialing.get(address, 0)
                            < self.max_per_peer)
                if (best is not None
                        and (best.in_flight < self.pipeline_depth
                             or not capacity)):
                    # a channel with pipeline headroom — or the peer
                    # is at its channel bound: mux onto the least
                    # loaded.  Saturated channels with capacity left
                    # fall through to dial: one channel is one serve
                    # loop at the peer, and a burst needs a few of
                    # them in parallel.
                    self.reuses += 1
                    reuse = best
                    reuse.last_used_s = now
                else:
                    fails, retry_at = self._backoff.get(address, (0, 0.0))
                    if fails and now < retry_at:
                        if best is not None:
                            # a refusing peer with live channels: keep
                            # using them, just don't dial into backoff
                            self.reuses += 1
                            reuse = best
                            reuse.last_used_s = now
                        else:
                            backoff_err = ConnectionRefusedError(
                                f"peer {address} in reconnect backoff "
                                f"after {fails} dial failure(s) "
                                f"(retries in {retry_at - now:.2f}s)")
                    elif capacity:
                        # reserve a dial slot under the lock; the
                        # connect itself runs OUTSIDE it (a slow dial
                        # must not serialize other peers' acquires)
                        self._dialing[address] = \
                            self._dialing.get(address, 0) + 1
                        dial = True
                    elif best is not None:
                        # at capacity with dials in flight: share the
                        # least loaded live channel, don't overshoot
                        self.reuses += 1
                        reuse = best
                        reuse.last_used_s = now
                    # else: no usable channel and the dial budget is
                    # all in flight — wait for a sibling's dial below
            for r in to_reap:
                r.close("idle-reaped")
            if backoff_err is not None:
                raise backoff_err
            if reuse is not None:
                return reuse, False
            if dial:
                break
            if mono_now_s() >= dial_give_up:
                raise ConnectionRefusedError(
                    f"timed out waiting for an in-flight dial to "
                    f"{address} ({self.connect_timeout_s:.1f}s)")
            time.sleep(0.005)
        try:
            sock = connect(address, self.connect_timeout_s)
        except OSError:
            with self._mu:
                self._dialing[address] -= 1
                fails = self._backoff.get(address, (0, 0.0))[0] + 1
                delay = min(self.backoff_cap_s,
                            self.backoff_base_s * (2 ** (fails - 1)))
                self._backoff[address] = (fails, mono_now_s() + delay)
                self.dial_failures += 1
            raise
        ch = Channel(address, sock,
                     frame_deadline_s=self.frame_deadline_s)
        with self._mu:
            self._dialing[address] -= 1
            self._backoff.pop(address, None)
            self._channels.setdefault(address, []).append(ch)
            self.dials += 1
        return ch, True

    # ------------------------------------------------------------ request --

    def request(self, address: str, obj, arrays: dict | None = None,
                timeout_s: float = 5.0, marks: dict | None = None,
                fire_chaos: bool = True) -> tuple:
        """One request over a pooled channel; the hot-path replacement
        for :func:`request_once`.

        ``marks`` (optional dict) receives ``t_acquired_s`` (channel in
        hand — a dial or a pool hit) and ``t_sent_s`` (frame fully
        written) so the caller's trace can split ``transport`` into
        connect / send / recv_wait.  A failure on a REUSED channel
        before any reply is retried once on a channel dialed AFTER the
        failure (a pooled channel whose peer restarted between requests
        is a redial, not a failover) — within the SAME ``timeout_s``
        budget, so one call never outwaits the attempt bound its caller
        derived deadlines from.  ``fire_chaos`` visits the
        ``serve.transport`` checkpoint (the score-dispatch contract);
        a ``partition`` fault severs every live channel to the peer —
        in-flight requests included — until it heals.
        """
        if fire_chaos:
            _chaos_transport(address, "score", on_partition=self._sever)
        give_up = mono_now_s() + timeout_s
        ch, fresh = self._acquire(address)
        if marks is not None:
            marks["t_acquired_s"] = mono_now_s()
        try:
            return ch.request(obj, arrays, timeout_s, marks=marks)
        except (ReplyTimeout, FrameEncodeError):
            # the channel is healthy: the attempt expired, or the
            # request itself could not be framed — neither is a
            # transport failure a redial could fix
            raise
        except (OSError, ProtocolError):
            if fresh:
                raise
            if fire_chaos and _partitioned_until(address) is not None:
                # the channel died because a partition severed it: a
                # transparent redial would reconnect straight across
                # the armed partition — the contract says every dial
                # fails until it heals
                raise ConnectionRefusedError(_partition_reason(address))
            # the reuse gamble lost (peer restarted / idle-closed the
            # far end): one transparent retry on a channel newer than
            # the failure — concurrent retries share ONE sibling dial
            # under the per-peer bound instead of bursting N connects
            # at a peer that just restarted.  Scoring is pure, so
            # re-sending after a torn send is safe.
            t_fail = mono_now_s()
            with self._mu:
                self.stale_retries += 1
            ch2, _ = self._acquire(address, newer_than_s=t_fail)
            if marks is not None:
                marks["t_acquired_s"] = mono_now_s()
            return ch2.request(obj, arrays,
                               max(0.05, give_up - mono_now_s()),
                               marks=marks)

    # ----------------------------------------------------------- severing --

    def _sever(self, address: str, reason: str) -> None:
        """Close every live channel to ``address`` (reason-closing all
        in-flight requests on them) — the partition-mid-stream hook."""
        with self._mu:
            chans = self._channels.pop(address, [])
        for ch in chans:
            if ch.alive:
                with self._mu:
                    self.severed += 1
            ch.close(reason)

    def close(self) -> None:
        """Close every channel (teardown hygiene)."""
        with self._mu:
            all_chans = [ch for chans in self._channels.values()
                         for ch in chans]
            self._channels.clear()
        for ch in all_chans:
            ch.close("pool closed")

    def stats(self) -> dict:
        with self._mu:
            live = sum(1 for chans in self._channels.values()
                       for ch in chans if ch.alive)
            orphans = sum(ch.orphan_replies
                          for chans in self._channels.values()
                          for ch in chans)
            return {
                "live_channels": live,
                "dials": self.dials,
                "dial_failures": self.dial_failures,
                "reuses": self.reuses,
                "stale_retries": self.stale_retries,
                "severed": self.severed,
                "reaped_idle": self.reaped_idle,
                "orphan_replies": orphans,
            }


# ------------------------------------------------------------ server loop ---

def serve_connection(conn: socket.socket, handler, on_stop=None,
                     idle_timeout_s: float = SERVE_IDLE_S) -> None:
    """Serve one ACCEPTED connection until EOF / idle expiry / error:
    framed requests in, framed replies out, many in flight.

    ``handler(obj, arrays) -> (reply_obj, reply_arrays | None)`` runs
    per frame — ``score`` work on its own thread so a slow dispatch
    never head-of-line-blocks the channel's other requests (the
    worker-side half of the multiplexing contract); lifecycle ops
    inline (they are cheap and their ordering vs the frames around
    them is part of the drain semantics).  Replies echo the request's
    ``_mux`` id under one writer lock.  ``on_stop()`` fires after a
    ``stop`` op's reply is written.  A one-shot peer (no ``_mux``,
    closes after its reply) exits the loop via clean EOF.
    """
    tune_stream_socket(conn)
    # a finite timeout BEFORE anything else: recv_msg restores the
    # socket's prior timeout after every frame, and restoring None
    # would flip the open file description (shared with the dup'd
    # write socket below) into blocking mode — a reply to a stalled
    # peer could then block past SEND_TIMEOUT_S while holding the
    # writer lock
    conn.settimeout(RECV_DEADLINE_S)
    wlock = threading.Lock()
    # same split as Channel: reply threads write through their own
    # dup'd socket object with a fixed timeout while the serve loop
    # re-arms the original's timeout per read — per-object timeouts
    # must not race across threads
    wconn = conn.dup()
    wconn.settimeout(Channel.SEND_TIMEOUT_S)

    def _reply(mux, reply, reply_arrays):
        core = _header_core(reply)
        buffers, _ = _encode_frame(core, reply_arrays, mux)
        # the reply lock EXISTS to serialize frame writes on this one
        # socket; a leaf guarding nothing else, send bounded by wconn's
        # fixed timeout
        with wlock:
            _send_buffers(wconn, buffers)

    def _run_one(obj, arrays, mux):
        op = obj.get("op")
        try:
            reply, reply_arrays = handler(obj, arrays)
        except Exception as e:  # a handler bug must not kill the channel
            reply, reply_arrays = {
                "state": "rejected",
                "error": f"handler error: {type(e).__name__}: {e}"[:200],
            }, None
        try:
            _reply(mux, reply, reply_arrays)
        except OSError:
            return  # peer gone; nothing to tell it
        if op == "stop" and on_stop is not None:
            on_stop()

    scratch = bytearray()
    try:
        while True:
            msg = recv_msg(conn, idle_timeout_s=idle_timeout_s,
                           scratch=scratch)
            if msg is None:
                return  # clean EOF between frames
            obj, arrays = msg
            mux = obj.pop("_mux", None)
            if obj.get("op") == "score":
                threading.Thread(target=_run_one, args=(obj, arrays, mux),
                                 daemon=True).start()
            else:
                _run_one(obj, arrays, mux)
    except (OSError, ProtocolError):
        pass  # the peer vanished, stalled, or spoke garbage: drop it
    finally:
        for s in (conn, wconn):
            try:
                s.close()
            except OSError:
                pass
