"""Length-prefixed socket RPC for out-of-process clients (counterpart
of ``slate_tpu/serve/rpc.py``).

A minimal loopback / cluster-internal wire, not a public protocol:

  request  := u32be header_len | header JSON | payload bytes
  response := u32be header_len | header JSON | payload bytes

The submit header carries ``{cmd, op, tenant, timeout_s, dtype, shape,
[rhs_dtype, rhs_shape]}`` and the payload is the C-order array bytes
(A then B). For f32 / f64 (every dtype numpy has) the frames are byte
for byte the reference's: ``dtype`` is numpy's ``dtype.str`` ("<f4").
bf16, which numpy lacks, travels as ``"bfloat16"`` with its bytes sent
through an int16 view (the reference's ``dtype.str`` would give "<V2").
The server receives each payload with ``recv_into`` into one buffer and
hands a tensor over that buffer (``torch.frombuffer``) straight to
:meth:`Server.submit`: no copy from socket buffer to the coalescing
queue's staging pad. Responses mirror the scheme: ``{status: "ok",
decision, cache, parts: [{dtype, shape}...]}`` followed by the result
bytes, or ``{status: "rejected"|"error", error, decision}`` with no
payload. Results come back as CPU tensors.

``{cmd: "stats"}`` returns the merged :meth:`Server.stats` dict (tuple
keys of the queue's per-key breakdown stringified for JSON);
``{cmd: "metrics"}`` returns obs/series.py's Prometheus text exposition
(``{"text": ...}``; empty with serve/metrics off).

Trace propagation (obs/reqtrace.py): with tracing ON the client mints a
``serve::rpc`` span and adds ``{"trace", "span"}`` to the submit
header; the server continues that trace through
``Server.submit(trace_parent=)`` and echoes the trace id in the ok
response. With the FROZEN obs/reqtrace row off NEITHER side adds a
field.

One daemon thread accepts; one thread per connection serves sequential
requests (clients pipeline by opening more connections: coalescing
across connections is what the queue is for).
"""

from __future__ import annotations

import json
import socket
import struct
import threading
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from ..obs import reqtrace as _rt
from .server import Server, ServeRejected, _ingest

_HDR = struct.Struct(">I")
#: refuse absurd frames rather than allocate attacker-sized buffers
MAX_HEADER_BYTES = 1 << 20


#: the wire's name of bf16, which numpy lacks
BF16 = "bfloat16"


def _wire_dtype(dtype: torch.dtype) -> str:
    """The header's dtype string: numpy's ``dtype.str``, or BF16."""
    if dtype == torch.bfloat16:
        return BF16
    return torch.empty(0, dtype=dtype).numpy().dtype.str


def _torch_dtype(name: str) -> torch.dtype:
    if name == BF16:
        return torch.bfloat16
    return torch.from_numpy(np.empty(0, np.dtype(name))).dtype


def _tensor(x) -> torch.Tensor:
    """A contiguous CPU tensor of `x` (numpy array or tensor)."""
    return _ingest(x).detach().cpu().contiguous()


def _send_frame(sock: socket.socket, header: Dict[str, Any],
                payloads: Tuple[torch.Tensor, ...] = ()) -> None:
    hb = json.dumps(header, separators=(",", ":")).encode()
    sock.sendall(_HDR.pack(len(hb)) + hb)
    for p in payloads:
        p = _tensor(p)
        if p.dtype == torch.bfloat16:
            p = p.view(torch.int16)
        sock.sendall(p.numpy().data)


def _recv_exact(sock: socket.socket, n: int) -> Optional[memoryview]:
    buf = bytearray(n)
    view = memoryview(buf)
    got = 0
    while got < n:
        r = sock.recv_into(view[got:], n - got)
        if r == 0:
            return None
        got += r
    return memoryview(buf)


def _recv_frame(sock: socket.socket
                ) -> Optional[Tuple[Dict[str, Any], socket.socket]]:
    raw = _recv_exact(sock, _HDR.size)
    if raw is None:
        return None
    (hlen,) = _HDR.unpack(raw)
    if hlen > MAX_HEADER_BYTES:
        raise ValueError("rpc header of %d bytes refused" % hlen)
    hb = _recv_exact(sock, hlen)
    if hb is None:
        return None
    return json.loads(bytes(hb)), sock


def _recv_array(sock: socket.socket, dtype: str,
                shape: List[int]) -> Optional[torch.Tensor]:
    dt = _torch_dtype(dtype)
    n = int(np.prod(shape)) if shape else 1
    raw = _recv_exact(sock, n * torch.empty(0, dtype=dt).element_size())
    if raw is None:
        return None
    if n == 0:
        return torch.empty(shape, dtype=dt)
    # frombuffer: the recv buffer IS the tensor (no copy)
    return torch.frombuffer(raw, dtype=dt).reshape(shape)


class RpcServer:
    """Socket front-end over one :class:`Server`. Binds immediately
    (port 0 = ephemeral; read ``.address``)."""

    def __init__(self, server: Server, host: str = "127.0.0.1",
                 port: int = 0) -> None:
        self._server = server
        self._sock = socket.socket(socket.AF_INET,
                                   socket.SOCK_STREAM)
        self._sock.setsockopt(socket.SOL_SOCKET,
                              socket.SO_REUSEADDR, 1)
        self._sock.bind((host, port))
        self._sock.listen(16)
        self.address: Tuple[str, int] = self._sock.getsockname()
        self._closed = False
        self._accept_thread = threading.Thread(
            target=self._accept_loop, name="serve-rpc-accept",
            daemon=True)
        self._accept_thread.start()

    def _accept_loop(self) -> None:
        while not self._closed:
            try:
                conn, _addr = self._sock.accept()
            except OSError:
                return                      # socket closed
            threading.Thread(target=self._serve_conn, args=(conn,),
                             name="serve-rpc-conn",
                             daemon=True).start()

    def _serve_conn(self, conn: socket.socket) -> None:
        try:
            with conn:
                conn.setsockopt(socket.IPPROTO_TCP,
                                socket.TCP_NODELAY, 1)
                while True:
                    frame = _recv_frame(conn)
                    if frame is None:
                        return
                    self._handle(frame[0], conn)
        except OSError:
            return

    def _handle(self, hdr: Dict[str, Any],
                conn: socket.socket) -> None:
        cmd = hdr.get("cmd")
        if cmd == "stats":
            _send_frame(conn, {"status": "ok",
                               "stats": _jsonable(
                                   self._server.stats())})
            return
        if cmd == "metrics":
            _send_frame(conn, {"status": "ok",
                               "text":
                               self._server.metrics_text()})
            return
        if cmd != "submit":
            _send_frame(conn, {"status": "error",
                               "error": "unknown cmd %r" % (cmd,)})
            return
        a = _recv_array(conn, hdr["dtype"], hdr["shape"])
        b = None
        if hdr.get("rhs_shape") is not None:
            b = _recv_array(conn, hdr.get("rhs_dtype", hdr["dtype"]),
                            hdr["rhs_shape"])
        if a is None or (hdr.get("rhs_shape") is not None
                         and b is None):
            return                          # peer hung up mid-frame
        # the client's trace context, when it sent one (reqtrace on):
        # Server.submit continues the trace across the wire
        parent = {"trace": hdr["trace"],
                  "span": hdr.get("span")} if "trace" in hdr else None
        try:
            t = self._server.submit(hdr["op"], a, b,
                                    tenant=hdr.get("tenant",
                                                   "default"),
                                    trace_parent=parent)
            out = t.result(timeout=hdr.get("timeout_s", 120.0))
        except ServeRejected as e:
            _send_frame(conn, {"status": "rejected",
                               "decision": e.decision,
                               "error": str(e)})
            return
        except Exception as e:
            _send_frame(conn, {"status": "error",
                               "error": "%s: %s"
                               % (type(e).__name__, e)})
            return
        parts = tuple(_tensor(p) for p in
                      (out if isinstance(out, tuple) else (out,)))
        rh = {"status": "ok",
              "decision": t.decision, "cache": t.cache,
              "parts": [{"dtype": _wire_dtype(p.dtype),
                         "shape": list(p.shape)}
                        for p in parts]}
        if t.span is not None:      # echo only when traced: the off
            rh["trace"] = t.span.trace_id   # wire stays identical
        _send_frame(conn, rh, parts)

    def close(self) -> None:
        self._closed = True
        try:
            self._sock.close()
        except OSError:
            pass

    def __enter__(self) -> "RpcServer":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


class RpcClient:
    """Blocking client for one connection (open more for pipelining —
    the daemon's queue coalesces across connections)."""

    def __init__(self, address: Tuple[str, int]) -> None:
        self._sock = socket.create_connection(address)
        self._sock.setsockopt(socket.IPPROTO_TCP,
                              socket.TCP_NODELAY, 1)
        self._lock = threading.Lock()
        #: trace id of the most recent submit's response (tracing on
        #: both sides), else None — lets a caller join its local
        #: records to the daemon's without reparsing headers
        self.last_trace: Optional[str] = None

    def submit(self, op: str, a, b=None, tenant: str = "default",
               timeout_s: float = 120.0):
        """Round-trip one request (numpy arrays or tensors). Returns
        the result tensor (or tuple of them); raises
        :class:`ServeRejected` on shed/reject and RuntimeError on
        server-side errors. With tracing on, mints the client
        ``serve::rpc`` span and carries its ids in the header: the
        daemon's spans share this trace_id."""
        a = _tensor(a)
        hdr: Dict[str, Any] = {
            "cmd": "submit", "op": op, "tenant": tenant,
            "timeout_s": timeout_s,
            "dtype": _wire_dtype(a.dtype), "shape": list(a.shape)}
        sp = _rt.begin(_rt.CLIENT_SPAN, tenant=tenant, op=op)
        if sp is not None:
            hdr["trace"] = sp.trace_id
            hdr["span"] = sp.span_id
        payloads: List[torch.Tensor] = [a]
        if b is not None:
            b = _tensor(b)
            hdr["rhs_dtype"] = _wire_dtype(b.dtype)
            hdr["rhs_shape"] = list(b.shape)
            payloads.append(b)
        try:
            with self._lock:
                _send_frame(self._sock, hdr, tuple(payloads))
                resp = _recv_frame(self._sock)
                if resp is None:
                    raise RuntimeError("rpc server hung up")
                rh = resp[0]
                if rh["status"] == "rejected":
                    raise ServeRejected(
                        rh.get("decision", "reject"),
                        tenant, op, rh.get("error", ""))
                if rh["status"] != "ok":
                    raise RuntimeError("rpc error: %s"
                                       % rh.get("error"))
                parts = []
                for spec in rh["parts"]:
                    p = _recv_array(self._sock, spec["dtype"],
                                    spec["shape"])
                    if p is None:
                        raise RuntimeError("rpc server hung up "
                                           "mid-payload")
                    parts.append(p)
            self.last_trace = rh.get("trace")
            if sp is not None:
                sp.finish(decision=rh.get("decision") or "",
                          cache=rh.get("cache") or "")
        except BaseException as e:
            if sp is not None:
                sp.finish(error=e)
            raise
        return parts[0] if len(parts) == 1 else tuple(parts)

    def stats(self) -> Dict[str, Any]:
        with self._lock:
            _send_frame(self._sock, {"cmd": "stats"})
            resp = _recv_frame(self._sock)
        if resp is None or resp[0].get("status") != "ok":
            raise RuntimeError("rpc stats failed")
        return resp[0]["stats"]

    def metrics(self) -> str:
        """The daemon's Prometheus text exposition (obs/series.py;
        empty string with serve/metrics off)."""
        with self._lock:
            _send_frame(self._sock, {"cmd": "metrics"})
            resp = _recv_frame(self._sock)
        if resp is None or resp[0].get("status") != "ok":
            raise RuntimeError("rpc metrics failed")
        return resp[0]["text"]

    def close(self) -> None:
        try:
            self._sock.close()
        except OSError:
            pass

    def __enter__(self) -> "RpcClient":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


def _jsonable(x):
    """Deep-convert a stats dict for JSON: tuple keys (the queue's
    per-key pending breakdown) become strings, numpy scalars become
    Python numbers."""
    if isinstance(x, dict):
        return {(k if isinstance(k, str) else repr(k)): _jsonable(v)
                for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [_jsonable(v) for v in x]
    if isinstance(x, np.generic):
        return x.item()
    return x
