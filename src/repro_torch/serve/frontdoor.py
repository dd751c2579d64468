"""Asyncio HTTP/SSE front door over the continuous-batching engine,
ported from `repro/serve/frontdoor.py` against the port's engine.

    POST /v1/generate          body: {"prompt": [ids], "max_tokens": N,
                                      "temperature": t, "top_k": k,
                                      "seed": s, "priority": p, "slo": "..."}
                               -> text/event-stream, one `data:` event per
                                  scheduler iteration that sampled tokens
                                  for this request, then `event: done`
    GET  /v1/stats             -> engine counters + prefix-cache stats

The server is a single asyncio task pool over `asyncio.start_server` — no
HTTP framework, because the serving container ships none and the protocol
surface here is tiny.  One PUMP task drives the engine's resumable step API:
it calls `engine.step()` whenever work exists and fans the returned
(rid, tokens) events out to per-request queues; connection handlers
`submit()` on POST and consume their queue into SSE frames.  Everything
runs on ONE event loop thread, so submit/cancel/step interleave at
iteration granularity and need no locking — the engine itself stays
single-threaded, exactly as `run()` drives it.  (A device tick
blocks the loop for its duration; the tick IS the unit of service, so
nothing finer-grained exists to schedule anyway.)

DISCONNECTS: each streaming handler watches its reader for EOF while it
waits for tokens.  A client that hangs up mid-stream — or whose SSE write
fails — gets `engine.cancel(rid)`: queued requests are dropped before they
touch a slot, in-flight ones are retired through the same scrub normal
retirement uses (h, c and pos zeroed), so the freed slot reads exactly
like a fresh one and the next occupant's prefill cannot see the dead
request's state.

Tokens stream as ids, not text: the repo has no tokenizer dependency and
the paper's PTB/wiki vocabularies are word-level anyway; a real deployment
maps ids to text at the edge.

A MESH ENGINE (`ServeEngine(mesh=...)`, one process a device) runs the
same scheduler on every rank.  Rank 0 runs the front door; before each
scheduler iteration it sends the submissions and cancellations it took
since the last one to every rank (`MeshFeed`: one
`broadcast_object_list`, a heartbeat while idle), and every other rank
applies them in the same order and runs the same iteration (`follow`),
so all ranks admit, tick and retire alike.  Rank 0 streams the tokens.

`python -m repro_torch.serve.frontdoor --smoke [--device cpu]` runs the
smoke: start a tiny packed-ternary LSTM server on 127.0.0.1, stream one
request to completion, cancel a second mid-stream by hanging up, re-send a
shared-system-prompt request and check that the prefix cache served its
prefix: the front door's contract in one process, no external client
needed.  It runs on the card unless --device cpu is given.
"""
from __future__ import annotations

import argparse
import asyncio
import dataclasses
import json
import sys
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch.distributed as dist

from repro_torch.serve.engine import Request, ServeEngine

_MAX_BODY = 1 << 20  # a 1 MiB prompt is ~260k int32 tokens — far past any
                     # context this engine provisions; bigger is a bad client
HEARTBEAT_S = 10.0   # an idle mesh front door's broadcast period: the other
                     # ranks wait in a collective, which has a timeout


class MeshFeed:
    """Rank 0's side of a mesh engine's scheduler: the submissions and
    cancellations of the front door, in the order they happened, sent to
    every rank of the default process group before each iteration."""

    def __init__(self):
        self.ops: List[Tuple[str, object]] = []

    def send(self, stop: bool = False) -> None:
        msg = ["stop" if stop else self.ops]
        dist.broadcast_object_list(msg, src=0)
        self.ops = []


def follow(engine: ServeEngine) -> None:
    """A rank other than 0 of a mesh engine behind the front door: apply
    each batch of rank 0's submissions and cancellations in order, then
    run the iteration rank 0 runs (one `step()` when there is work), until
    rank 0 stops."""
    while True:
        msg = [None]
        dist.broadcast_object_list(msg, src=0)
        if msg[0] == "stop":
            return
        for op, arg in msg[0]:
            if op == "submit":
                engine.submit(arg)
            else:
                engine.cancel(arg)
        if engine.has_work():
            engine.step()


# ---------------------------------------------------------------------------
# minimal HTTP/1.1 plumbing
# ---------------------------------------------------------------------------


async def _read_request(reader) -> Optional[Tuple[str, str, dict, bytes]]:
    """Parse one HTTP/1.1 request (start line, headers, Content-Length
    body).  Returns None on EOF/garbage — the handler just closes."""
    try:
        line = await reader.readline()
        parts = line.decode("ascii", "replace").split()
        if len(parts) < 2:
            return None
        method, path = parts[0].upper(), parts[1]
        headers = {}
        while True:
            h = await reader.readline()
            if h in (b"\r\n", b"\n", b""):
                break
            k, _, v = h.decode("ascii", "replace").partition(":")
            headers[k.strip().lower()] = v.strip()
        n = int(headers.get("content-length", "0") or 0)
        if n < 0 or n > _MAX_BODY:
            return None
        body = await reader.readexactly(n) if n else b""
        return method, path, headers, body
    except (asyncio.IncompleteReadError, ConnectionError, ValueError):
        return None


def _response(status: str, ctype: str, body: bytes,
              stream: bool = False) -> bytes:
    head = [f"HTTP/1.1 {status}", f"Content-Type: {ctype}",
            "Cache-Control: no-store", "Connection: close"]
    if not stream:
        head.append(f"Content-Length: {len(body)}")
    return ("\r\n".join(head) + "\r\n\r\n").encode("ascii") + body


def _json_response(status: str, obj) -> bytes:
    return _response(status, "application/json",
                     (json.dumps(obj) + "\n").encode())


def _sse(data, event: Optional[str] = None) -> bytes:
    frame = (f"event: {event}\n" if event else "") + \
        f"data: {json.dumps(data)}\n\n"
    return frame.encode()


# ---------------------------------------------------------------------------
# the front door
# ---------------------------------------------------------------------------


class FrontDoor:
    """One engine, one listener, one pump.  `await start()`, then
    `await serve_forever()` (or drive the returned server yourself);
    `await close()` drains nothing — in-flight requests are cancelled the
    way a dead client would cancel them."""

    def __init__(self, engine: ServeEngine, host: str = "127.0.0.1",
                 port: int = 8700):
        self.engine = engine
        mesh = engine.mesh
        self._feed = (MeshFeed() if mesh is not None and mesh.size() > 1
                      else None)
        self.host, self.port = host, int(port)
        self._streams: Dict[int, asyncio.Queue] = {}
        self._wake = asyncio.Event()
        self._closing = False
        self._server: Optional[asyncio.AbstractServer] = None
        self._pump_task: Optional[asyncio.Task] = None

    # -- engine pump --------------------------------------------------------

    def _submit(self, req: Request) -> int:
        rid = self.engine.submit(req)
        if self._feed is not None:
            self._feed.ops.append(("submit", dataclasses.replace(req,
                                                                 rid=rid)))
        return rid

    def _cancel(self, rid: int) -> None:
        self.engine.cancel(rid)
        if self._feed is not None:
            self._feed.ops.append(("cancel", rid))

    async def _pump(self) -> None:
        """The scheduler loop as an asyncio task: one `engine.step()` per
        iteration while work exists, fan the sampled tokens out to the
        per-request stream queues, park on an Event when idle (on a mesh,
        waking every HEARTBEAT_S to keep the other ranks' collective
        alive).  The `sleep(0)` between steps is the handlers' window to
        submit and cancel — the same between-iterations granularity
        `run()` gives a batch of requests.  On a mesh every iteration
        first sends what the handlers did since the last one, and the
        other ranks run it alike (`follow`)."""
        while not self._closing:
            if not self.engine.has_work() and not (self._feed and
                                                   self._feed.ops):
                self._wake.clear()
                if self.engine.has_work():  # submit raced the clear
                    continue
                try:
                    await asyncio.wait_for(
                        self._wake.wait(),
                        HEARTBEAT_S if self._feed is not None else None)
                except asyncio.TimeoutError:
                    pass
                if self._feed is None or self._closing:
                    continue
            if self._feed is not None:
                self._feed.send()
            if not self.engine.has_work():
                continue
            events, comps = self.engine.step()
            for rid, toks in events:
                q = self._streams.get(rid)
                if q is not None:
                    q.put_nowait(("tokens", toks))
            for c in comps:
                q = self._streams.get(c.rid)
                if q is not None:
                    q.put_nowait(("done", c))
            await asyncio.sleep(0)

    # -- connection handling ------------------------------------------------

    async def _handle(self, reader, writer) -> None:
        try:
            req = await _read_request(reader)
            if req is None:
                return
            method, path, _, body = req
            if method == "POST" and path == "/v1/generate":
                await self._generate(reader, writer, body)
            elif method == "GET" and path == "/v1/stats":
                writer.write(_json_response("200 OK", self.engine.stats()))
                await writer.drain()
            else:
                writer.write(_json_response("404 Not Found",
                                            {"error": f"no route {path}"}))
                await writer.drain()
        except (ConnectionError, asyncio.CancelledError):
            pass
        finally:
            try:
                writer.close()
                await writer.wait_closed()
            except (ConnectionError, OSError):
                pass

    def _parse_request(self, body: bytes) -> Request:
        o = json.loads(body.decode())
        prompt = np.asarray(o["prompt"], np.int32)
        return Request(prompt=prompt,
                       max_tokens=int(o["max_tokens"]),
                       temperature=float(o.get("temperature", 0.8)),
                       top_k=int(o.get("top_k", 0)),
                       seed=int(o.get("seed", 0)),
                       priority=int(o.get("priority", 0)),
                       slo=str(o.get("slo", "default")))

    async def _generate(self, reader, writer, body: bytes) -> None:
        try:
            req = self._parse_request(body)
            rid = self._submit(req)
        except (KeyError, TypeError, ValueError, json.JSONDecodeError) as e:
            writer.write(_json_response("400 Bad Request",
                                        {"error": str(e)}))
            await writer.drain()
            return
        q: asyncio.Queue = asyncio.Queue()
        self._streams[rid] = q
        self._wake.set()
        # EOF watch: a well-behaved client sends nothing after the POST
        # body, so the ONLY way this read completes is the client hanging
        # up — which must cancel the request, whatever phase it is in
        hangup = asyncio.ensure_future(reader.read(1))
        try:
            writer.write(_response("200 OK", "text/event-stream", b"",
                                   stream=True))
            writer.write(_sse({"rid": rid}, event="accepted"))
            await writer.drain()
            while True:
                get = asyncio.ensure_future(q.get())
                done, _ = await asyncio.wait(
                    {get, hangup}, return_when=asyncio.FIRST_COMPLETED)
                if get not in done:  # client hung up mid-stream
                    get.cancel()
                    self._cancel(rid)
                    return
                kind, payload = get.result()
                if kind == "tokens":
                    writer.write(_sse({"rid": rid, "tokens": payload}))
                    await writer.drain()
                else:  # ('done', Completion)
                    c = payload
                    writer.write(_sse(
                        {"rid": rid, "finished": c.finished,
                         "n_tokens": len(c.tokens),
                         "prompt_len": c.prompt_len,
                         "cached_tokens": c.cached_tokens, "slo": c.slo,
                         "ttft_s": c.ttft_s, "latency_s": c.latency_s},
                        event="done"))
                    await writer.drain()
                    return
        except (ConnectionError, OSError):
            # the SSE write itself failed: same as a hangup
            self._cancel(rid)
        finally:
            hangup.cancel()
            self._streams.pop(rid, None)

    # -- lifecycle ----------------------------------------------------------

    async def start(self) -> None:
        self._pump_task = asyncio.ensure_future(self._pump())
        self._server = await asyncio.start_server(self._handle, self.host,
                                                  self.port)
        if self.port == 0:  # ephemeral: report what the OS picked
            self.port = self._server.sockets[0].getsockname()[1]

    async def serve_forever(self) -> None:
        async with self._server:
            await self._server.serve_forever()

    async def close(self) -> None:
        self._closing = True
        self._wake.set()
        if self._pump_task is not None:
            self._pump_task.cancel()
        if self._feed is not None:  # the other ranks leave `follow`
            self._feed.send(stop=True)
            self._feed = None
        if self._server is not None:
            self._server.close()
            await self._server.wait_closed()


# ---------------------------------------------------------------------------
# smoke client + entry point (the CI front-door step)
# ---------------------------------------------------------------------------


async def _post_stream(host: str, port: int, payload: dict, *,
                       hangup_after: Optional[int] = None):
    """Raw-socket SSE client: POST /v1/generate, collect streamed token ids.
    With `hangup_after`, close the socket after that many token events —
    the disconnect path the front door must turn into a cancel."""
    reader, writer = await asyncio.open_connection(host, port)
    body = json.dumps(payload).encode()
    writer.write((f"POST /v1/generate HTTP/1.1\r\nHost: {host}\r\n"
                  f"Content-Type: application/json\r\n"
                  f"Content-Length: {len(body)}\r\n\r\n").encode() + body)
    await writer.drain()
    toks, done, events = [], None, 0
    buf = b""
    while True:
        chunk = await reader.read(4096)
        if not chunk:
            break
        buf += chunk
        while b"\n\n" in buf:
            frame, buf = buf.split(b"\n\n", 1)
            dat = [l[5:] for l in frame.split(b"\n") if l.startswith(b"data:")]
            if not dat:
                continue
            o = json.loads(dat[0])
            if "tokens" in o:
                toks.extend(o["tokens"])
                events += 1
                if hangup_after is not None and events >= hangup_after:
                    writer.close()
                    return toks, None
            elif "finished" in o:
                done = o
        if done is not None:
            break
    writer.close()
    return toks, done


async def _get_json(host: str, port: int, path: str) -> dict:
    reader, writer = await asyncio.open_connection(host, port)
    writer.write(f"GET {path} HTTP/1.1\r\nHost: {host}\r\n\r\n".encode())
    await writer.drain()
    raw = await reader.read()
    writer.close()
    return json.loads(raw.split(b"\r\n\r\n", 1)[1])


def _smoke_engine(device=None):
    """A tiny packed-ternary LSTM engine with a prefix cache, on `device`
    (the card unless the caller asks for the CPU): small enough for a
    second or two, real enough to run every front-door path."""
    import torch

    from repro_torch.core import bnlstm as BL
    from repro_torch.core.quantize import QuantSpec
    from repro_torch.serve.prefixcache import PrefixCache
    from repro_torch.serve.recurrent import RNNRuntime

    cfg = BL.RNNConfig(vocab=32, d_hidden=48, n_layers=2, cell="lstm",
                       quant=QuantSpec(mode="ternary", norm="batch"))
    var = BL.rnn_lm_init(torch.Generator().manual_seed(0), cfg,
                         device=device)
    params = BL.export_packed_rnn(var["params"], cfg)
    rt = RNNRuntime(cfg, {"params": params, "state": var["state"]},
                    device=device)
    eng = ServeEngine(rt, cfg.vocab, slots=2, max_context=96,
                      prefill_chunk=8, prefix_cache=PrefixCache(1 << 24))
    eng.warm()
    return eng


async def _smoke(port: int, device=None) -> int:
    eng = _smoke_engine(device)
    fd = FrontDoor(eng, port=port)
    await fd.start()
    host, port = fd.host, fd.port
    rng = np.random.default_rng(7)
    system = rng.integers(0, 32, size=16).tolist()  # shared "system prompt"
    ok = True

    def check(cond, msg):
        nonlocal ok
        print(("PASS " if cond else "FAIL ") + msg)
        ok = ok and cond

    # 1. stream one request to completion
    toks, done = await _post_stream(host, port, {
        "prompt": system + rng.integers(0, 32, size=4).tolist(),
        "max_tokens": 12, "seed": 1})
    check(done is not None and len(toks) == 12 == done["n_tokens"],
          f"streamed request completed ({len(toks)} tokens)")

    # 2. cancel a second mid-stream by hanging up after 3 token events
    await _post_stream(host, port, {
        "prompt": rng.integers(0, 32, size=10).tolist(),
        "max_tokens": 40, "seed": 2}, hangup_after=3)
    await asyncio.sleep(0.2)  # let the pump observe the hangup
    stats = await _get_json(host, port, "/v1/stats")
    check(stats["active"] == 0 and stats["queued"] == 0,
          "hangup cancelled the in-flight request and freed its slot")
    check(stats["tick_launches"] == 1,
          f"one fused tick a decode step across cancel churn "
          f"(tick_launches={stats['tick_launches']})")

    # 3. repeat the system prompt with a fresh tail: the prefix cache must
    # serve the shared prefix (request 1 inserted its chunk boundaries)
    hits0 = stats["prefix_cache"]["hits"]
    toks3, done3 = await _post_stream(host, port, {
        "prompt": system + rng.integers(0, 32, size=5).tolist(),
        "max_tokens": 6, "seed": 3})
    stats = await _get_json(host, port, "/v1/stats")
    check(done3 is not None and len(toks3) == 6,
          "shared-prefix request completed")
    check(stats["prefix_cache"]["hits"] > hits0
          and done3.get("cached_tokens", 0) >= 8,
          f"prefix cache hit on the repeated system prompt "
          f"(cached_tokens={done3.get('cached_tokens')})")

    await fd.close()
    print("front-door smoke:", "OK" if ok else "FAILED")
    return 0 if ok else 1


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--smoke", action="store_true",
                    help="start a tiny in-process server, run the stream/"
                         "cancel/prefix-hit smoke against it, exit 0/1")
    ap.add_argument("--port", type=int, default=0,
                    help="listen port (0 = ephemeral)")
    ap.add_argument("--device", default=None,
                    help="'cuda' (the default) or 'cpu' for the plain "
                         "PyTorch versions of the kernels")
    args = ap.parse_args(argv)
    if not args.smoke:
        ap.error("standalone serving lives in `python -m "
                 "repro_torch.launch.serve --listen`; this entry point only "
                 "runs --smoke")
    return asyncio.run(_smoke(args.port, args.device))


if __name__ == "__main__":
    sys.exit(main())
