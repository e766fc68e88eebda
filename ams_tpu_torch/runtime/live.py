"""Live model streaming over a real network transport.

Counterpart of ``ams_tpu/runtime/live.py``, wire-compatible with it: a
port server serves JAX edges and a JAX server serves port edges.  The
reference only emulates the edge<->server link; this module is the actual
system: a server process that receives frame samples, labels them, runs
distillation rounds and streams parameter deltas; and an edge client that
uploads samples, applies downlink deltas to its local student and keeps
inferring, with the wire format of the emulation (``stream/codec.py``).

Protocol (TCP, length-prefixed):

    [1-byte type][8-byte big-endian length][payload]

    'H'  client->server  JSON hello: exp_num/height/iters/strategy/...
    'R'  server->client  JSON resume notice {"resume_t": s}, sent before
                         'M' when the server restored this client_id's
                         session bundle; the edge fast-forwards its stream
    'M'  server->client  initial model snapshot (npz of the float32 raw
                         params under their TF names); a resumed
                         restore-mode session adds base:* keys, the
                         server's initial checkpoint, which is what every
                         'D' delta is relative to
    'F'  client->server  frame batch (npz: frames uint8 (N,H,W,3), t float)
    'V'  client->server  H.264-compressed frame batch (npz: blob, t, and
                         from this package's client hw, the encoded
                         frames' size); the server trains on the decoded
                         frames
    'D'  server->client  delta payload (the gzip'd packbits+fp16 blob)
    'Q'  either          orderly shutdown, or a rejection with its reason

The server owns the teacher through an injected ``labeler`` callable
(frames uint8 (N,H,W,3) -> labels uint8 (N,H,W)): ``runtime.labeler``'s
batched teacher in production, a stub in tests.  It runs outside the
device lock, as in the JAX package.  Deltas are applied with
``SemanticNetwork.apply_downlink``, so a client deployed from the 'M'
snapshot tracks the server's post-round student to wire precision on the
selected parameter subset.

What differs from the JAX package: ``LiveServer`` and ``LiveClient`` take
``device`` (default the card) for the networks they build; the compressed
uplink flips RGB to BGR with ``data/image.py`` (there is no OpenCV), and
the 'V' path decodes by ``stream/uplink.decode_video_bytes``, which needs
the encoded frames' size: the batch's ``hw`` when the client sent one,
else twice the session's frame size, the size the edge CLIs encode.
"""

from __future__ import annotations

import io
import json
import os
import re
import select
import socket
import struct
import threading
import time
from typing import Callable, Dict, Optional

import numpy as np

from ams_tpu_torch import configs as exp_configs
from ams_tpu_torch.data.buffers import FrameMemory
from ams_tpu_torch.runtime import resume as resume_mod
from ams_tpu_torch.runtime.network import SemanticNetwork
from ams_tpu_torch.stream.codec import delta_order, encode_delta

_HDR = struct.Struct(">cQ")

_WIRE_DTYPES = ("float16", "int8", "int8d")
_CLIENT_ID_RE = re.compile(r"[A-Za-z0-9._-]+\Z")

# A frame batch at the largest plausible resolution is tens of MB; anything
# bigger than this is a malformed or hostile length prefix, and honoring it
# would let an unauthenticated peer trigger multi-GB allocations.
MAX_PAYLOAD = 256 << 20


def _hello_error(hello: Dict, checkpoint_dir: Optional[str] = None
                 ) -> Optional[str]:
    """Reject malformed hellos before any device work (and before a bad
    value could crash a round mid-flight, escape the resume_dir, or name
    an arbitrary server-side file as the student checkpoint)."""
    wd = hello.get("wire_dtype", "float16")
    if wd not in _WIRE_DTYPES:
        return "unknown wire_dtype %r (expected one of %s)" % (
            wd, list(_WIRE_DTYPES))
    if wd == "int8d" and hello.get("no_restore", False):
        # int8d quantizes value-minus-INITIAL; without restore-mode
        # training the delta base drifts away from the initial snapshot
        # and the reconstruction would be silently wrong
        return "wire_dtype 'int8d' requires a restore-mode session"
    cid = hello.get("client_id")
    if cid is not None and not _CLIENT_ID_RE.match(str(cid)):
        return ("client_id %r is not filesystem-safe "
                "(allowed: letters, digits, . _ -)" % (cid,))
    # 'checkpoint' is client-controlled: it must never reach the filesystem
    # as a raw path.  Allowed values: "synthetic" (seeded init), or a bare
    # NAME resolved under the server's --checkpoint_dir.
    ck = hello.get("checkpoint")
    if ck is not None and ck != "synthetic":
        # dots-only names ('..', '.') pass the character class but resolve
        # outside checkpoint_dir through os.path.join
        if not _CLIENT_ID_RE.match(str(ck)) or set(str(ck)) <= {"."}:
            return ("checkpoint %r is not a plain name (clients select "
                    "checkpoints from the server's checkpoint_dir by name; "
                    "paths are not accepted)" % (ck,))
        if checkpoint_dir is None:
            return ("server has no checkpoint_dir configured; only "
                    "checkpoint='synthetic' is accepted")
    return None


def send_msg(sock: socket.socket, mtype: bytes, payload: bytes) -> None:
    sock.sendall(_HDR.pack(mtype, len(payload)) + payload)


class ProtocolError(ValueError):
    """Malformed wire data (bad length prefix / oversized message)."""


def recv_msg(sock: socket.socket, max_payload: int = MAX_PAYLOAD,
             deadline: Optional[float] = None):
    """-> (type, payload) or (None, None) on EOF.

    Raises ProtocolError when the length prefix exceeds ``max_payload``
    (the 8-byte length is peer-controlled and arrives before any hello
    validation).  ``deadline`` (time.monotonic seconds) bounds the WHOLE
    message, not each recv: a per-recv timeout alone lets a slow-loris
    peer trickle one byte per window and reset the clock on every byte."""
    hdr = _recv_exact(sock, _HDR.size, deadline)
    if hdr is None:
        return None, None
    mtype, n = _HDR.unpack(hdr)
    if n > max_payload:
        raise ProtocolError("message length %d exceeds cap %d"
                            % (n, max_payload))
    payload = _recv_exact(sock, n, deadline) if n else b""
    if n and payload is None:
        return None, None
    return mtype, payload


def _recv_exact(sock: socket.socket, n: int,
                deadline: Optional[float] = None) -> Optional[bytes]:
    buf = b""
    while len(buf) < n:
        if deadline is not None:
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                raise socket.timeout("recv deadline exceeded")
            sock.settimeout(remaining)
        chunk = sock.recv(n - len(buf))
        if not chunk:
            return None
        buf += chunk
    return buf


def _npz_bytes(**arrays) -> bytes:
    buf = io.BytesIO()
    np.savez_compressed(buf, **arrays)
    return buf.getvalue()


def _npz_load(blob: bytes) -> Dict[str, np.ndarray]:
    with np.load(io.BytesIO(blob)) as z:
        return {k: z[k] for k in z.files}


def _resolve_checkpoint(hello: Dict, checkpoint_dir: Optional[str],
                        default_checkpoint) -> object:
    """Map the (validated) hello 'checkpoint' onto a trusted source: the
    server operator's default, 'synthetic', or a name inside
    checkpoint_dir.  _hello_error has already rejected anything else."""
    ck = hello.get("checkpoint")
    if ck is None:
        return default_checkpoint if default_checkpoint is not None \
            else "synthetic"
    if ck == "synthetic":
        return "synthetic"
    return os.path.join(checkpoint_dir, str(ck))


class _ClientState:
    """Per-connection server-side state: one student + frame memory."""

    def __init__(self, hello: Dict, *, checkpoint_dir=None,
                 default_checkpoint=None, device=None):
        self.hello = hello
        exp_num = hello["exp_num"]
        height = hello["height"]
        self.strategy = hello.get("strategy", "coord_desc_auto")
        self.iters = hello.get("iters", 200)
        self.train_period = hello.get("train_period", 10)
        self.no_restore = hello.get("no_restore", False)
        self.wire_dtype = hello.get("wire_dtype", "float16")
        self.network = SemanticNetwork(
            meta_dir=_resolve_checkpoint(hello, checkpoint_dir,
                                         default_checkpoint),
            class_weights_exp=exp_configs.class_weights(exp_num),
            height=height, scale=[1],
            mini_batch_size=hello.get("batch_size", 10),
            lr=hello.get("lr", 1e-3),
            coord_frac=hello.get("coord_frac", 0.1),
            compute_dtype=hello.get("compute_dtype", "bfloat16"),
            over_ride_total_classes=exp_configs.num_classes(exp_num),
            device=device)
        self.memory = FrameMemory(hello.get("memory_capacity", 256),
                                  height, 2 * height)
        self.last_train_t = -1e9
        self.rounds = 0  # this client's round count (not the server's)


class LiveServer:
    """AMS server: label -> train -> stream deltas, over real sockets.

    Mirrors the emulated server loop's per-event behavior
    (runtime/server.py: restore_initial -> train_with_deque -> delta) but
    driven by frames arriving over the network.  ``max_clients`` > 1
    serves several edge streams from one device: each connection owns an
    independent student + frame memory, and rounds run serially under the
    device lock.  Each session's network is built on ``device`` (default
    the card).

    Lifecycle: the accept loop runs until ``close()``; ``max_clients`` is
    a concurrency cap (a semaphore), not a lifetime quota, so client N+1
    is served after a disconnect frees a slot; over-cap connections get an
    immediate 'Q' "server busy" instead of queueing into a half-open
    backlog.  Sessions idle longer than ``idle_timeout`` seconds are
    reaped as orderly disconnects.  ``close()`` stops accepting, nudges
    live sessions shut (their final state still lands in ``final_vars`` /
    the resume bundle) and joins every thread.
    """

    def __init__(self, labeler: Callable[[np.ndarray], np.ndarray], *,
                 host: str = "127.0.0.1", port: int = 0,
                 max_clients: int = 1, resume_dir: Optional[str] = None,
                 checkpoint_dir: Optional[str] = None,
                 default_checkpoint=None,
                 idle_timeout: Optional[float] = None,
                 handshake_timeout: float = 10.0, device=None):
        self.labeler = labeler
        self.max_clients = max_clients
        self.device = device
        # per-client state bundles survive server restarts: a reconnecting
        # client_id resumes its student, Adam slots, frame memory and
        # training clock (runtime/resume.py)
        self.resume_dir = resume_dir
        # trusted root for hello 'checkpoint' names; None = only
        # 'synthetic' is accepted
        self.checkpoint_dir = checkpoint_dir
        self.default_checkpoint = default_checkpoint  # operator-supplied
        self.idle_timeout = idle_timeout
        # pre-hello recv bound: the handshake runs inline on the single
        # accept thread, so a byte-less connection must time out, not
        # wedge the daemon
        self.handshake_timeout = handshake_timeout
        self._lsock = socket.create_server((host, port))
        self.address = self._lsock.getsockname()
        self._threads = []
        self._anon_seq = iter(range(1 << 30))  # stable anonymous ids
        self._accept_thread: Optional[threading.Thread] = None
        self._device_lock = threading.Lock()  # rounds serialize on the card
        self._slots = threading.BoundedSemaphore(max_clients)
        self._shutdown = threading.Event()
        self._conns_lock = threading.Lock()
        self._active_conns: set = set()
        self.rounds_served = 0     # updated under _conns_lock: concurrent
        self.sessions_served = 0   # client threads would lose '+=' races
        self.handshakes_failed = 0  # accept-thread only (no lock needed)
        self.final_vars: Dict = {}  # last-round params per client id
        self.error: Optional[BaseException] = None  # accept-loop failure
        self.client_errors: Dict = {}  # per-client faults, isolated

    def serve_in_background(self) -> None:
        self._accept_thread = threading.Thread(target=self._accept_loop,
                                               daemon=True)
        self._accept_thread.start()

    def is_serving(self) -> bool:
        """True while the accept loop is alive and fault-free: the daemon
        supervisor (cli/serve.py) polls this, so an accept-loop fault ends
        the process instead of leaving one that refuses every
        connection."""
        return (self.error is None and self._accept_thread is not None
                and self._accept_thread.is_alive())

    def join(self, timeout=None, raise_client_errors: bool = True) -> None:
        """Wait for every active client session to finish (the accept loop
        keeps serving until ``close()``; after close it is joined too).

        One client's fault never interrupts the others' service; after all
        threads finish, a server-level failure re-raises, and client
        faults raise an aggregate unless ``raise_client_errors=False``
        (inspect ``client_errors`` instead)."""
        assert self._accept_thread is not None
        if self._shutdown.is_set():
            self._accept_thread.join(timeout)
        for t in list(self._threads):
            t.join(timeout)
        if self.error is not None:
            raise self.error
        done = all(not t.is_alive() for t in self._threads)
        if done and self.client_errors and raise_client_errors:
            raise RuntimeError(
                "client session(s) failed: %s" %
                {k: repr(e) for k, e in self.client_errors.items()}
            ) from next(iter(self.client_errors.values()))

    def close(self, grace: float = 30.0,
              raise_client_errors: bool = False) -> None:
        """Graceful shutdown: stop accepting, signal live sessions end of
        stream (SHUT_RD: their receive loop sees EOF, the in-flight round
        completes and its delta still ships), run each session's normal
        epilogue, and only hard-close sockets that outlive ``grace``."""
        self._shutdown.set()
        try:
            # shutdown() is what wakes a thread blocked in accept() on
            # Linux; close() alone leaves it parked
            self._lsock.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass
        try:
            self._lsock.close()
        except OSError:
            pass
        if self._accept_thread is not None:
            self._accept_thread.join(grace)
        with self._conns_lock:
            lingering = list(self._active_conns)
        for conn in lingering:
            try:
                conn.shutdown(socket.SHUT_RD)
            except OSError:
                pass
        deadline = time.time() + grace
        for t in list(self._threads):
            t.join(max(0.0, deadline - time.time()))
        with self._conns_lock:
            stuck = list(self._active_conns)
        for conn in stuck:
            try:
                conn.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
        for t in list(self._threads):
            t.join(1.0)
        if self._accept_thread is not None:
            self.join(timeout=1.0, raise_client_errors=raise_client_errors)

    def _accept_loop(self) -> None:
        try:
            while not self._shutdown.is_set():
                try:
                    conn, _peer = self._lsock.accept()
                except OSError:
                    if self._shutdown.is_set():
                        break  # close() closed the listen socket
                    raise
                # reap finished session threads so a long-lived daemon's
                # thread list does not grow without bound
                self._threads = [t for t in self._threads if t.is_alive()]
                # handshake inline, bounded by a deadline for the whole
                # hello: a stray connection must not burn a slot, and a
                # silent or trickling peer must not park this thread
                try:
                    mtype, payload = recv_msg(
                        conn,
                        deadline=time.monotonic() + self.handshake_timeout)
                    conn.settimeout(None)
                    if mtype != b"H":
                        conn.close()
                        continue
                    hello = json.loads(payload.decode())
                    # a JSON hello that is not an object (null, a number,
                    # a list) is rejected, not allowed to raise in here
                    if not isinstance(hello, dict):
                        err = ("hello must be a JSON object, got %s"
                               % type(hello).__name__)
                    else:
                        err = _hello_error(hello, self.checkpoint_dir)
                    if err is not None:
                        try:
                            send_msg(conn, b"Q", err.encode())
                        except OSError:
                            pass
                        conn.close()
                        continue
                except Exception:
                    # no per-connection failure may stop the accept loop;
                    # counted so failed handshakes stay observable (polite
                    # 'Q' rejections are not failures)
                    self.handshakes_failed += 1
                    conn.close()
                    continue
                if not self._slots.acquire(blocking=False):
                    try:
                        send_msg(conn, b"Q", (
                            "server busy: %d sessions active"
                            % self.max_clients).encode())
                    except OSError:
                        pass
                    conn.close()
                    continue
                t = threading.Thread(target=self._client_loop,
                                     args=(conn, hello), daemon=True)
                self._threads.append(t)
                t.start()
        except BaseException as e:
            self.error = e
        finally:
            self._lsock.close()

    def _client_loop(self, conn: socket.socket, hello: Dict) -> None:
        with self._conns_lock:
            self._active_conns.add(conn)
        try:
            self._handle(conn, hello)
        except BaseException as e:
            # fault isolation: record per client (join aggregates), tell
            # the client why its session died, never touch other sessions;
            # anonymous sessions get stable keys
            cid = hello.get("client_id") or "<anon-%d>" % next(self._anon_seq)
            self.client_errors[cid] = e
            try:
                send_msg(conn, b"Q", ("server error: %r" % e).encode())
            except OSError:
                pass
        finally:
            with self._conns_lock:
                self._active_conns.discard(conn)
                self.sessions_served += 1
            conn.close()
            self._slots.release()

    def _resume_prefix(self, client_id) -> Optional[str]:
        if self.resume_dir is None:
            return None
        os.makedirs(self.resume_dir, exist_ok=True)
        return os.path.join(self.resume_dir, "live_%s" % client_id)

    def _decode_uplink(self, batch, st: _ClientState) -> np.ndarray:
        from ams_tpu_torch.stream.uplink import decode_video_bytes

        size = (st.memory.height, st.memory.width)
        in_hw = tuple(int(v) for v in batch["hw"]) if "hw" in batch \
            else (2 * size[0], 2 * size[1])
        return np.stack(decode_video_bytes(batch["blob"].tobytes(), size,
                                           in_hw))

    def _handle(self, conn: socket.socket, hello: Dict) -> None:
        if self.idle_timeout is not None:
            # a silent peer is reaped as an orderly disconnect (see the
            # socket.timeout handling in the receive loop below)
            conn.settimeout(self.idle_timeout)
        st = _ClientState(hello, checkpoint_dir=self.checkpoint_dir,
                          default_checkpoint=self.default_checkpoint,
                          device=self.device)
        # persistence is keyed on an explicit client_id only
        client_id = st.hello.get("client_id")

        prefix = self._resume_prefix(client_id) if client_id is not None \
            else None
        resumed_t = None
        if prefix is not None:
            bundle = resume_mod.load_state(prefix)
            if bundle is not None:
                arrays, meta = bundle
                resume_mod.restore_network(st.network, arrays)
                resume_mod.restore_memory(st.memory, arrays)
                st.last_train_t = float(meta["second"])
                st.rounds = int(meta.get("update_count", 0))
                resumed_t = st.last_train_t
        if resumed_t is not None:
            # tell the edge where its session left off so it can
            # fast-forward the stream
            send_msg(conn, b"R",
                     json.dumps({"resume_t": resumed_t}).encode())

        # initial deploy: the full raw snapshot (or the resumed session
        # state).  A resumed restore-mode session also ships the server's
        # initial checkpoint (base: keys): its deltas are relative to it.
        m_arrays = dict(st.network.get_vars())
        if resumed_t is not None and not st.no_restore:
            for k, v in st.network.initial_vars().items():
                m_arrays["base:" + k] = v
        send_msg(conn, b"M", _npz_bytes(**m_arrays))

        while True:
            try:
                mtype, payload = recv_msg(conn)
            except socket.timeout:
                break  # idle-session reap: orderly end, state preserved
            if mtype in (None, b"Q"):
                break
            if mtype not in (b"F", b"V"):
                # peer-controlled wire data: raise, and fault isolation
                # records it and notifies the client
                raise ProtocolError("unexpected message type %r" % mtype)
            batch = _npz_load(payload)
            t = float(batch["t"])
            frames = self._decode_uplink(batch, st) if mtype == b"V" \
                else batch["frames"]
            t_lab = time.perf_counter()
            labels = self.labeler(frames)
            t_lab = time.perf_counter() - t_lab
            # per-phase latency record for operators: one line per uplink
            # batch / round
            print("[live] t=%.0f labeled %d frames in %.2fs"
                  % (t, len(frames), t_lab), flush=True)
            st.memory.extend(list(frames), list(labels))
            if t - st.last_train_t < st.train_period or not len(st.memory):
                continue
            st.last_train_t = t
            t_train = time.perf_counter()
            with self._device_lock:
                if not st.no_restore:
                    st.network.restore_initial()
                st.network.train_with_deque(st.memory.frames,
                                            st.memory.labels, st.iters,
                                            st.strategy)
            t_train = time.perf_counter() - t_train
            names = delta_order(st.strategy,
                                present=st.network.params.keys())
            # the live loop is a real delta consumer, so coord payloads
            # always carry the BN moving-stats annex (stream/codec.py
            # STATS_MAGIC): without it the client runs new weights against
            # stale normalizers
            stats = None
            if st.strategy != "full_model":
                stats = st.network.stats_vars()
            # int8d base: the restore-mode delta is relative to the
            # session's initial checkpoint (the client's base_initial
            # snapshot)
            base = (st.network.initial_vars()
                    if st.wire_dtype == "int8d" else None)
            t_enc = time.perf_counter()
            blob = encode_delta(dict(zip(names, st.network.train_params)),
                                dict(zip(names, st.network.curr_mask)),
                                strategy=st.strategy,
                                wire_dtype=st.wire_dtype,
                                stats=stats, base=base)
            t_enc = time.perf_counter() - t_enc
            print("[live] t=%.0f round %d: train %.2fs encode %.2fs "
                  "payload %dB (%s/%s)"
                  % (t, st.rounds + 1, t_train, t_enc, len(blob),
                     st.strategy, st.wire_dtype), flush=True)
            try:
                send_msg(conn, b"D", blob)
            except (BrokenPipeError, ConnectionResetError):
                break  # client hung up mid-round: normal end of stream
            with self._conns_lock:
                self.rounds_served += 1
            st.rounds += 1
            if prefix is not None:
                # the untruncated float clock: int() would shift the
                # resumed training schedule by up to 1 s
                resume_mod.save_state(
                    prefix, network=st.network, memory=st.memory,
                    second=st.last_train_t, send_rate=0.0,
                    sample_per_period=[], up_bw=[], down_bw=[],
                    model_save_times=[], save_range=[], trained_seconds=[],
                    update_count=st.rounds)
        self.final_vars[client_id if client_id is not None else id(st)] = \
            st.network.get_vars()
        st.network.close_model()


class LiveClient:
    """Edge client: upload frame samples, apply downlink deltas, infer.
    Its frozen, unfolded float32 network is built on ``device`` (default
    the card), where ``predict`` ends in the fused resize+argmax
    kernel."""

    def __init__(self, address, *, exp_num: int, height: int,
                 strategy: str = "coord_desc_auto",
                 wire_dtype: str = "float16", device=None, **hello_extra):
        self.exp_num = exp_num
        self.height = height
        self.strategy = strategy
        self.wire_dtype = wire_dtype
        # mirrors the server's per-round restore semantics: with restore
        # (default), every delta is relative to the INITIAL deployment, so
        # the client re-bases each apply on its initial snapshot
        self.no_restore = bool(hello_extra.get("no_restore", False))
        self.sock = socket.create_connection(tuple(address))
        hello = dict(exp_num=exp_num, height=height, strategy=strategy,
                     wire_dtype=wire_dtype, **hello_extra)
        send_msg(self.sock, b"H", json.dumps(hello).encode())
        self.resume_t: Optional[float] = None  # server-restored clock
        while True:
            mtype, payload = recv_msg(self.sock)
            if mtype == b"R":
                self.resume_t = float(
                    json.loads(payload.decode())["resume_t"])
                continue
            if mtype == b"Q":
                raise ConnectionError(
                    "server rejected hello: %s" % payload.decode())
            break
        if mtype != b"M":
            raise ProtocolError("expected model snapshot 'M', got %r"
                                % mtype)
        arrays = _npz_load(payload)
        delta_base = {k[len("base:"):]: v for k, v in arrays.items()
                      if k.startswith("base:")}
        current = {k: v for k, v in arrays.items()
                   if not k.startswith("base:")}
        self.network = SemanticNetwork(
            meta_dir=current,
            class_weights_exp=exp_configs.class_weights(exp_num),
            height=height, frozen=True,
            over_ride_total_classes=exp_configs.num_classes(exp_num),
            device=device)
        if delta_base:
            self.network.set_restore_target(delta_base)
        self.deltas_applied = 0
        self.downlink_bits = 0
        self.uplink_bits = 0
        self.delta_bits: list = []  # per-delta payload bits, in order
        self.server_error: Optional[str] = None  # from an error 'Q'
        self.closed = False  # set on EOF / 'Q' from the server
        self._pending: list = []  # messages drained mid-send (see below)

    def _send_msg_draining(self, mtype: bytes, payload: bytes) -> None:
        """send_msg that drains incoming messages while write-blocked.

        Both directions can carry multi-MB payloads (uncompressed sample
        batches up, full_model deltas down).  A blocking sendall while the
        server is itself mid-sendall of a delta is a distributed deadlock:
        neither side reads, both socket buffers fill, both block.  Draining
        the read side whenever the write side would block breaks the
        cycle; drained messages queue for the next poll_deltas."""
        data = _HDR.pack(mtype, len(payload)) + payload
        view = memoryview(data)
        sent = 0
        eof = False  # once the read side hits EOF it stays "readable"
        self.sock.setblocking(False)
        try:
            while sent < len(view):
                rlist = [] if eof else [self.sock]
                r, w, _ = select.select(rlist, [self.sock], [], 30.0)
                if r:
                    self.sock.setblocking(True)
                    try:
                        got = recv_msg(self.sock)
                    finally:
                        self.sock.setblocking(False)
                    self._pending.append(got)
                    if got[0] is None:
                        # EOF: stop draining (the socket would select
                        # readable forever); the send below surfaces the
                        # broken pipe once the buffer fills
                        eof = True
                if w:
                    try:
                        sent += self.sock.send(view[sent:])
                    except (BlockingIOError, InterruptedError):
                        continue
        finally:
            self.sock.setblocking(True)

    def send_samples(self, frames: np.ndarray, t: float) -> None:
        """Uplink a (N, H, 2H, 3) uint8 RGB frame batch stamped at stream
        second ``t`` (lossless, npz-deflate)."""
        payload = _npz_bytes(frames=np.asarray(frames, np.uint8),
                             t=np.float64(t))
        self._send_msg_draining(b"F", payload)
        self.uplink_bits += len(payload) * 8

    def send_samples_compressed(self, frames: np.ndarray, t: float, *,
                                bitrate_kbps: float, fps: int = 10) -> bool:
        """Compressed uplink: H.264-encode the RGB batch at the target
        bitrate by ffmpeg and ship the video bytes with the frames' size;
        the server trains on the decoded frames.  Returns True (the
        reference codec ran); without ffmpeg it raises."""
        from ams_tpu_torch.data.image import rgb_to_bgr
        from ams_tpu_torch.stream.uplink import encode_h264_bytes

        bgr = [rgb_to_bgr(np.asarray(f, np.uint8)) for f in frames]
        blob, exact = encode_h264_bytes(bgr, bitrate_kbps, fps=fps)
        self._send_msg_draining(
            b"V", _npz_bytes(blob=np.frombuffer(blob, np.uint8),
                             t=np.float64(t),
                             hw=np.asarray(bgr[0].shape[:2], np.int64)))
        self.uplink_bits += len(blob) * 8
        return exact

    def poll_deltas(self, timeout: float = 0.0) -> int:
        """Apply any pending downlink deltas; returns how many."""
        applied = 0
        while True:
            if self._pending:
                mtype, payload = self._pending.pop(0)
            else:
                ready = _readable(self.sock, timeout if applied == 0 else 0.0)
                if not ready:
                    return applied
                mtype, payload = recv_msg(self.sock)
            if mtype == b"Q" and payload:
                self.server_error = payload.decode()  # faulted session
            if mtype in (None, b"Q"):
                self.closed = True
                return applied
            if mtype != b"D":
                raise ProtocolError("expected delta 'D', got %r" % mtype)
            self.network.apply_downlink(payload, strategy=self.strategy,
                                        wire_dtype=self.wire_dtype,
                                        base_initial=not self.no_restore)
            self.downlink_bits += len(payload) * 8
            self.delta_bits.append(len(payload) * 8)
            self.deltas_applied += 1
            applied += 1

    def predict(self, frame: np.ndarray) -> np.ndarray:
        return self.network.predict_input(frame[None])[0]

    def drain(self, grace: float = 30.0, quiet: float = 1.0,
              expect: Optional[int] = None,
              max_quiet: Optional[float] = None) -> int:
        """End of stream: apply in-flight deltas.

        With ``expect`` (total deltas this client should see; the caller
        can mirror the server's train-period arithmetic), waits up to
        ``grace`` for the count to be reached; otherwise stops after the
        link is quiet for ``quiet`` seconds.  ``max_quiet`` also bounds
        the silence while expecting, for a caller whose round arithmetic
        over-counted.  Returns how many it applied."""
        applied = 0
        deadline = time.time() + grace
        last_progress = time.time()
        while time.time() < deadline:
            if expect is not None and self.deltas_applied >= expect:
                break
            remaining = deadline - time.time()
            n = self.poll_deltas(
                timeout=min(remaining, 5.0) if expect is not None else quiet)
            applied += n
            if n:
                last_progress = time.time()
            # EOF or fault: no more deltas will come, and a dead socket
            # reads as instantly readable
            if self.closed:
                break
            if n == 0 and expect is None:
                break
            if (expect is not None and max_quiet is not None
                    and time.time() - last_progress > max_quiet):
                break
        return applied

    def close(self) -> None:
        try:
            send_msg(self.sock, b"Q", b"")
        except OSError:
            pass
        self.sock.close()


def _readable(sock: socket.socket, timeout: float) -> bool:
    r, _, _ = select.select([sock], [], [], timeout)
    return bool(r)
