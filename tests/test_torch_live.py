"""The port's live runtime: a real server<->client loop over localhost TCP.

One counterpart of each test of tests/test_live.py, on
``ams_tpu_torch.runtime.live`` with the stub labeler, ``device="cpu"`` and
32x64 frames.  The sessions train in bf16 (the hello's default, as the
JAX server's).  Every wait is bounded (poll and drain timeouts, join
deadlines), so a wedged session fails the test instead of hanging it.

The gates are the JAX file's: after the deltas, the client's parameters
equal the server's post-round student at float16 wire precision on the
changed coordinates and the BN statistics annex exactly; int8d within
half a quantization step of the movement; rejections, deadlines, busy
slots, fault isolation, resume and the write-write drain as there.  One
more test holds the kernel build's lock, which the server's threads
rely on.
"""

import socket
import struct
import threading
import time

import numpy as np
import pytest
import torch

from ams_tpu_torch.convert import params_to_numpy
from ams_tpu_torch.models.mobilenetv2_deeplab import init_student_params
from ams_tpu_torch.runtime.live import (
    LiveClient,
    LiveServer,
    _npz_bytes,
    recv_msg,
    send_msg,
)

HELLO = dict(exp_num=90, height=32, batch_size=2, train_period=1,
             checkpoint="synthetic", device="cpu")


@pytest.fixture(autouse=True)
def _torch_threads():
    torch.set_num_threads(2)


def stub_labeler(frames):
    """Horizontal strata over the live classes of exp 90."""
    h = frames.shape[1]
    classes = np.asarray([0, 1, 2, 8, 10], np.uint8)
    strata = (np.arange(h) * len(classes) // h).astype(np.int64)
    row = classes[strata]
    return np.repeat(row[None, :, None], frames.shape[0], axis=0).repeat(
        frames.shape[2], axis=2)


def _server(**kw):
    server = LiveServer(stub_labeler, device="cpu", **kw)
    server.serve_in_background()
    return server


def _client(server, **kw):
    hello = dict(HELLO)
    hello.update(kw)
    return LiveClient(server.address, **hello)


def _frames(seed, n=2):
    return np.random.RandomState(seed).randint(
        0, 256, (n, 32, 64, 3)).astype(np.uint8)


def assert_client_tracks_server(cli, srv, initial, wire="float16"):
    """The client's params equal the server's final ones at wire
    precision on the changed coordinates; the BN statistics annex rides
    dense float16 and equals the server's exactly after that rounding.
    Returns the number of changed coordinates checked."""
    checked = 0
    for k, sv in srv.items():
        cv = cli[k]
        sv = np.asarray(sv)
        if "moving_" in k:
            np.testing.assert_array_equal(
                cv, sv.astype(np.float16).astype(cv.dtype), err_msg=k)
            continue
        changed = cv != initial[k]
        if not changed.any():
            continue
        if wire == "int8d":
            # per-var symmetric int8 over the movement: |err| <= step/2
            step = np.abs(sv[changed].astype(np.float64)
                          - initial[k][changed]).max() / 127.0
            err = np.abs(cv[changed].astype(np.float64)
                         - sv[changed].astype(np.float64)).max()
            assert err <= step / 2 + 1e-7, (k, err, step)
        else:
            np.testing.assert_allclose(cv[changed], sv[changed], rtol=2e-3,
                                       atol=2e-3, err_msg=k)
        checked += int(changed.sum())
    return checked


def test_live_streaming_loop():
    server = _server()
    client = _client(server, strategy="coord_desc_auto", iters=3,
                     client_id="edge0")
    assert client.network.device.type == "cpu"
    initial = {k: v.copy() for k, v in client.network.get_vars().items()}
    rng = np.random.RandomState(0)
    deltas = sent = 0
    for t in range(3):
        client.send_samples(rng.randint(0, 256, (2, 32, 64, 3))
                            .astype(np.uint8), float(t))
        sent += 1   # train_period=1: every uplink batch triggers a round
        deltas += client.poll_deltas(timeout=60.0)
        if deltas:
            break
    deltas += client.drain(grace=120.0, expect=sent, max_quiet=60.0)
    assert deltas == sent == client.deltas_applied
    assert client.downlink_bits > 0
    cli = client.network.get_vars()
    assert any(not np.array_equal(initial[k], v) for k, v in cli.items())
    pred = client.predict(rng.randint(0, 256, (32, 64, 3)).astype(np.uint8))
    assert pred.shape == (32, 64)
    client.close()
    server.join(timeout=60.0)
    assert assert_client_tracks_server(cli, server.final_vars["edge0"],
                                       initial) > 0
    assert server.rounds_served == deltas


def test_live_int8d_wire():
    server = _server()
    with pytest.raises(ConnectionError, match="restore-mode"):
        _client(server, strategy="coord_desc_auto", iters=2,
                wire_dtype="int8d", no_restore=True, client_id="edge8dbad")
    client = _client(server, strategy="coord_desc_auto", iters=2,
                     wire_dtype="int8d", client_id="edge8d")
    initial = {k: v.copy() for k, v in client.network.get_vars().items()}
    client.send_samples(_frames(7), 0.0)
    got = client.poll_deltas(timeout=60.0)
    got += client.drain(grace=120.0, expect=1, max_quiet=60.0)
    assert got == 1 and client.deltas_applied == 1
    client.close()
    server.join(timeout=60.0)
    assert assert_client_tracks_server(client.network.get_vars(),
                                       server.final_vars["edge8d"], initial,
                                       wire="int8d") > 0


def test_live_server_resume(tmp_path):
    frames = _frames(3)
    hello = dict(strategy="full_model", iters=2, client_id="edgeR")
    s1 = _server(resume_dir=str(tmp_path))
    c1 = _client(s1, **hello)
    assert c1.resume_t is None
    fresh = {k: v.copy() for k, v in c1.network.get_vars().items()}
    c1.send_samples(frames, 0.0)
    assert c1.poll_deltas(timeout=60.0) == 1
    after_round = {k: v.copy() for k, v in c1.network.get_vars().items()}
    c1.close()
    s1.join(timeout=60.0)

    s2 = _server(resume_dir=str(tmp_path))
    c2 = _client(s2, **hello)
    assert c2.resume_t == 0.0
    changed = 0
    for k, v in c2.network.get_vars().items():
        if "moving_" in k:
            continue
        if not np.array_equal(v, fresh[k]):
            np.testing.assert_allclose(v, after_round[k], rtol=2e-3,
                                       atol=2e-3, err_msg=k)
            changed += 1
    assert changed > 0
    c2.send_samples(frames, 1.0)
    assert c2.poll_deltas(timeout=60.0) == 1
    c2.close()
    s2.join(timeout=60.0)


def test_live_hello_rejection():
    server = _server(max_clients=1)
    for bad in (dict(wire_dtype="fp8"), dict(client_id="../../etc/passwd"),
                dict(client_id="cam/1"), dict(checkpoint=".."),
                dict(checkpoint="."), dict(checkpoint="/etc/passwd")):
        kw = dict(iters=1)
        kw.update(bad)
        with pytest.raises(ConnectionError, match="rejected"):
            _client(server, **kw)
    client = _client(server, strategy="full_model", iters=1,
                     client_id="ok-1.2_3")
    assert client.network.get_vars()
    client.close()
    server.join(timeout=60.0)


def test_live_handshake_timeout():
    server = _server(max_clients=1, handshake_timeout=1.0)
    silent = socket.create_connection(tuple(server.address))
    try:
        client = _client(server, strategy="full_model", iters=1,
                         client_id="after-silent")
        assert client.network.get_vars()
        client.close()
    finally:
        silent.close()
    server.join(timeout=60.0)


def test_live_multi_client():
    server = _server(max_clients=2)
    probe = socket.create_connection(tuple(server.address))
    probe.close()
    probe = socket.create_connection(tuple(server.address))
    probe.sendall(b"garbage")
    probe.close()
    clients = [_client(server, strategy="full_model", iters=2,
                       client_id="edge%d" % j,
                       wire_dtype="float16" if j == 0 else "int8")
               for j in range(2)]
    rng = np.random.RandomState(1)
    for c in clients:
        c.send_samples(rng.randint(0, 256, (2, 32, 64, 3)).astype(np.uint8),
                       0.0)
    for c in clients:
        assert c.poll_deltas(timeout=60.0) >= 1
    for c in clients:
        c.close()
    server.join(timeout=60.0)
    assert server.rounds_served >= 2
    a = server.final_vars["edge0"]["logits/semantic/weights"]
    b = server.final_vars["edge1"]["logits/semantic/weights"]
    assert not np.array_equal(a, b)
    assert clients[1].downlink_bits < 0.75 * clients[0].downlink_bits
    for j, c in enumerate(clients):
        np.testing.assert_allclose(
            c.network.get_vars()["logits/semantic/weights"],
            server.final_vars["edge%d" % j]["logits/semantic/weights"],
            rtol=2e-3, atol=2e-3)


def test_live_client_fault_isolation():
    server = _server(max_clients=2)
    good = _client(server, strategy="full_model", iters=2, client_id="good")
    bad = _client(server, strategy="full_model", iters=2, client_id="bad")
    # malformed frame batch: the wrong rank fails inside the bad session
    send_msg(bad.sock, b"F", _npz_bytes(frames=np.zeros((3, 3), np.uint8),
                                        t=np.float64(0.0)))
    t0 = time.time()
    assert bad.drain(grace=60.0, expect=1) == 0
    assert time.time() - t0 < 30.0
    assert bad.server_error is not None and "error" in bad.server_error
    assert bad.closed
    good.send_samples(_frames(5), 0.0)
    assert good.poll_deltas(timeout=60.0) == 1
    good.close()
    bad.close()
    server.join(timeout=60.0, raise_client_errors=False)
    assert list(server.client_errors) == ["bad"]
    assert "good" in server.final_vars
    with pytest.raises(RuntimeError, match="bad"):
        server.join(timeout=1.0)


def test_live_daemon_serves_sequential_clients():
    server = _server(max_clients=1)
    frames = _frames(7)
    for j in range(3):
        c = _client(server, strategy="full_model", iters=1,
                    client_id="seq%d" % j)
        c.send_samples(frames, 0.0)
        assert c.poll_deltas(timeout=60.0) == 1
        c.close()
        server.join(timeout=60.0)
    assert server.sessions_served >= 3
    for j in range(3):
        assert "seq%d" % j in server.final_vars
    server.close(grace=10.0)


def test_live_busy_rejection_and_graceful_shutdown():
    server = _server(max_clients=1)
    hold = _client(server, strategy="full_model", iters=1, client_id="hold")
    with pytest.raises(ConnectionError, match="busy"):
        _client(server, iters=1, client_id="extra")
    server.close(grace=30.0)
    assert "hold" in server.final_vars
    assert not server.client_errors
    hold.close()


def test_live_checkpoint_path_rejected():
    server = _server(max_clients=2)
    for ck in ("/etc/passwd", "../secrets.npy", "a/b.npy", "plain_name"):
        with pytest.raises(ConnectionError, match="rejected"):
            _client(server, iters=1, checkpoint=ck, client_id="attacker")
    ok = _client(server, strategy="full_model", iters=1, client_id="ok")
    assert ok.network.get_vars()
    ok.close()
    server.close(grace=10.0)


def test_live_checkpoint_dir_lookup(tmp_path):
    params = params_to_numpy(init_student_params(42, device="cpu"))
    np.save(tmp_path / "studentA.npy", params)
    server = _server(max_clients=1, checkpoint_dir=str(tmp_path))
    c = _client(server, strategy="full_model", iters=1,
                checkpoint="studentA.npy", client_id="named")
    np.testing.assert_array_equal(
        c.network.get_vars()["logits/semantic/weights"],
        params["logits/semantic/weights"])
    c.close()
    server.close(grace=10.0)


def test_live_oversized_message_rejected():
    server = _server(max_clients=1)
    probe = socket.create_connection(tuple(server.address))
    probe.sendall(struct.pack(">cQ", b"H", 1 << 40))  # a 1 TB claim
    probe.settimeout(30.0)
    try:
        data = probe.recv(1)  # EOF (or RST, if unread bytes were pending)
    except OSError:
        data = b""
    assert data == b""
    probe.close()
    assert server.error is None
    ok = _client(server, strategy="full_model", iters=1, client_id="ok2")
    assert ok.network.get_vars()
    ok.close()
    server.close(grace=10.0)


def test_live_non_object_hello_keeps_accept_loop_alive():
    server = _server(max_clients=1)
    for payload in (b"null", b"42", b"[1, 2]", b'"hello"'):
        probe = socket.create_connection(tuple(server.address))
        probe.sendall(struct.pack(">cQ", b"H", len(payload)) + payload)
        probe.settimeout(30.0)
        hdr = b""
        try:
            while len(hdr) < 9:
                chunk = probe.recv(9 - len(hdr))
                if not chunk:
                    break
                hdr += chunk
        except OSError:
            pass
        probe.close()
        assert hdr[:1] == b"Q", (payload, hdr)
        assert server.is_serving(), payload
    ok = _client(server, strategy="full_model", iters=1,
                 client_id="after-null")
    assert ok.network.get_vars()
    ok.close()
    server.close(grace=10.0)


def test_live_slow_loris_handshake_deadline():
    server = _server(max_clients=1, handshake_timeout=1.0)
    loris = socket.create_connection(tuple(server.address))
    hdr = struct.pack(">cQ", b"H", 2)
    t0 = time.monotonic()
    dropped = False
    loris.settimeout(2.0)
    try:
        for byte in hdr:
            loris.sendall(bytes([byte]))
            time.sleep(0.4)  # < 1.0 per byte, > 1.0 in total
    except OSError:
        dropped = True
    if not dropped:
        try:
            dropped = loris.recv(1) == b""
        except OSError:
            dropped = True
    waited = time.monotonic() - t0
    loris.close()
    assert dropped, "slow-loris peer was never dropped"
    assert waited < 15.0, waited
    assert server.handshakes_failed >= 1
    assert server.is_serving()
    ok = _client(server, strategy="full_model", iters=1,
                 client_id="after-loris")
    assert ok.network.get_vars()
    ok.close()
    server.close(grace=10.0)


def test_live_is_serving_reflects_accept_loop_death():
    server = _server(max_clients=1)
    assert server.is_serving()
    try:
        server._lsock.shutdown(socket.SHUT_RDWR)
    except OSError:
        pass
    server._lsock.close()
    deadline = time.monotonic() + 30.0
    while server.is_serving() and time.monotonic() < deadline:
        time.sleep(0.05)
    assert not server.is_serving()
    assert server.error is not None
    server._shutdown.set()


def _bare_client(sock):
    """A LiveClient shell around an existing socket (no handshake)."""
    client = LiveClient.__new__(LiveClient)
    client.sock = sock
    client._pending = []
    return client


def test_send_draining_breaks_write_write_deadlock():
    a, b = socket.socketpair()
    for s in (a, b):
        s.setsockopt(socket.SOL_SOCKET, socket.SO_SNDBUF, 1 << 16)
        s.setsockopt(socket.SOL_SOCKET, socket.SO_RCVBUF, 1 << 16)
    client = _bare_client(a)
    down = b"\xd0" * (8 << 20)  # server->client "delta"
    up = b"\xf0" * (8 << 20)    # client->server "frame batch"
    peer_got = []

    def peer():
        send_msg(b, b"D", down)          # blocks until the client drains
        peer_got.append(recv_msg(b))     # then reads the client's message

    tp = threading.Thread(target=peer, daemon=True)
    tc = threading.Thread(target=client._send_msg_draining, args=(b"F", up),
                          daemon=True)
    tp.start()
    tc.start()
    tc.join(60.0)
    assert not tc.is_alive(), "client send deadlocked"
    tp.join(60.0)
    assert not tp.is_alive(), "peer deadlocked"
    assert peer_got == [(b"F", up)]
    assert client._pending == [(b"D", down)]
    a.close()
    b.close()


def test_send_draining_peer_close_raises_not_spins():
    a, b = socket.socketpair()
    a.setsockopt(socket.SOL_SOCKET, socket.SO_SNDBUF, 1 << 16)
    client = _bare_client(a)
    b.close()
    t0 = time.monotonic()
    with pytest.raises(OSError):
        client._send_msg_draining(b"F", b"\xf0" * (8 << 20))
    assert time.monotonic() - t0 < 30.0
    assert client._pending in ([], [(None, None)])
    a.close()


def test_live_concurrent_soak(tmp_path):
    """Three clients at once: one streams three batches while the server
    trains the others, one is killed by a TCP RST under its round, one
    disconnects and resumes from its bundle under the same client_id."""
    server = _server(max_clients=3, resume_dir=str(tmp_path))
    hello = dict(strategy="full_model", iters=1)
    frames = _frames(11)
    results, errors = {}, {}

    def run(name, fn):
        def body():
            try:
                results[name] = fn()
            except BaseException as e:  # surfaced in the main thread
                errors[name] = e
        t = threading.Thread(target=body, name=name, daemon=True)
        t.start()
        return t

    def steady():
        c = _client(server, client_id="steady", **hello)
        got = 0
        for t in range(3):
            c.send_samples(frames, float(t))
            got += c.poll_deltas(timeout=60.0)
        got += c.drain(grace=120.0, expect=3, max_quiet=60.0)
        c.close()
        return got

    def killed():
        c = _client(server, client_id="kill", **hello)
        c.send_samples(frames, 0.0)
        c.sock.setsockopt(socket.SOL_SOCKET, socket.SO_LINGER,
                          struct.pack("ii", 1, 0))
        c.sock.close()
        return "rst"

    def resumer():
        c = _client(server, client_id="resume", **hello)
        assert c.resume_t is None
        c.send_samples(frames, 0.0)
        got = c.poll_deltas(timeout=60.0)
        got += c.drain(grace=120.0, expect=1, max_quiet=60.0)
        assert got == 1, got
        after = {k: v.copy() for k, v in c.network.get_vars().items()}
        c.close()
        return after

    deadline = time.monotonic() + 300.0
    threads = [run("steady", steady), run("kill", killed),
               run("resume", resumer)]
    for t in threads:
        t.join(timeout=max(1.0, deadline - time.monotonic()))
        assert not t.is_alive(), "soak wedged: %s never finished" % t.name
    assert not errors, errors
    assert results["steady"] == 3

    c2 = _client(server, client_id="resume", **hello)
    assert c2.resume_t == 0.0
    prev = results["resume"]
    for k, v in c2.network.get_vars().items():
        if "moving_" not in k:
            np.testing.assert_allclose(v, prev[k], rtol=2e-3, atol=2e-3,
                                       err_msg=k)
    c2.send_samples(frames, 1.0)
    assert c2.poll_deltas(timeout=60.0) == 1
    c2.close()
    server.close(grace=60.0)
    assert server.sessions_served == 4, server.sessions_served
    served = results["steady"] + 2   # + the resumer's two rounds
    assert server.rounds_served in (served, served + 1), \
        (server.rounds_served, served)
    assert "steady" in server.final_vars and "resume" in server.final_vars
    assert set(server.client_errors) <= {"kill"}, server.client_errors


def test_kernel_library_builds_once_across_threads(monkeypatch, tmp_path):
    """The live server's sessions and a client in one process may need a
    kernel at the same moment: ``ops.build.load`` builds and loads each
    library once.  Sixteen threads with a short switch interval against a
    stand-in compiler that counts its calls."""
    import sys

    from ams_tpu_torch.ops import build
    from test_torch_ops_build import StandInLibrary

    calls = []

    def fake_build(names):
        calls.append(tuple(names))
        time.sleep(0.05)   # a compile takes a while; others arrive
        return {}

    monkeypatch.setattr(build, "_build", fake_build)
    monkeypatch.setattr(build, "_LOADED", {})
    monkeypatch.setattr(build.ctypes, "CDLL", StandInLibrary)
    libs = []
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(
            target=lambda: libs.append(build.load("resize_argmax")))
            for _ in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(30.0)
            assert not t.is_alive()
    finally:
        sys.setswitchinterval(interval)
    assert calls == [("resize_argmax",)]
    assert len(libs) == 16 and len(set(libs)) == 1
