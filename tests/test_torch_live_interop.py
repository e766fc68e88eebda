"""The live wire between the two packages, over localhost TCP.

A port ``LiveServer`` serves a JAX ``LiveClient``, and a JAX ``LiveServer``
serves a port ``LiveClient``, each on the float16 and the int8d wire: one
hello (the JAX client's default one, which names no compute type, so both
servers train in bf16), one uplink batch of two 32x64 frames, one
coord_desc_auto round of 2 iterations with the stub labeler, one delta.
Gates: the client's parameters equal the server's final ones at wire
precision on the changed coordinates (float16: rtol/atol 2e-3; int8d:
half a quantization step of the movement) and its BN statistics equal the
server's after the annex's float16 rounding; the 'M' snapshot's keys and
float32 types are what the other package's client reads.  Each server
refuses the int8d-without-restore hello of the other package's client.
"""

import numpy as np
import pytest
import torch

from ams_tpu.runtime import live as jlive

from ams_tpu_torch.runtime import live as tlive

from test_torch_live import assert_client_tracks_server, stub_labeler
from test_torch_loop_parts import fake_ffmpeg  # noqa: F401 (a fixture)

HELLO = dict(exp_num=90, height=32, strategy="coord_desc_auto", iters=2,
             batch_size=2, train_period=1, checkpoint="synthetic")


@pytest.fixture(autouse=True)
def _torch_threads():
    torch.set_num_threads(2)


def _one_round(server, client, cid):
    initial = {k: v.copy() for k, v in client.network.get_vars().items()}
    for k, v in initial.items():
        assert v.dtype == np.float32, k
    frames = np.random.RandomState(5).randint(
        0, 256, (2, 32, 64, 3)).astype(np.uint8)
    client.send_samples(frames, 0.0)
    got = client.poll_deltas(timeout=100.0)
    got += client.drain(grace=100.0, expect=1, max_quiet=60.0)
    assert got == 1 and client.deltas_applied == 1
    client.close()
    server.join(timeout=60.0)
    assert set(server.final_vars[cid]) == set(initial)
    return initial


@pytest.mark.parametrize("wire", ["float16", "int8d"])
def test_torch_server_serves_jax_edge(wire):
    server = tlive.LiveServer(stub_labeler, device="cpu")
    server.serve_in_background()
    try:
        with pytest.raises(ConnectionError, match="restore-mode"):
            jlive.LiveClient(server.address, wire_dtype="int8d",
                             no_restore=True, client_id="jbad", **HELLO)
        client = jlive.LiveClient(server.address, wire_dtype=wire,
                                  client_id="j" + wire, **HELLO)
        initial = _one_round(server, client, "j" + wire)
    finally:
        server.close(grace=10.0)
    assert not server.client_errors
    assert assert_client_tracks_server(
        client.network.get_vars(), server.final_vars["j" + wire], initial,
        wire=wire) > 0


@pytest.mark.parametrize("wire", ["float16", "int8d"])
def test_jax_server_serves_torch_edge(wire):
    server = jlive.LiveServer(stub_labeler)
    server.serve_in_background()
    try:
        with pytest.raises(ConnectionError, match="restore-mode"):
            tlive.LiveClient(server.address, wire_dtype="int8d",
                             no_restore=True, client_id="tbad",
                             device="cpu", **HELLO)
        client = tlive.LiveClient(server.address, wire_dtype=wire,
                                  client_id="t" + wire, device="cpu",
                                  **HELLO)
        initial = _one_round(server, client, "t" + wire)
    finally:
        server.close(grace=10.0)
    assert not server.client_errors
    assert assert_client_tracks_server(
        client.network.get_vars(), server.final_vars["t" + wire], initial,
        wire=wire) > 0


def test_compressed_uplink_from_either_client(fake_ffmpeg):
    """The 'V' uplink into a port server, through the wrapped fake ffmpeg
    of tests/test_torch_loop_parts.py: a port client sends the encoded
    frames' size, a JAX client (cv2's colour flip) sends none and the
    server takes twice the session's size.  Both encode the same bytes;
    the server labels and trains on the decoded frames at 32x64."""
    seen = []

    def labeler(frames):
        seen.append(frames.shape)
        return stub_labeler(frames)

    server = tlive.LiveServer(labeler, device="cpu", max_clients=2)
    server.serve_in_background()
    frames = np.random.RandomState(9).randint(
        0, 256, (2, 64, 128, 3)).astype(np.uint8)
    hello = dict(HELLO, strategy="full_model", iters=1)
    try:
        ours = tlive.LiveClient(server.address, client_id="tv", device="cpu",
                                **hello)
        assert ours.send_samples_compressed(frames, 0.0, bitrate_kbps=300)
        assert ours.poll_deltas(timeout=100.0) == 1
        theirs = jlive.LiveClient(server.address, client_id="jv", **hello)
        theirs.send_samples_compressed(frames, 0.0, bitrate_kbps=300)
        assert theirs.poll_deltas(timeout=100.0) == 1
        ours.close()
        theirs.close()
        server.join(timeout=60.0)
    finally:
        server.close(grace=10.0)
    assert not server.client_errors
    assert seen == [(2, 32, 64, 3)] * 2
    assert ours.uplink_bits == theirs.uplink_bits > 0
    assert len(fake_ffmpeg.records()) >= 4
