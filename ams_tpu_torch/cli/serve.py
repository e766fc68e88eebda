#!/usr/bin/env python
"""AMS live server CLI: accept edge clients, label, train, stream deltas.

Flag-compatible with ``ams_tpu/cli/serve.py``, plus ``--device`` and
``--gpu``.  The deployment counterpart of the emulated experiment
(``cli/run.py``): it serves real edge clients (``cli/edge.py``, of this
package or the JAX one) over TCP.  The teacher is built on the first
uplink batch; the server listens at once.  With ``--port 0`` the line it
prints names the port it bound.

Example (on the card; ``--device cpu`` runs on the host):
    python -m ams_tpu_torch.cli.serve --port 9097 \
        --teacher_checkpoint ckpt/xception65.npz --max_clients 3
"""

import argparse
import signal
import sys
import threading


def build_parser():
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--host", default="127.0.0.1",
                   help="bind address; loopback by default; pass 0.0.0.0 "
                        "explicitly to serve remote edges (the hello is "
                        "validated but not authenticated)")
    p.add_argument("--port", type=int, default=9097)
    p.add_argument("--teacher_checkpoint", default=None,
                   help="Xception-65 teacher weights (.npz/.npy); omitted = "
                        "seeded synthetic (demo only)")
    p.add_argument("--compute_dtype", choices=["float32", "bfloat16"],
                   default="bfloat16")
    p.add_argument("--label_batch", type=int, default=None,
                   help="fixed frames per teacher call; default scales with "
                        "the first batch's frame height: 32 up to 320 rows, "
                        "16 up to 640, 8 beyond")
    p.add_argument("--max_clients", type=int, default=1,
                   help="edge streams served CONCURRENTLY (a semaphore, not "
                        "a lifetime quota: the daemon serves client N+1 "
                        "after a disconnect; rounds run serially on the "
                        "device)")
    p.add_argument("--resume_dir", default="",
                   help="persist per-client session bundles; a restarted "
                        "server resumes reconnecting client_ids")
    p.add_argument("--checkpoint_dir", default="",
                   help="trusted directory of student checkpoints clients "
                        "may select BY NAME in their hello; unset = only "
                        "checkpoint='synthetic' is accepted (client-"
                        "supplied paths are never opened)")
    p.add_argument("--student_checkpoint", default=None,
                   help="operator-side default student weights for clients "
                        "that send no checkpoint")
    p.add_argument("--idle_timeout", type=float, default=600.0,
                   help="seconds of client silence before the session is "
                        "reaped (state persists via --resume_dir); 0 = "
                        "never")
    p.add_argument("--gpu", default="0",
                   help="CUDA device index (--device cuda)")
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                   help="Where the students and the teacher run (default: "
                        "the GPU)")
    return p


def main(argv=None):
    a = build_parser().parse_args(argv)

    from ams_tpu_torch.runtime.labeler import make_teacher_labeler
    from ams_tpu_torch.runtime.live import LiveServer
    from ams_tpu_torch.utils.platform import resolve_device

    # refuse a missing card before listening, not on the first session
    device = resolve_device("cpu" if a.device == "cpu"
                            else "cuda:%d" % int(a.gpu))

    # lazy: listen immediately; build the teacher on the first batch
    # (locked: concurrent client threads must not build it twice)
    holder = {}
    holder_lock = threading.Lock()

    def labeler(frames):
        with holder_lock:
            if "fn" not in holder:
                holder["fn"] = make_teacher_labeler(
                    a.teacher_checkpoint, compute_dtype=a.compute_dtype,
                    batch=a.label_batch, device=device)
            fn = holder["fn"]
        return fn(frames)

    server = LiveServer(labeler, host=a.host, port=a.port,
                        max_clients=a.max_clients,
                        resume_dir=a.resume_dir or None,
                        checkpoint_dir=a.checkpoint_dir or None,
                        default_checkpoint=a.student_checkpoint,
                        idle_timeout=a.idle_timeout or None, device=device)
    print("ams live server on %s:%d (max_clients=%d)"
          % (server.address[0], server.address[1], a.max_clients),
          flush=True)
    server.serve_in_background()

    # daemon: run until SIGTERM/SIGINT, then drain sessions gracefully
    stop = threading.Event()
    for sig in (signal.SIGTERM, signal.SIGINT):
        signal.signal(sig, lambda *_: stop.set())
    # poll-wait: an indefinite Event.wait() can sit in one C-level lock
    # acquire where the Python-level signal handler never runs.  Also
    # supervise the accept loop: if it dies, exit loudly instead of
    # lingering as a process that refuses every connection
    rc = 0
    while not stop.is_set():
        stop.wait(timeout=1.0)
        if not stop.is_set() and not server.is_serving():
            print("accept loop died: %r; shutting down"
                  % (server.error,), file=sys.stderr, flush=True)
            rc = 1
            break
    print("shutting down...", flush=True)
    server.close(grace=60.0)
    print("served %d rounds across %d sessions"
          % (server.rounds_served, server.sessions_served), flush=True)
    return rc


if __name__ == "__main__":
    sys.exit(main())
