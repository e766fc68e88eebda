#!/usr/bin/env python
"""AMS edge client CLI: stream a clip to a live server, apply deltas,
infer every frame locally.

Flag-compatible with ``ams_tpu/cli/edge.py``, plus ``--device`` and
``--gpu``.  The deployment counterpart of the emulated client: the same
send_period sampling, but the samples go over a real socket and the
model updates arrive as delta payloads.  The local model is the frozen,
unfolded float32 student; its inference ends in the fused resize+argmax
kernel on the card.

``--input_video`` names a frame directory (``ams_tpu_torch/data/video.py``;
``tools/torch_frames_from_video.py`` makes one from an mp4).  The cv2 calls
of the JAX CLI are ``data/image.py``'s: the compressed uplink's 2x resize
is ``resize_linear_u8`` (cv2's ``INTER_LINEAR``) and the gt labels are
read by ``png_read`` and resized by ``resize_nearest``.  Two faults of the
JAX CLI are not copied: ``--gt_dir`` scoring gives pixels of classes the
experiment does not select weight 0 (the JAX CLI counts them as reduced
class 0), and the final-10 s window starts no earlier than the first
delta (the JAX CLI's window starts before the stream on runs of 10 s or
less).

Example (on the card; ``--device cpu`` runs on the host):
    python -m ams_tpu_torch.cli.edge --server 127.0.0.1:9097 \
        --input_video data/25-frankfurt --gt_dir data/gt/ --output_dir out/
"""

import argparse
import os
import time

import numpy as np


def build_parser():
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--server", required=True, help="host:port")
    p.add_argument("--input_video", required=True)
    p.add_argument("--height", type=int, default=256)
    p.add_argument("--send_period", type=int, default=30)
    p.add_argument("--train_period", type=int, default=10)
    p.add_argument("--iter", type=int, default=200)
    p.add_argument("--batch_size", type=int, default=10)
    p.add_argument("--lr", type=float, default=1e-3)
    p.add_argument("--train_strategy", default="coord_desc_auto")
    p.add_argument("--coord_fraction", type=float, default=0.1)
    p.add_argument("--compress_uplink", action="store_true")
    p.add_argument("--uplink_bw", type=float, default=1000.0,
                   help="kbps; H.264 target = uplink_bw * send_period")
    p.add_argument("--sample_fraction", type=float, default=None,
                   help="fraction of a period's frames to sample "
                        "(default: send_period/fps seconds' worth = 1/fps)")
    p.add_argument("--wire_dtype", choices=["float16", "int8", "int8d"],
                   default="float16",
                   help="delta value encoding: float16 = reference wire "
                        "format; int8 = per-var-quantized (~2x smaller)")
    p.add_argument("--student_checkpoint", default="synthetic")
    p.add_argument("--client_id", default="",
                   help="stable session id (letters/digits/._-); with a "
                        "server --resume_dir, a reconnect after a server "
                        "restart resumes this session where it left off")
    p.add_argument("--max_seconds", type=int, default=0,
                   help="stop after N stream seconds (0 = whole clip)")
    p.add_argument("--output_dir", default="",
                   help="write the emulation's bandwidth artifact set "
                        "(_bw_uplink/_bw_downlink/_model_update_times/"
                        "_fps_client .npy + _update.txt) for this live run")
    p.add_argument("--gt_dir", default="",
                   help="directory of per-frame gt_%%06d.png labels: score "
                        "the local model's predictions against them and "
                        "report mIoU over time")
    p.add_argument("--score_stride", type=int, default=5,
                   help="with --gt_dir, score every Nth frame (local "
                        "inference is the edge's budget)")
    p.add_argument("--run_label", default="live")
    p.add_argument("--gpu", default="0",
                   help="CUDA device index (--device cuda)")
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                   help="Where the local model runs (default: the GPU)")
    return p


def frame_miou(gt: np.ndarray, pred: np.ndarray,
               class_weights: np.ndarray) -> float:
    """mIoU of one frame's reduced-id predictions against its full-id gt
    labels, with the emulation's weighting (``distill.loss.
    reduce_labels``): pixels labelled 255 or with a class the experiment
    does not select have weight 0."""
    from ams_tpu_torch.utils.metrics import calculate_miou

    cw = np.asarray(class_weights).reshape(-1)
    n_total = len(cw)
    valid = gt < n_total
    valid[valid] = cw[gt[valid]] == 1
    take = np.cumsum(cw) * cw
    reduced = np.where(take != 0, take - 1, take).astype(np.int64)
    n = int(cw.sum())
    cm = np.zeros((n, n), np.int64)
    np.add.at(cm, (reduced[gt[valid]], pred[valid]), 1)
    return float(np.nanmean(calculate_miou(cm, nan=True)))


def final_window_start(first_delta_t: float, second: int) -> float:
    """First stream second of the final-10 s scoring window: the last 10
    seconds, but none before the first delta arrived."""
    return max(first_delta_t, second - 10)


def main(argv=None):
    a = build_parser().parse_args(argv)

    from ams_tpu_torch import configs as exp_configs
    from ams_tpu_torch.data.buffers import choose_frames
    from ams_tpu_torch.data.image import bgr_to_rgb, resize_linear_u8
    from ams_tpu_torch.data.video import (
        PrefetchingVideoReader,
        frame_to_rgb,
        load_gt_label,
    )
    from ams_tpu_torch.runtime.live import LiveClient
    from ams_tpu_torch.utils.platform import resolve_device

    device = resolve_device("cpu" if a.device == "cpu"
                            else "cuda:%d" % int(a.gpu))
    host, port = a.server.rsplit(":", 1)
    exp_num = exp_configs.video_exp_num(a.input_video)
    extra = {"client_id": a.client_id} if a.client_id else {}
    client = LiveClient(
        (host, int(port)), exp_num=exp_num, height=a.height,
        strategy=a.train_strategy, wire_dtype=a.wire_dtype, iters=a.iter,
        batch_size=a.batch_size, train_period=a.train_period, lr=a.lr,
        coord_frac=a.coord_fraction, checkpoint=a.student_checkpoint,
        device=device, **extra)
    print("connected; initial model deployed", flush=True)

    reader = PrefetchingVideoReader(a.input_video)
    fps = int(reader.fps)
    size = (a.height, 2 * a.height)
    sample_fraction = a.sample_fraction
    if sample_fraction is None:
        sample_fraction = 1.0 / fps  # one frame/s of content, run.py:144
    bucket = []
    t0 = time.time()
    frames_done = 0
    second = 0
    # mirror of the server's training schedule (live.py _handle): a round
    # fires when a sample batch arrives at t with t - last_train >= period
    expected_rounds = 0
    last_train_t = -1e9
    if client.resume_t is not None:
        # the server restored this client_id's session: fast-forward the
        # stream to where it left off so the training clock stays
        # monotonic
        second = int(client.resume_t)
        last_train_t = second
        frames_done = second * fps
        reader.seek_frame(frames_done)
        print("resumed session at t=%ds" % second, flush=True)
    start_frames = frames_done  # fast-forwarded frames are not streamed
    # per-period bandwidth accounting, emulation-artifact compatible:
    # _fps_client.npy = samples per send period, _bw_downlink.npy = one
    # exact bit count per delta
    up_bw_per_period = []
    down_bw_per_update = []
    model_update_times = [0.0]
    sample_per_period = []
    wall_fps_per_second = []
    deltas_logged = 0
    last_uplink_bits = 0
    samples_sent = 0
    sec_t0 = time.time()
    score_records: list = []  # (frame_idx, miou) vs --gt_dir labels

    def score_vs_gt(pred, idx):
        if not os.path.isfile(os.path.join(a.gt_dir, "gt_%06d.png" % idx)):
            return
        gt = load_gt_label(os.path.join(a.gt_dir, ""), idx, pred.shape)
        score_records.append(
            (idx, frame_miou(gt, pred, client.network.class_weights_graph)))

    def log_new_deltas(stamp):
        nonlocal deltas_logged
        new = client.delta_bits[deltas_logged:]
        down_bw_per_update.extend(new)
        model_update_times.extend([float(stamp)] * len(new))
        deltas_logged = len(client.delta_bits)
        return len(new)
    try:
        while True:
            frame = reader.read()
            if frame is None:
                break
            rgb = frame_to_rgb(frame, size)
            pred = client.predict(rgb)  # local inference, current model
            if a.gt_dir and frames_done % a.score_stride == 0:
                score_vs_gt(pred, frames_done)
            frames_done += 1
            # keep the raw decoded frame too: the compressed uplink encodes
            # 2x-resolution resizes of the ORIGINAL frames, not the
            # inference-size rgb
            bucket.append((rgb, frame if a.compress_uplink else None))
            if frames_done % fps == 0:
                second += 1
                if second % a.send_period == 0:
                    samples, samples_raw = choose_frames(bucket,
                                                         sample_fraction)
                    bucket = []
                    if samples:
                        try:
                            if a.compress_uplink:
                                two_x = np.stack([
                                    bgr_to_rgb(resize_linear_u8(
                                        f, (2 * size[0], 2 * size[1])))
                                    for f in samples_raw])
                                # fps=10 + bitrate uplink_bw*send_period:
                                # the emulation's encoder settings
                                client.send_samples_compressed(
                                    two_x, float(second),
                                    bitrate_kbps=a.uplink_bw * a.send_period,
                                    fps=10)
                            else:
                                client.send_samples(np.stack(samples),
                                                    float(second))
                        except (BrokenPipeError, ConnectionResetError):
                            # faulted/closed session: the reason (if any)
                            # arrives as an error 'Q' on the next poll
                            client.poll_deltas()
                            print("uplink closed by the server%s" %
                                  (": %s" % client.server_error
                                   if client.server_error else ""),
                                  flush=True)
                            break
                        if second - last_train_t >= a.train_period:
                            expected_rounds += 1
                            last_train_t = second
                    # an empty draw still ticks the period artifacts (the
                    # emulation appends 0s too)
                    up_bw_per_period.append(
                        client.uplink_bits - last_uplink_bits)
                    last_uplink_bits = client.uplink_bits
                    samples_sent += len(samples)
                    sample_per_period.append(len(samples))
                n = client.poll_deltas()
                if n:
                    log_new_deltas(second)
                    print("t=%ds: applied %d delta(s), downlink %.1f Kb "
                          "total" % (second, n,
                                     client.downlink_bits / 1024),
                          flush=True)
                if client.closed:
                    # session ended server-side: report why (fault) or
                    # that the link dropped, keep the artifacts
                    print("server closed the session%s" %
                          (": %s" % client.server_error
                           if client.server_error else ""), flush=True)
                    break
                wall_fps_per_second.append(
                    fps / max(time.time() - sec_t0, 1e-9))
                sec_t0 = time.time()
                # bound check after the period block: breaking before it
                # would drop the final complete period's uplink and round
                if a.max_seconds and second >= a.max_seconds:
                    break
    finally:
        reader.release()
        # apply any deltas still in flight (the server may be mid-round)
        n = client.drain(grace=150.0, expect=expected_rounds)
        log_new_deltas(second)  # drained deltas count in the artifacts too
        if n:
            print("end of stream: applied %d late delta(s)" % n, flush=True)
        client.close()
    wall = time.time() - t0
    n_streamed = frames_done - start_frames
    print("streamed %d frames (%.1f fps wall), %d deltas applied, "
          "uplink %.1f Kb, downlink %.1f Kb"
          % (n_streamed, n_streamed / max(wall, 1e-9),
             client.deltas_applied, client.uplink_bits / 1024,
             client.downlink_bits / 1024), flush=True)
    if score_records:
        sr = np.asarray(score_records, np.float64)
        first_delta_t = (model_update_times[1]
                         if len(model_update_times) > 1 else float("inf"))
        pre = sr[sr[:, 0] < first_delta_t * fps, 1]
        tail = sr[sr[:, 0] >= final_window_start(first_delta_t, second)
                  * fps, 1]
        print("gt mIoU: pre-first-delta mean %.4f (%d frames), "
              "final-10s mean %.4f (%d frames)"
              % (pre.mean() if len(pre) else float("nan"), len(pre),
                 tail.mean() if len(tail) else float("nan"), len(tail)),
              flush=True)
    if a.output_dir:
        os.makedirs(a.output_dir, exist_ok=True)
        base = os.path.join(a.output_dir, "%d_%s_results"
                            % (exp_num, a.run_label))
        np.save(base + "_bw_uplink.npy", np.asarray(up_bw_per_period))
        np.save(base + "_bw_downlink.npy", np.asarray(down_bw_per_update))
        np.save(base + "_model_update_times.npy",
                np.asarray(model_update_times))
        np.save(base + "_fps_client.npy", np.asarray(sample_per_period))
        np.save(base + "_wall_fps.npy", np.asarray(wall_fps_per_second))
        if score_records:
            np.save(base + "_miou_live.npy",
                    np.asarray(score_records, np.float64))
        with open(base + "_update.txt", "w") as f:
            # the emulation's 5-line format (total down bits, total up
            # bits, updates, seconds, samples) over THIS process's
            # streamed window: a resumed session's counters start at the
            # resume point
            start_second = int(client.resume_t or 0)
            f.write("%d\n%d\n%d\n%d\n%d" % (client.downlink_bits,
                                            client.uplink_bits,
                                            client.deltas_applied,
                                            second - start_second,
                                            samples_sent))
        print("artifacts: %s_{bw_uplink,bw_downlink,model_update_times,"
              "fps_client,wall_fps}.npy + _update.txt" % base, flush=True)


if __name__ == "__main__":
    main()
