"""Tracking CLI, in PyTorch: flag- and file-protocol-compatible with the JAX
package's ``apps/predict.py`` (reference predict.py:627-665), plus
``--device`` (default ``cuda``; ``cpu`` runs the kernels' plain versions).

Modes:
  --mode ycbv       track one YCB-Video sequence (reference
                    predictSequenceYcb, predict.py:446-575)
  --mode ycbineoat  track one YCBInEOAT video (reference
                    predictSequenceYcbInEOAT, predict.py:578-624);
                    normalizers overridden to trans 0.03 m / rot 30 deg
                    (reference predict.py:586)
  --mode ycbv_all   all test sequences containing --class_id (reference
                    getResultsYcb, predict.py:299-443)

Execution paths:
  --track_mode scan     ``Tracker.track_video_chunked``: chunks of
                        --chunk_size frames decoded on a background thread,
                        uploaded once each, the pose carried on the device;
                        --reinit_frames segments the video at the re-init
                        points.
  --track_mode stream   the live path, ``tracking/stream.StreamTracker``:
                        windowed packed uint8 uploads (``--no_window``: full
                        frames), the pose kept on the device, chunks of 16
                        frames decoded on a background thread while the
                        previous chunk pushes; ``--auto_reinit`` (ycbv) lets
                        the depth-agreement health policy decide when to
                        re-initialize from the PoseCNN results.
  --track_mode ontrack  per-frame ``Tracker.on_track`` with the pose fetched
                        every frame (the reference's frame loop, reference
                        predict.py:529-564); ``--samples N`` > 1 runs the
                        multi-hypothesis step (stream, adaptive modes too).
  --track_mode adaptive scan's segments through one
                        ``tracking/dispatch.AdaptiveVideoTracker``: chunks of
                        --chunk_size frames, the candidates --chunk_size, 8
                        and 1 frames a dispatch (those dividing the chunk)
                        and the stream, probed on the video and the fastest
                        kept; scan's poses, and the telemetry printed.

``--bf16`` runs the CNN in bfloat16 (float32 parameters;
``models/tracknet.py``). Frame chunks (scan, stream, adaptive) decode with
the native libpng loader (``native/dataload.py``) where it builds, else with
Pillow; the first decode prints which.

Outputs per-frame 4x4 pose txts in the layouts the scoring CLIs read;
optional mp4 + projected-point overlays + render|crop canvases (reference
predict.py:403,424-433,284-291). PyYAML, Pillow and cv2 are imported where
a file is read or written, never when the module is imported.
"""
from __future__ import annotations

import argparse
import concurrent.futures as cf
import functools
import glob
import os

import numpy as np

def _load_rgb(path):
    from PIL import Image

    return np.array(Image.open(path))[..., :3]


def _load_depth(path):
    """Depth PNG in its own dtype (uint16 mm): it crosses to the device as
    uint16 (``tracker.upload_depth``)."""
    from PIL import Image

    return np.array(Image.open(path))


@functools.cache
def _png_decoder():
    """The native libpng batch decoder, or None for Pillow; built and
    announced once per process."""
    from ..native.dataload import NativeLoader

    try:
        loader = NativeLoader()
    except (OSError, RuntimeError) as e:
        lines = str(e).splitlines() or [repr(e)]
        why = next((x for x in lines if "error" in x), lines[0])
        print(f"predict: PNG frames decode with Pillow (the native loader "
              f"does not build: {why.strip()})", flush=True)
        return None
    print("predict: PNG frames decode with the native libpng loader "
          "(native/dataload.cc)", flush=True)
    return loader


def _batch_src(files, kind):
    """callable(a, b) -> the frames files[a:b], stacked: one native batch
    decode on its thread pool where the loader builds, else (or where the
    native decode fails) Pillow, frame by frame."""
    load = _load_rgb if kind == "rgb" else _load_depth

    def batch(a, b):
        nl = _png_decoder()
        if nl is not None:
            try:
                out = nl.read_png_batch(
                    files[a:b], np.uint8 if kind == "rgb" else np.uint16)
                return out[..., :3] if kind == "rgb" else out
            except (OSError, ValueError):
                pass
        return np.stack([load(f) for f in files[a:b]])

    return batch


def _make_tracker(dataset_info, mean, std, args, trans_normalizer=0.03,
                  rot_normalizer=5 * np.pi / 180):
    import torch

    from ..tracking.tracker import Tracker

    return Tracker(dataset_info, mean, std, ckpt_dir=args.ckpt_dir,
                   model_path=args.model_path,
                   trans_normalizer=trans_normalizer,
                   rot_normalizer=rot_normalizer,
                   dtype=torch.bfloat16 if args.bf16 else torch.float32,
                   device=args.device)


def _track_files(tracker, rgb_files, depth_files, init_pose, args, start=0,
                 reinit=None, redetect=None):
    """Track a file sequence; returns (N, 4, 4) poses including the init.

    scan: chunked tracking, segmented at re-init frames (each segment
    restarts the device-carried pose from the PoseCNN result, reference
    predict.py:539-541); adaptive: the same segments through one
    ``AdaptiveVideoTracker``. stream: the live ``StreamTracker``, re-initialized
    at those frames, and with ``--auto_reinit`` wherever its health policy
    fires (``redetect(file_index)`` gives the pose). ontrack: the
    reference's blocking frame loop.
    """
    n = len(rgb_files)
    reinit = {i: p for i, p in (reinit or {}).items()
              if p is not None and start + 1 <= i < n}
    init_pose = np.asarray(init_pose, np.float64)

    if args.track_mode in ("scan", "adaptive"):
        chunk, dispatcher = args.chunk_size, None
        if args.track_mode == "adaptive":
            # The dispatch granularity is chosen on this video as it runs
            # (tracking/dispatch.py); one dispatcher keeps its warm state
            # and probe table across re-init segments.
            from ..tracking.dispatch import AdaptiveVideoTracker

            chunk = args.chunk_size or 100
            cands = tuple(dict.fromkeys(
                c for c in (chunk, 8, 1) if chunk % c == 0)) + (0,)
            dispatcher = AdaptiveVideoTracker(tracker, candidates=cands,
                                              samples=args.samples)
        bounds = sorted(set([start + 1] + list(reinit)))
        poses = [init_pose]
        cur = init_pose
        for k, a in enumerate(bounds):
            b = bounds[k + 1] if k + 1 < len(bounds) else n
            if a in reinit:
                cur = np.asarray(reinit[a])
                print("Reinitialized at", a)
            if a >= b:
                continue
            rgb_src = _batch_src(rgb_files[a:b], "rgb")
            depth_src = _batch_src(depth_files[a:b], "depth")
            if dispatcher is not None:
                seg, _ = dispatcher.track(cur, rgb_src, depth_src,
                                          chunk_size=chunk, n_frames=b - a)
            else:
                seg = tracker.track_video_chunked(
                    cur, rgb_src, depth_src, chunk_size=min(chunk, b - a),
                    n_frames=b - a)
            poses.extend(list(seg))
            cur = seg[-1]
        if dispatcher is not None:
            print(f"adaptive dispatch: {dispatcher.telemetry()}")
        return np.stack(poses)

    if args.track_mode == "stream":
        return _track_stream(tracker, rgb_files, depth_files, init_pose,
                             args, start, reinit, redetect)

    poses = [init_pose]
    prev = init_pose.copy()
    for i in range(start + 1, n):
        if i % 100 == 0:
            print(">>>>", i, flush=True)
        if i in reinit:
            prev = reinit[i]
            print("Reinitialized at", i)
        prev = tracker.on_track(prev, _load_rgb(rgb_files[i]),
                                _load_depth(depth_files[i]),
                                samples=args.samples)
        poses.append(prev.copy())
    return np.stack(poses)


def _track_stream(tracker, rgb_files, depth_files, init_pose, args, start,
                  reinit, redetect):
    """``_track_files`` in stream mode: frames pushed one by one, chunks of
    16 decoded on a background thread while the previous chunk pushes, the
    poses fetched once at the end."""
    from ..tracking.stream import StreamTracker

    n = len(rgb_files)
    samples = args.samples
    policy = on_lost = None
    if args.auto_reinit and redetect is not None:
        # The reference re-initializes at fixed frames (--reinit_frames,
        # predict.py:539-541); here the health policy decides when, and
        # the PoseCNN results give the pose.
        from ..tracking.hypotheses import ReinitPolicy

        if samples < 2:
            print("auto_reinit: raising --samples to 2 "
                  "(health score needs the multi-hypothesis step)")
            samples = 2
        policy = ReinitPolicy(patience=2)
        a0_box = start + 1

        def on_lost(idx, score):
            file_idx = a0_box + idx
            try:
                p = redetect(file_idx)
            except Exception as e:  # a failed re-detection: keep tracking
                print(f"auto_reinit: no re-detection near frame "
                      f"{file_idx} ({e})")
                return None
            print(f"auto_reinit fired at frame {file_idx} "
                  f"(health {score:.3f})")
            return p

    s = StreamTracker(tracker, window=not args.no_window, samples=samples,
                      reinit_policy=policy, on_track_lost=on_lost)
    s.begin(init_pose)
    chunk = 16
    get_rgb = _batch_src(rgb_files, "rgb")
    get_depth = _batch_src(depth_files, "depth")

    def load(a, b):
        return get_rgb(a, b), get_depth(a, b).astype(np.uint16)

    a0 = start + 1
    try:
        with cf.ThreadPoolExecutor(1) as ex:
            fut = ex.submit(load, a0, min(a0 + chunk, n))
            for a in range(a0, n, chunk):
                b = min(a + chunk, n)
                rgb_c, dep_c = fut.result()
                if b < n:
                    fut = ex.submit(load, b, min(b + chunk, n))
                for j in range(b - a):
                    i = a + j
                    if i % 100 == 0:
                        print(">>>>", i, flush=True)
                    if i in reinit:
                        s.set_pose(reinit[i])
                        print("Reinitialized at", i)
                    s.push(rgb_c[j], dep_c[j])
        poses = s.poses()
    finally:
        s.close()
    return np.concatenate([init_pose[None], poses], axis=0)


def _write_visuals(tracker, rgb_files, depth_files, poses, args, start=0,
                   name_offset=0):
    """Post-tracking visual outputs (one pass over the frames):

      --viz_dir     per-frame projected-point overlay PNGs
                    (reference predict.py:549-559)
      --save_video  <outdir>/video.mp4 of the overlays
                    (reference predict.py:403,441-443)
      --canvas_dir  render|crop side-by-side ROI canvases at the estimate
                    (reference predict.py:284-291 makeCanvas/imshow),
                    through ``tracker.roi_views`` on the tracker's device
    """
    if not (args.viz_dir or args.save_video or args.canvas_dir):
        return
    import cv2
    import torch

    from ..tracking.tracker import roi_views, upload_depth, upload_rgb
    from ..utils.viz import VideoWriter, draw_projected_points, make_canvas

    cloud = getattr(tracker, "object_cloud", tracker.trimesh.verts)
    K = tracker.K.cpu().numpy()
    writer = None
    if args.save_video:
        os.makedirs(args.outdir, exist_ok=True)
        writer = VideoWriter(os.path.join(args.outdir, "video.mp4"))
    for d in (args.viz_dir, args.canvas_dir):
        if d:
            os.makedirs(d, exist_ok=True)

    for i in range(start + 1, len(rgb_files)):
        pose = poses[i - start]
        # frame index of file names and labels: callers that prepend a
        # sentinel "_init" entry (ycbineoat) pass name_offset=1 so the PNGs
        # line up with the 0-based pose txts they save per real frame
        idx = i - name_offset
        rgb = _load_rgb(rgb_files[i])
        if args.viz_dir or args.save_video:
            bgr = draw_projected_points(rgb, pose, K, cloud)
            cv2.putText(bgr, f"frame:{idx}", (bgr.shape[1] // 2,
                                              bgr.shape[0] - 50),
                        cv2.FONT_HERSHEY_SIMPLEX, 1, (255, 0, 0), 4)
            if args.viz_dir:
                cv2.imwrite(os.path.join(args.viz_dir, f"{idx:07d}.png"), bgr)
            if writer is not None:
                writer.write(bgr)
        if args.canvas_dir:
            rgbA, _, rgbB, _ = roi_views(
                tracker.cfg, tracker.mesh, tracker.K,
                torch.as_tensor(np.asarray(pose), dtype=torch.float32).to(
                    tracker.device),
                upload_rgb(rgb, tracker.device),
                upload_depth(_load_depth(depth_files[i]), tracker.device))
            canvas = make_canvas([rgbA.cpu().numpy(), rgbB.cpu().numpy()])
            cv2.imwrite(os.path.join(args.canvas_dir, f"{idx:07d}.png"),
                        canvas)
    if writer is not None:
        writer.close()


def predict_sequence_ycb(args, dataset_info, mean, std):
    """One YCB-Video sequence (reference predict.py:446-575 layout:
    color/ depth_filled/ pose_gt/<class_id>/). Returns the ADD-S AUC."""
    from ..eval.metrics import batch_errors, vocap

    seq_dir = os.path.join(args.ycb_dir, f"{args.seq_id:04d}")
    rgb_files = sorted(glob.glob(os.path.join(seq_dir, "color", "*")))
    depth_files = sorted(glob.glob(os.path.join(seq_dir, "depth_filled", "*")))
    gt_files = sorted(
        glob.glob(os.path.join(seq_dir, "pose_gt", str(args.class_id), "*")))
    gt_poses = [np.loadtxt(f) for f in gt_files]
    assert rgb_files and depth_files and gt_poses, seq_dir

    tracker = _make_tracker(dataset_info, mean, std, args)
    if args.init == "posecnn":
        init_pose = _posecnn_pose(args, args.seq_id, 1)
    elif args.init == "poserbpf":
        init_pose = _poserbpf_pose(args, args.class_id, args.seq_id)
    else:
        init_pose = gt_poses[0].copy()

    reinit = None
    if args.reinit_frames:
        reinit = {}
        for sf in args.reinit_frames.split(","):
            seq, frame = sf.split("/")
            reinit[int(frame) - 1] = _posecnn_pose(args, int(seq), int(frame))

    pred_poses = _track_files(
        tracker, rgb_files, depth_files, init_pose, args, reinit=reinit,
        redetect=lambda i: _posecnn_pose(args, args.seq_id, i + 1))
    _write_visuals(tracker, rgb_files, depth_files, pred_poses, args)

    os.makedirs(args.outdir, exist_ok=True)
    for i, p in enumerate(pred_poses):
        np.savetxt(os.path.join(args.outdir, f"{i:05d}.txt"), p)
        np.savetxt(os.path.join(args.outdir, f"{i:05d}gt.txt"), gt_poses[i])
    cloud = getattr(tracker, "object_cloud", tracker.trimesh.verts)
    _, errs = batch_errors(pred_poses, np.stack(gt_poses[:len(pred_poses)]),
                           cloud, device=args.device)
    auc = vocap(errs) * 100
    print(f"reinit_frames {args.reinit_frames}, adi_auc {auc}")
    return auc


def predict_sequence_ycbineoat(args, dataset_info, mean, std):
    """One YCBInEOAT video (reference predict.py:578-624 layout:
    rgb/ depth_filled/ annotated_poses/)."""
    root = args.YCBInEOAT_dir
    rgb_files = sorted(glob.glob(os.path.join(root, "rgb", "*.png")))
    depth_files = sorted(glob.glob(os.path.join(root, "depth_filled", "*.png")))
    gt_files = sorted(glob.glob(os.path.join(root, "annotated_poses", "*.txt")))
    assert rgb_files and depth_files and gt_files, root
    gt_poses = [np.loadtxt(f) for f in gt_files]

    tracker = _make_tracker(dataset_info, mean, std, args,
                            trans_normalizer=0.03,
                            rot_normalizer=30 * np.pi / 180)
    init_pose = gt_poses[0].copy()
    # The reference tracks from frame 0 re-estimating frame i from i-1 and
    # saves a pose per frame (predict.py:603-611): frame 0's saved pose is
    # the update of the init on frame 0 itself.
    all_poses = _track_files(tracker, ["_init"] + rgb_files,
                             ["_init"] + depth_files, init_pose, args)
    pred = all_poses[1:]
    _write_visuals(tracker, ["_init"] + rgb_files, ["_init"] + depth_files,
                   all_poses, args, name_offset=1)
    os.makedirs(args.outdir, exist_ok=True)
    for i, p in enumerate(pred):
        np.savetxt(os.path.join(args.outdir, f"{i:07d}.txt"), p)
    return pred


def get_results_ycb(args, dataset_info, mean, std):
    """All test sequences (0048-0059) containing the class (reference
    getResultsYcb, predict.py:299-443)."""
    results = {}
    for seq_id in range(48, 60):
        seq_dir = os.path.join(args.ycb_dir, f"{seq_id:04d}")
        gt_dir = os.path.join(seq_dir, "pose_gt", str(args.class_id))
        if not os.path.isdir(gt_dir):
            continue
        sub_args = argparse.Namespace(**vars(args))
        sub_args.seq_id = seq_id
        sub_args.outdir = os.path.join(args.outdir, f"seq{seq_id:04d}")
        results[seq_id] = predict_sequence_ycb(sub_args, dataset_info, mean,
                                               std)
    print("per-seq ADI AUC:", results)
    return results


def _quat_pose(qw, qx, qy, qz, t):
    """4x4 pose from a (w, x, y, z) unit quaternion and a translation."""
    R = np.array([
        [1 - 2 * (qy * qy + qz * qz), 2 * (qx * qy - qz * qw),
         2 * (qx * qz + qy * qw)],
        [2 * (qx * qy + qz * qw), 1 - 2 * (qx * qx + qz * qz),
         2 * (qy * qz - qx * qw)],
        [2 * (qx * qz - qy * qw), 2 * (qy * qz + qx * qw),
         1 - 2 * (qx * qx + qy * qy)],
    ])
    pose = np.eye(4)
    pose[:3, :3] = R
    pose[:3, 3] = t
    return pose


def _poserbpf_pose(args, class_id, seq_id):
    """Initial pose from PoseRBPF result files (reference
    predict.py:499-515): <ycb_dir>/YCB_Video_toolbox/PoseRBPF_Results/
    YCB_results_RGBD/<class_folder>/seq_<n>/Pose*.txt with one line
    '<i> <j> x y z qw qx qy qz'."""
    from ..ops.pointcloud import find_class_contained_videos_ycb

    seqs = sorted(find_class_contained_videos_ycb(args.ycb_dir, class_id))
    res_dir = os.path.join(args.ycb_dir, "YCB_Video_toolbox",
                           "PoseRBPF_Results", "YCB_results_RGBD")
    folders = sorted(os.listdir(res_dir))
    cur = os.path.join(res_dir, folders[class_id - 1],
                       f"seq_{seqs.index(seq_id) + 1}")
    pose_file = glob.glob(os.path.join(cur, "Pose*.txt"))[0]
    with open(pose_file) as f:
        vals = f.readline().split()[2:]
    x, y, z, qw, qx, qy, qz = map(float, vals[:7])
    return _quat_pose(qw, qx, qy, qz, [x, y, z])


_KEYFRAME_INDEX: dict = {}


def _keyframe_index(ycb_dir):
    """keyframe.txt parsed once per ycb_dir: '<seq>/<frame>' -> line index
    (the PoseCNN .mat result files are numbered by keyframe line)."""
    idx = _KEYFRAME_INDEX.get(ycb_dir)
    if idx is None:
        with open(os.path.join(ycb_dir, "image_sets", "keyframe.txt")) as f:
            idx = {line.strip(): i for i, line in enumerate(f)}
        _KEYFRAME_INDEX[ycb_dir] = idx
    return idx


def _posecnn_pose(args, seq_id, frame_id):
    """PoseCNN re-init pose from the YCB_Video_toolbox results, taken at
    the nearest keyframe to ``frame_id`` (reference use_posecnn_res,
    predict.py:89-123)."""
    import scipy.io

    seq_frames = _keyframe_index(args.ycb_dir)
    for neighbor in range(len(seq_frames) + frame_id + 1):
        for cand_frame in (frame_id + neighbor, frame_id - neighbor):
            index = seq_frames.get(f"{seq_id:04d}/{cand_frame:06d}")
            if index is not None:
                mat = scipy.io.loadmat(os.path.join(
                    args.ycb_dir, "YCB_Video_toolbox",
                    "results_PoseCNN_RSS2018", f"{index:06d}.mat"))
                rows = np.where(mat["rois"][:, 1] == args.class_id)[0]
                vec = mat["poses_icp"][rows].reshape(-1)
                return _quat_pose(*vec[:4], vec[4:])
    raise RuntimeError(f"no keyframe near {seq_id:04d}/{frame_id:06d}")


def build_parser():
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--mode", default="ycbv",
                        help="ycbv / ycbineoat / ycbv_all")
    parser.add_argument("--seq_id", default=None, type=int)
    parser.add_argument("--ycb_dir", type=str, default=None,
                        help="YCB_Video data_organized root")
    parser.add_argument("--YCBInEOAT_dir", type=str, default=None)
    parser.add_argument("--train_data_path", type=str, default=None,
                        help="dataset_info.yml found at <path>/../")
    parser.add_argument("--class_id", default=-1, type=int)
    parser.add_argument("--model_path", type=str, help="path to mesh")
    parser.add_argument("--ckpt_dir", type=str,
                        help="checkpoint: reference .pth.tar, the port's .pt "
                             "or a Flax .msgpack")
    parser.add_argument("--mean_std_path", type=str)
    parser.add_argument("--outdir", type=str, required=True)
    parser.add_argument("--reinit_frames", type=str, default=None)
    parser.add_argument("--init", default="gt",
                        choices=["gt", "posecnn", "poserbpf"],
                        help="initial-pose source (reference predict.py:477-515)")
    parser.add_argument("--track_mode", default="scan",
                        choices=["scan", "stream", "ontrack", "adaptive"],
                        help="scan: chunked tracking; stream: the live "
                             "pipelined StreamTracker; ontrack: per-frame; "
                             "adaptive: the dispatch granularity chosen at "
                             "run time (tracking/dispatch.py)")
    parser.add_argument("--chunk_size", default=64, type=int,
                        help="frames per device chunk in scan and adaptive "
                             "modes (bounds device memory for long videos)")
    parser.add_argument("--no_window", action="store_true",
                        help="stream mode: upload full frames instead of "
                             "the object window")
    parser.add_argument("--samples", default=1, type=int,
                        help="pose hypotheses per frame (stream, ontrack, "
                             "adaptive modes): N "
                             "perturbed priors refine in one batched step; "
                             "the depth-agreement winner is kept (the "
                             "reference scaffolds this arg but evaluates "
                             "only hypothesis 0, reference "
                             "predict.py:229-231)")
    parser.add_argument("--auto_reinit", action="store_true",
                        help="stream mode, ycbv only: let the depth-"
                             "agreement health policy decide when to "
                             "re-init and take the pose from the PoseCNN "
                             "results (the reference's --reinit_frames "
                             "picks the frames by hand); implies "
                             "--samples >= 2")
    parser.add_argument("--viz_dir", type=str, default=None,
                        help="save projected-point overlays here")
    parser.add_argument("--save_video", action="store_true",
                        help="write <outdir>/video.mp4 of the overlays "
                             "(reference predict.py:403)")
    parser.add_argument("--canvas_dir", type=str, default=None,
                        help="save render|crop ROI canvases here "
                             "(reference predict.py:284-291)")
    parser.add_argument("--bf16", action="store_true",
                        help="run the CNN in bfloat16 (float32 weights)")
    parser.add_argument("--device", default="cuda",
                        help="torch device of the tracker and the scorer "
                             "(cuda, or cpu for the kernels' plain versions)")
    return parser


def main(argv=None):
    import yaml

    args = build_parser().parse_args(argv)
    with open(os.path.join(args.train_data_path, "..",
                           "dataset_info.yml")) as f:
        dataset_info = yaml.safe_load(f)
    mean = np.load(os.path.join(args.mean_std_path, "mean.npy"))
    std = np.load(os.path.join(args.mean_std_path, "std.npy"))

    if args.mode == "ycbv":
        return predict_sequence_ycb(args, dataset_info, mean, std)
    if args.mode == "ycbineoat":
        return predict_sequence_ycbineoat(args, dataset_info, mean, std)
    return get_results_ycb(args, dataset_info, mean, std)


if __name__ == "__main__":
    main()
