"""ROS live-tracking node, in PyTorch (reference predict_ros.py:19-119).

Counterpart of ``iros20_6d_pose_tracking_tpu/apps/predict_ros.py``.
Subscribes to RGB and depth topics, repairs depth holes with
``ops/depthproc.fill_depth`` on the tracker's device (reference
predict_ros.py:38-41), tracks every spin and broadcasts the object pose as a
TF transform. The spin loop keeps running when a step fails (reference
predict_ros.py:114-119).

rospy, tf and cv_bridge are imported by :func:`main` only: where ROS is
absent it exits with a message, and :class:`TrackerRosCore`, the
message-free logic, is importable and tested everywhere.
"""
from __future__ import annotations

import argparse
import os

import numpy as np


class TrackerRosCore:
    """ROS-independent core: the latest frames and the per-spin update.

    ``use_stream=True`` (default) runs the live ``StreamTracker`` path
    (windowed uint8 uploads, the pose on the device; tracking/stream.py).
    ``use_stream=False`` keeps the reference-shaped blocking
    ``Tracker.on_track`` call (reference predict_ros.py:48-66).
    """

    def __init__(self, tracker, fill_depth_holes: bool = True,
                 use_stream: bool = True, samples: int = 1,
                 on_track_lost=None):
        self.tracker = tracker
        self.fill_depth_holes = fill_depth_holes
        self.color = None
        self.depth = None
        self.prev_pose = None
        self.stream = None
        if use_stream:
            from ..tracking.stream import StreamTracker

            # samples >= 2 turns on per-frame health scores and the closed
            # failure loop: the ReinitPolicy watches the score on the
            # stream's fetch thread, and on_track_lost(frame_idx, score)
            # (an external detector, say) may return a 4x4 pose that the
            # next update applies; the live analog of the reference's
            # manual --reinit_frames (predict.py:539-541).
            policy = None
            if on_track_lost is not None and samples < 2:
                # the score comes from the multi-hypothesis step: with one
                # sample the callback would never fire
                print("[predict_ros] on_track_lost requires samples >= 2 "
                      "(health comes from the multi-hypothesis step); "
                      "raising samples 1 -> 2", flush=True)
                samples = 2
            if samples > 1:
                from ..tracking.hypotheses import ReinitPolicy

                policy = ReinitPolicy(patience=2)  # snapshots, not frames
            # keep_history=False: a robot runs for an unbounded time.
            self.stream = StreamTracker(tracker, keep_history=False,
                                        samples=samples,
                                        reinit_policy=policy,
                                        on_track_lost=on_track_lost)

    def grab_color(self, rgb: np.ndarray):
        self.color = np.asarray(rgb)

    def grab_depth(self, depth_m: np.ndarray):
        """Depth in metres; holes filled on the tracker's device when
        ``fill_depth_holes`` (reference predict_ros.py:38-41)."""
        if self.fill_depth_holes:
            import torch

            from ..ops import depthproc

            dev = torch.as_tensor(np.asarray(depth_m, np.float32)).to(
                self.tracker.device)
            depth_m = depthproc.fill_depth(dev).cpu().numpy()
        self.depth = depth_m

    def set_init_pose(self, pose: np.ndarray):
        self.prev_pose = np.asarray(pose, np.float64)
        if self.stream is not None:
            self.stream.begin(self.prev_pose)

    def on_track(self):
        """One update; returns the new 4x4 pose, or None until a colour
        frame, a depth frame and the initial pose have arrived (reference
        predict_ros.py:48-66)."""
        if self.color is None or self.depth is None or self.prev_pose is None:
            return None
        if self.stream is not None:
            rgb_u8 = self.color if self.color.dtype == np.uint8 \
                else np.clip(self.color, 0, 255).astype(np.uint8)
            # ROS depth topics publish NaN/inf for no-return pixels, and a
            # float -> uint16 cast of an out-of-range value is undefined:
            # map them to 0 mm ("no reading") and clamp before the cast.
            depth_mm = np.nan_to_num(self.depth * 1000.0, nan=0.0,
                                     posinf=0.0, neginf=0.0)
            self.stream.push(rgb_u8,
                             np.clip(depth_mm, 0.0, 65535.0)
                             .astype(np.uint16))
            pose = self.stream.current_pose().astype(np.float64)
        else:
            pose = self.tracker.on_track(
                self.prev_pose, self.color,
                np.nan_to_num((self.depth * 1000.0).astype(np.float32),
                              nan=0.0, posinf=0.0, neginf=0.0),
                gt_A_in_cam=np.eye(4), gt_B_in_cam=np.eye(4),
            )
        self.prev_pose = pose
        return pose

    def close(self):
        """Stop the stream's background fetch thread."""
        if self.stream is not None:
            self.stream.close()


def _checkpoint(artifacts_dir: str) -> str:
    """The best-validation checkpoint of a training output: the port
    trainer's ``.pt``, else the JAX trainer's ``.msgpack``."""
    for name in ("model_best_val.pt", "model_best_val.msgpack"):
        path = os.path.join(artifacts_dir, name)
        if os.path.exists(path):
            return path
    raise FileNotFoundError(f"no model_best_val.pt or .msgpack in "
                            f"{artifacts_dir}")


def main(argv=None):
    try:
        import rospy
        import tf
        from cv_bridge import CvBridge
        from sensor_msgs.msg import Image as RosImage
    except ImportError as e:
        raise SystemExit(
            "predict_ros requires a ROS environment (rospy/tf/cv_bridge); "
            f"missing: {e.name}. The tracking core is importable as "
            "iros20_6d_pose_tracking_tpu_torch.apps.predict_ros."
            "TrackerRosCore.")

    import yaml

    from ..tracking.tracker import Tracker

    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--rgb_topic", default="/camera/color/image_raw")
    parser.add_argument("--depth_topic",
                        default="/camera/aligned_depth_to_color/image_raw")
    parser.add_argument("--artifacts_dir", required=True,
                        help="dir with the checkpoint, dataset_info.yml, "
                             "mean.npy, std.npy (train output layout)")
    parser.add_argument("--model_path", required=True)
    parser.add_argument("--init_pose_file", required=True,
                        help="txt 4x4 initial object pose in camera frame")
    parser.add_argument("--rate_hz", type=float, default=60.0)
    parser.add_argument("--device", default="cuda",
                        help="torch device of the tracker")
    args = parser.parse_args(argv)

    with open(os.path.join(args.artifacts_dir, "dataset_info.yml")) as f:
        dataset_info = yaml.safe_load(f)
    mean = np.load(os.path.join(args.artifacts_dir, "mean.npy"))
    std = np.load(os.path.join(args.artifacts_dir, "std.npy"))
    tracker = Tracker(dataset_info, mean, std,
                      ckpt_dir=_checkpoint(args.artifacts_dir),
                      model_path=args.model_path,
                      trans_normalizer=dataset_info["max_translation"],
                      rot_normalizer=dataset_info["max_rotation"] * np.pi / 180,
                      device=args.device)
    core = TrackerRosCore(tracker)
    core.set_init_pose(np.loadtxt(args.init_pose_file))

    bridge = CvBridge()
    rospy.init_node("se3_tracknet_torch")
    broadcaster = tf.TransformBroadcaster()

    rospy.Subscriber(
        args.rgb_topic, RosImage,
        lambda msg: core.grab_color(bridge.imgmsg_to_cv2(msg, "rgb8")),
        queue_size=1,
    )
    rospy.Subscriber(
        args.depth_topic, RosImage,
        lambda msg: core.grab_depth(
            bridge.imgmsg_to_cv2(msg, "passthrough").astype(np.float32)
            / 1000.0),
        queue_size=1,
    )

    rate = rospy.Rate(args.rate_hz)
    try:
        while not rospy.is_shutdown():
            try:
                pose = core.on_track()
                if pose is not None:
                    R = pose[:3, :3]
                    # rotation matrix -> quaternion (wxyz)
                    qw = np.sqrt(max(0.0, 1 + R[0, 0] + R[1, 1] + R[2, 2])) / 2
                    qx = (R[2, 1] - R[1, 2]) / max(4 * qw, 1e-9)
                    qy = (R[0, 2] - R[2, 0]) / max(4 * qw, 1e-9)
                    qz = (R[1, 0] - R[0, 1]) / max(4 * qw, 1e-9)
                    broadcaster.sendTransform(
                        pose[:3, 3], (qx, qy, qz, qw), rospy.Time.now(),
                        "tracked_object", "camera",
                    )
            except Exception as e:  # keep spinning (reference :114-119)
                rospy.logwarn(f"track step failed: {e}")
            rate.sleep()
    finally:
        core.close()


if __name__ == "__main__":
    main()
