"""Flyby camera state machine (``ptudes_tpu.viz.fly``; a compute-only
re-design of reference ``src/ptudes/fly.py``).

The reference drives an OpenGL PointViz camera through the states
BUILDING -> TO_THE_BEGINNING -> COURSING -> TO_THE_APEX (``fly.py:19-24``)
from a 30 Hz animation thread. Here the same state machine is a pure
function of time producing ``CameraState`` (target pose, pitch, yaw,
dolly) — renderer-agnostic: feed it to matplotlib/Open3D/exported video
tooling, or unit-test it headlessly (which the reference cannot).
"""
from __future__ import annotations

import enum
from dataclasses import dataclass, field

import numpy as np

from ..utils.trajectory import TrajectoryEvaluator, prune_trajectory


class Phase(enum.Enum):
    BUILDING = 1
    TO_THE_BEGINNING = 2
    COURSING = 3
    TO_THE_APEX = 4


@dataclass
class CameraState:
    target: np.ndarray             # [4, 4] pose the camera looks at
    pitch: float = -70.0
    yaw: float = 140.0
    dolly: float = -100.0


def estimate_apex_dolly(min_max: np.ndarray, fov_deg: float = 90.0) -> float:
    """Dolly that fits the bbox (reference ``estimate_apex_dolly``,
    ``src/ptudes/utils.py:107-111``)."""
    d = np.linalg.norm(min_max[:, 1] - min_max[:, 0])
    big = 1.4142 * d / np.sin(np.deg2rad(fov_deg))
    return max(-100.0, 100.0 * np.log(max(0.001, big) / 50.0))


def lerp(a: float, b: float, t: float) -> float:
    t = min(max(t, 0.0), 1.0)
    return a + (b - a) * t


@dataclass
class Flyby:
    """Time-driven camera program over a finished trajectory + map bbox.

    Unlike the reference (which builds the map live while BUILDING), the
    pipeline registers the whole sequence first; BUILDING then replays
    scan poses at ``build_rate`` scans/sec for the same visual effect.
    """
    traj: list                      # [(ts, pose4x4), ...]
    bbox: np.ndarray                # [3, 2] min/max of the map
    build_rate: float = 30.0        # scans per second during BUILDING
    course_velocity: float = 5.0    # m/s along the trajectory
    transition_dur: float = 3.0
    min_course_dur: float = 5.0     # reference min-duration clamp (fly.py:196-233)
    fov_deg: float = 90.0
    _pruned: list = field(default_factory=list)

    def __post_init__(self):
        self._pruned = prune_trajectory(self.traj)
        self._ev = TrajectoryEvaluator(self._pruned, time_bounds=0.5) \
            if len(self._pruned) >= 2 else None
        self._t_build = len(self.traj) / self.build_rate
        # coursing duration from path length at velocity, clamped to min
        p = np.asarray([x[1][:3, 3] for x in self._pruned])
        path_len = float(np.sum(np.linalg.norm(np.diff(p, axis=0), axis=1))) \
            if len(p) >= 2 else 0.0
        self._t_course = max(self.min_course_dur,
                             path_len / self.course_velocity)
        self._apex_dolly = estimate_apex_dolly(self.bbox, self.fov_deg)

    @property
    def total_duration(self) -> float:
        return (self._t_build + self.transition_dur + self._t_course
                + self.transition_dur)

    def phase_at(self, t: float) -> Phase:
        if t < self._t_build:
            return Phase.BUILDING
        t -= self._t_build
        if t < self.transition_dur:
            return Phase.TO_THE_BEGINNING
        t -= self.transition_dur
        if t < self._t_course:
            return Phase.COURSING
        return Phase.TO_THE_APEX

    def _traj_pose(self, frac: float) -> np.ndarray:
        if self._ev is None:
            return self.traj[0][1]
        t0, t1 = self._ev._ts[0], self._ev._ts[-1]
        return self._ev.pose_at(t0 + frac * (t1 - t0))

    def camera_at(self, t: float) -> CameraState:
        """Camera parameters at flyby time t (loops after total_duration)."""
        t = t % max(self.total_duration, 1e-6)
        phase = self.phase_at(t)
        center = np.eye(4)
        center[:3, 3] = self.bbox.mean(axis=1)

        if phase == Phase.BUILDING:
            idx = min(int(t * self.build_rate), len(self.traj) - 1)
            # smooth dolly out as the map grows (reference fly.py:75-111)
            frac = idx / max(len(self.traj) - 1, 1)
            return CameraState(
                target=self.traj[idx][1],
                pitch=-70.0, yaw=140.0,
                dolly=lerp(-60.0, self._apex_dolly, frac))
        if phase == Phase.TO_THE_BEGINNING:
            u = (t - self._t_build) / self.transition_dur
            start = self._traj_pose(0.0)
            tgt = np.eye(4)
            tgt[:3, 3] = lerp(0, 1, u) * start[:3, 3] \
                + (1 - lerp(0, 1, u)) * self.traj[-1][1][:3, 3]
            tgt[:3, :3] = start[:3, :3]
            return CameraState(
                target=tgt,
                pitch=lerp(-70.0, -30.0, u), yaw=140.0,
                dolly=lerp(self._apex_dolly, -40.0, u))
        if phase == Phase.COURSING:
            u = (t - self._t_build - self.transition_dur) / self._t_course
            return CameraState(
                target=self._traj_pose(u),
                pitch=-30.0, yaw=140.0, dolly=-40.0)
        u = (t - self._t_build - self.transition_dur - self._t_course) \
            / self.transition_dur
        end = self._traj_pose(1.0)
        tgt = np.eye(4)
        tgt[:3, 3] = (1 - u) * end[:3, 3] + u * center[:3, 3]
        return CameraState(
            target=tgt,
            pitch=lerp(-30.0, -70.0, u), yaw=140.0,
            dolly=lerp(-40.0, self._apex_dolly, u))
