"""The ``circle`` scene: a platform driving an ``radius_m`` circle at
``speed_mps`` from rest (``ramp_s``) through ``boxes`` boxes in a world of
``world_extent_m`` (the world of ``world_seed``), its start on the circle
and the range noise drawn from the recording's seed."""
from __future__ import annotations

from benchmark import scene


def recording(ctx, seed: int, geo: dict) -> scene.Recording:
    sen = ctx.sensor_spec
    return scene.circle_recording(
        seed, ctx.sensor, n_scans=ctx.traffic["recording_scans"],
        scan_dt=1.0 / sen["scan_hz"], imu_dt=1.0 / sen["imu_hz"],
        radius=geo["radius_m"], speed=geo["speed_mps"], ramp=geo["ramp_s"],
        extent=geo["world_extent_m"], n_boxes=geo["boxes"],
        world_seed=geo["world_seed"], max_range=sen["max_range_m"],
        noise_std=sen["range_noise_m"], device=ctx.device)
