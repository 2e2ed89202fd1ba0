"""NMPC collision avoidance.

Behavioral port of the reference's motion controller
(`src/motion_controller/motion_controller/helpers/nmpc_collision_avoidance.py`,
itself adapted upstream from atb033/multi_agent_path_planning): same receding
-horizon formulation and constants — horizon 4 x 0.3s, velocity bounds
vmax/sqrt(2) per axis, sigmoid collision costs with Q_static=8 / Q_dynamic=12
scaled by the robot radius, constant-velocity obstacle prediction with
latency compensation, static line-segment obstacles — re-expressed with
vectorized numpy costs (single einsum over the horizon instead of per-step
Python loops) under scipy SLSQP.

This is a downstream consumer proving SLAM output quality (the reference's
collision-avoidance demo: 0 collisions, min distance >= 0.55 m,
`docs/index.html`).

A copy of `dvm_slam_tpu/control/nmpc.py` (numpy and scipy only): the port imports nothing of
the JAX package.
"""

from __future__ import annotations

import numpy as np
from scipy.optimize import Bounds, minimize


class NmpcController:
    def __init__(self, robot_radius: float, vmax: float, timestep: float = 0.1,
                 nmpc_timestep: float = 0.3, horizon: int = 4,
                 latency: float = 0.1, seed: int = 0):
        self.timestep = timestep
        self.nmpc_timestep = nmpc_timestep
        self.horizon = horizon
        self.vmax = vmax
        self.robot_radius = robot_radius
        self.latency = latency
        self.rng = np.random.RandomState(seed)

        self.Q_static = 8.0
        self.Q_dynamic = 12.0

        def scale(Q):
            x_min = np.log((np.sqrt(Q * Q - 4 * Q) + Q) / 2 - 1)
            return robot_radius / x_min

        self.scale_static = scale(self.Q_static)
        self.scale_dynamic = scale(self.Q_dynamic)

        self.goal = np.zeros(2)
        self.static_obstacles = np.zeros((0, 4))  # (x1,y1,x2,y2) segments
        self._prev_obs = None
        self._prev_obs_time = None

        bound = vmax / np.sqrt(2.0)
        self._bounds = Bounds([-bound] * (2 * horizon), [bound] * (2 * horizon))
        # cumulative-integration matrix: positions = 1*x0 + L (u * dt)
        self._L = np.kron(np.tril(np.ones((horizon, horizon))), np.eye(2))

    # -- configuration ------------------------------------------------------

    def set_goal(self, goal):
        self.goal = np.asarray(goal, float)

    def set_static_obstacles(self, segments):
        self.static_obstacles = np.asarray(segments, float).reshape(-1, 4)

    # -- rollout helpers ----------------------------------------------------

    def rollout(self, x0, u, dt):
        """[H,2] positions after applying controls u [2H] from x0 [2]."""
        return x0[None, :] + (self._L @ (np.asarray(u) * dt)).reshape(-1, 2)

    def _reference(self, x0):
        d = self.goal - x0
        n = np.linalg.norm(d)
        reach = self.vmax * self.nmpc_timestep * self.horizon
        tgt = self.goal if n < reach else x0 + d / n * reach
        return np.linspace(x0, tgt, self.horizon + 1)[1:]

    def _segment_distances(self, pts):
        """[H] min distance of each point to all static segments (inf if none)."""
        if len(self.static_obstacles) == 0:
            return np.full(pts.shape[0], np.inf)
        a = self.static_obstacles[:, :2][None]           # [1,S,2]
        b = self.static_obstacles[:, 2:][None]
        p = pts[:, None, :]                               # [H,1,2]
        v = b - a
        t = np.clip(np.sum((p - a) * v, -1) / np.maximum(np.sum(v * v, -1), 1e-12), 0, 1)
        closest = a + t[..., None] * v
        return np.linalg.norm(p - closest, axis=-1).min(axis=1)

    def _predict_obstacles(self, obs_now, now: float):
        """Constant-velocity prediction + latency compensation: [O,H,2]."""
        obs_now = np.asarray(obs_now, float).reshape(-1, 2)
        if self._prev_obs is not None and len(self._prev_obs) == len(obs_now):
            dt = max(now - self._prev_obs_time, 1e-6)
            vel = (obs_now - self._prev_obs) / dt
        else:
            vel = np.zeros_like(obs_now)
        self._prev_obs = obs_now.copy()
        self._prev_obs_time = now
        start = obs_now + vel * self.latency
        steps = np.arange(1, self.horizon + 1)[None, :, None] * self.nmpc_timestep
        return start[:, None, :] + vel[:, None, :] * steps

    # -- cost ---------------------------------------------------------------

    def _cost(self, u, x0, obs_pred, xref):
        pts = self.rollout(x0, u, self.nmpc_timestep)      # [H,2]
        track = np.linalg.norm(pts - xref)
        coll = 0.0
        if obs_pred.size:
            d = np.linalg.norm(pts[None] - obs_pred, axis=-1)  # [O,H]
            coll += np.sum(self.scale_dynamic * self.Q_dynamic
                           / (1.0 + np.exp(d / self.scale_dynamic)))
        ds = self._segment_distances(pts)
        finite = np.isfinite(ds)
        if finite.any():
            coll += np.sum(self.scale_static * self.Q_static
                           / (1.0 + np.exp(ds[finite] / self.scale_static)))
        return track + coll

    # -- control ------------------------------------------------------------

    def step(self, position, obstacle_positions, now: float = 0.0):
        """One receding-horizon step. Returns (vx, vy)."""
        x0 = np.asarray(position, float)
        obs_pred = self._predict_obstacles(obstacle_positions, now)
        xref = self._reference(x0)
        u0 = (2 * self.rng.rand(2 * self.horizon) - 1) * self.vmax
        res = minimize(self._cost, u0, args=(x0, obs_pred, xref),
                       method="SLSQP", bounds=self._bounds)
        return float(res.x[0]), float(res.x[1])
