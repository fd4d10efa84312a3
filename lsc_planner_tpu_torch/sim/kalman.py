"""Linear Kalman filter for obstacle tracking (the port's own copy of
lsc_planner_tpu/sim/kalman.py).

Reference: ``include/kalman_filter.hpp`` -- a 6-state (position, velocity)
constant-velocity filter per obstacle, plus the uncertainty radius used to
inflate obstacle sizes.  Batched over the obstacle axis.
"""
from __future__ import annotations

import dataclasses
import numpy as np


@dataclasses.dataclass
class LinearKalmanFilter:
    """Batched constant-velocity KF over O obstacles.

    State x = [p (3); v (3)]; observation = position.
    sigma_y_sq: observation noise; sigma_v_sq: initial velocity variance;
    sigma_a_sq: acceleration (process) noise (kalman_filter.hpp:38-80).
    """
    n_obstacles: int
    sigma_y_sq: float = 0.0036
    sigma_v_sq: float = 0.01
    sigma_a_sq: float = 1.0

    def __post_init__(self):
        O = self.n_obstacles
        self.x = np.zeros((O, 6))
        self.P = np.zeros((O, 6, 6))
        init = np.diag([self.sigma_y_sq] * 3 + [self.sigma_v_sq] * 3)
        self.P[:] = init
        self.initialized = np.zeros(O, bool)
        self.t_last = np.zeros(O)

    def _matrices(self, dt: float):
        F = np.eye(6)
        F[:3, 3:] = np.eye(3) * dt
        # process noise from white acceleration
        G = np.zeros((6, 3))
        G[:3] = np.eye(3) * 0.5 * dt * dt
        G[3:] = np.eye(3) * dt
        Q = self.sigma_a_sq * (G @ G.T)
        H = np.zeros((3, 6))
        H[:, :3] = np.eye(3)
        R = np.eye(3) * self.sigma_y_sq
        return F, Q, H, R

    def filter(self, obs_pos: np.ndarray, t: float):
        """One predict+update step with position observations (O, 3).
        Returns (pos_filtered (O, 3), vel_filtered (O, 3))."""
        O = self.n_obstacles
        for oi in range(O):
            if not self.initialized[oi]:
                self.x[oi, :3] = obs_pos[oi]
                self.x[oi, 3:] = 0.0
                self.initialized[oi] = True
                self.t_last[oi] = t
                continue
            dt = max(t - self.t_last[oi], 1e-6)
            F, Q, H, R = self._matrices(dt)
            x_pred = F @ self.x[oi]
            P_pred = F @ self.P[oi] @ F.T + Q
            y = obs_pos[oi] - H @ x_pred
            S = H @ P_pred @ H.T + R
            K = P_pred @ H.T @ np.linalg.inv(S)
            self.x[oi] = x_pred + K @ y
            self.P[oi] = (np.eye(6) - K @ H) @ P_pred
            self.t_last[oi] = t
        return self.x[:, :3].copy(), self.x[:, 3:].copy()

    def uncertainty_radius(self, horizon: float) -> np.ndarray:
        """Position uncertainty radius after `horizon` seconds: sqrt of the
        max eigenvalue of the predicted position covariance
        (kalman_filter.hpp:86-95)."""
        F, Q, _, _ = self._matrices(horizon)
        radii = np.zeros(self.n_obstacles)
        for oi in range(self.n_obstacles):
            P_pred = F @ self.P[oi] @ F.T + Q
            eig = np.linalg.eigvalsh(P_pred[:3, :3])
            radii[oi] = float(np.sqrt(max(eig.max(), 0.0)))
        return radii
