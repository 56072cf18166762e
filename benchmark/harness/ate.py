"""The absolute trajectory error of a run, a copy of the port's
``utils.metrics.calc_ate_rmse`` (translation part): poses aligned at the
first, the root mean square of the position errors. Reported beside a
run's numbers; not a metric of the benchmark."""
from __future__ import annotations

import numpy as np


def ate_rmse(est: np.ndarray, gt: np.ndarray) -> float:
    """Translation ATE RMSE (m) of poses ``est`` against ``gt`` [N, 4, 4]
    after aligning ``gt``'s first pose with ``est``'s."""
    est = np.asarray(est, np.float64)
    gt = np.asarray(gt, np.float64)
    gt = np.einsum("ij,njk->nik", est[0] @ np.linalg.inv(gt[0]), gt)
    err = np.linalg.norm(gt[:, :3, 3] - est[:, :3, 3], axis=-1)
    return float(np.sqrt(np.mean(np.square(err))))
