"""K2, the EKF pose update (``csrc/ekf_update.cu``): the state in and out,
the measured pose and its 6 x 6 covariance in; Cholesky, gain and the
dense Joseph products."""
SYMBOL = "ekf_update_kernel"

STATE_BYTES = (3 + 3 + 4 + 3 + 3 + 3 + 18 * 18 + 1) * 4 + 1


def n_bytes() -> int:
    return 2 * STATE_BYTES + 16 * 4 + 36 * 4


def flops() -> int:
    return 4 * 18 ** 3 + 8 * 18 * 18 * 6
