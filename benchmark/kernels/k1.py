"""K1, the EKF predict over one scan's block of ``k`` IMU samples
(``csrc/ekf_predict.cu``): the state and its 18 x 18 covariance in and
out, the samples (acceleration, rate, time) and their valid flags in, the
deskew twist out; the block-sparse covariance steps run for every slot."""
SYMBOL = "ekf_predict_kernel"

STATE_BYTES = (3 + 3 + 4 + 3 + 3 + 3 + 18 * 18 + 1) * 4 + 1
# nonzeros of F by row: position 2, velocity 7, attitude 4, biases 1
F_ROW_TERMS = [2] * 3 + [7] * 3 + [4] * 3 + [1] * 9


def n_bytes(k: int) -> int:
    return 2 * STATE_BYTES + k * 7 * 4 + k + 6 * 4


def flops(k: int) -> int:
    t_rows = 2 * 18 * sum(F_ROW_TERMS[:9])
    return k * (t_rows + 2 * 18 * sum(F_ROW_TERMS))
