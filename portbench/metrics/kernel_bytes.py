"""Bytes a kernel launch needs from device memory: each input read once and
each output written once, whatever the kernel reads again."""


def gemv(B, r, c, itemsize):
    """G1 `gemv_rows` (M x) and G2 `gemv_cols` (M'u) on a (B, r, c) M: the
    matrix, the vector in and the vector out."""
    return itemsize * B * (r * c + r + c)
